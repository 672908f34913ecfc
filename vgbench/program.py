"""The program's own spans and counters over a run's window, for the
per-layer readers (``metrics/<name>.py``).

The port times its steps itself (``vgaligner_tpu_torch/utils/timing.py``)
and each ``stream_map_align`` call leaves what it added in the stream
module's ``LAST_RUN``: ``{"spans": {name: seconds}, "counters": {name:
n}}``.  The readers run in the process that ran the window, right after
it, so that call is the window's.  A program without the recorder, or a
run whose window ran in other processes, gives None, and so does each
reader.
"""

from __future__ import annotations

import sys
from typing import Optional

STREAM = "vgaligner_tpu_torch.models.stream"


def window() -> Optional[dict]:
    """The spans and counters of the window just run, or None."""
    return getattr(sys.modules.get(STREAM), "LAST_RUN", None)


def ms_per_kread(record: dict, *spans: str) -> Optional[float]:
    """The spans' seconds summed, in ms per thousand reads of the window;
    None where none of them ran in this program."""
    got = window()
    if got is None or not record.get("reads"):
        return None
    found = [got["spans"][s] for s in spans if s in got["spans"]]
    return sum(found) * 1e6 / record["reads"] if found else None


def per_kread(record: dict, counter: str) -> Optional[float]:
    """The counter per thousand reads of the window; None where the
    program has no such counter."""
    got = window()
    if got is None or not record.get("reads") or counter not in got["counters"]:
        return None
    return got["counters"][counter] * 1000.0 / record["reads"]
