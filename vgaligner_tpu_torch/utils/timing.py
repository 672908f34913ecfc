"""The program's spans and counters (tracing/profiling subsystem).

Reference analog: the Instant-based wall-clock phase timers around k-mer
generation/conversion (index.rs:161-172,212-224), chaining (map.rs:47,112)
and alignment substeps (align.rs:68-98).  Unlike the reference's
unconditional println! debugging, nothing here prints: ``TRACER`` keeps
seconds and calls by span name and counts by counter name, for the whole
process, and a caller reads them back with ``snapshot``/``since``.

Span names are ``<layer>.<step>`` (``mapper.launch``, ``aligner.export``,
``writer.fsync``).  While a ``torch.profiler`` run is active on the
calling thread, each span is also a ``record_function`` range, so it
sits on the profiler's clock beside the device's kernels and copies;
otherwise a span costs two ``perf_counter`` reads and a lock.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Optional

import torch
from torch.profiler import record_function


class Tracer:
    """Seconds and calls by span name, counts by counter name.

    Thread-safe: the pipelined stream (models/stream.py) drains batch N
    on a worker thread while the main thread maps batch N+1, both timing
    spans here, so every update takes the lock (the defaultdict += pairs
    are not atomic under the GIL across the read-modify-write)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.counters: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextmanager
    def span(self, name: str):
        """Time the block under ``name``; a profiler range too while a
        profiler is active on this thread."""
        annotation = record_function(name) if torch.autograd._profiler_enabled() else None
        if annotation is not None:
            annotation.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if annotation is not None:
                annotation.__exit__(None, None, None)
            self.add(name, dt)

    def add(self, name: str, seconds: float) -> None:
        """Seconds of ``name`` timed by the caller: the sum of a per-item
        loop, where a span an item would cost more than the item."""
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name`` (0 registers it)."""
        with self._lock:
            self.counters[name] += n

    def wait(self, name: str, event: Optional["torch.cuda.Event"]) -> None:
        """Block on ``event`` under the span ``name``: the time the host
        waits for the device, at the point where it would have waited
        anyway.  Without an event (the CPU) the span is empty."""
        with self.span(name):
            if event is not None:
                event.synchronize()

    def snapshot(self) -> dict:
        """``{"spans": {name: seconds}, "counters": {name: n}}`` now."""
        with self._lock:
            return {"spans": dict(self.totals), "counters": dict(self.counters)}

    def since(self, before: dict) -> dict:
        """The snapshot less ``before``: every name known now, with what
        it gained since (0 for one that did not run)."""
        now = self.snapshot()
        return {kind: {k: v - before[kind].get(k, 0) for k, v in now[kind].items()}
                for kind in now}


TRACER = Tracer()


def ready_event(device: torch.device) -> Optional["torch.cuda.Event"]:
    """A CUDA event recorded now on ``device``'s current stream, marking
    the end of the work enqueued so far (None on the CPU): ``Tracer.wait``
    blocks on it before the results are copied back."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event
