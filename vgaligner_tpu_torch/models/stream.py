"""Software-pipelined map + --also-align over large read streams.

Counterpart of ``vgaligner_tpu/models/stream.py``: fixed-size batches in
input order, with batch N's device POA (launched by begin_alignments)
and its drain on a worker thread overlapping the host mapping of batch
N+1.  The drain is the ``.cpu()`` copy of each chunk's outputs, which
waits for the device with the GIL released.  Map-only streams pipeline
the map's own begin/finish halves the same way.  The rspoa engine aligns
inside begin_alignments and its finish only hands the result back, as
in the JAX package, so its batches pipeline the emission alone.  Records
reach the callbacks batch by batch in input order, identical to the
unbatched path.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence

from ..io.fastx import QuerySequence
from ..io.gaf import GAFAlignment
from .mapper import Chain, Mapper
from .poa_aligner import PoaAligner

DEFAULT_BATCH = 8192


class _Worker:
    """One background call at a time; its result or error surfaces on join."""

    def __init__(self):
        self.thread: Optional[threading.Thread] = None
        self.result = None
        self.error: Optional[BaseException] = None

    def start(self, fn, arg) -> None:
        def run():
            try:
                self.result = fn(arg)
            except BaseException as e:  # surfaced on join
                self.error = e

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def join(self):
        """(had_work, result); re-raises the worker's error."""
        if self.thread is None:
            return False, None
        self.thread.join()
        self.thread = None
        result, err = self.result, self.error
        self.result = self.error = None
        if err is not None:
            raise err
        return True, result


def stream_map_align(
    mapper: Mapper,
    queries: Sequence[QuerySequence],
    aligner: Optional[PoaAligner] = None,
    batch_size: int = DEFAULT_BATCH,
    align_best_n: int = 1,
    on_chains: Optional[Callable[[List[List[Chain]]], None]] = None,
    on_alignments: Optional[Callable[[List[GAFAlignment]], None]] = None,
) -> None:
    """Drive queries through the pipelined map(+align) in input order."""
    n = len(queries)
    if n == 0:
        return
    worker = _Worker()

    if aligner is None:
        for s in range(0, n, batch_size):
            state = mapper.begin_map(queries[s : s + batch_size])
            had, chains = worker.join()  # emit batch N-1 before draining N
            if had and on_chains is not None:
                on_chains(chains)
            worker.start(mapper.finish_map, state)
        had, chains = worker.join()
        if had and on_chains is not None:
            on_chains(chains)
        return

    pending = None
    for s in range(0, n, batch_size):
        chains = mapper.map_reads(queries[s : s + batch_size])
        if on_chains is not None:
            on_chains(chains)
        state = aligner.begin_alignments(chains, align_best_n)
        had, done = worker.join()
        if had and on_alignments is not None:
            on_alignments(done)
        if pending is not None:
            worker.start(aligner.finish_alignments, pending)
        pending = state
    had, done = worker.join()
    if had and on_alignments is not None:
        on_alignments(done)
    done = aligner.finish_alignments(pending)
    if on_alignments is not None:
        on_alignments(done)
