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

With a ``mesh`` every rank walks the same batches and maps and aligns
its own contiguous slice of each (``shard_batch``), so a read's two
strands, its placeholder and its overflow route stay on one rank.  Each
batch's chains and alignments GAF rows are merged on rank 0 in read
order (``Mesh.gather_bytes``) and reach the callbacks there as a
``GafBatch``; other ranks' callbacks are never called.  The collectives
(the mapper's and the merges) all run on the calling thread; the worker
thread only drains.
"""

from __future__ import annotations

import threading
from typing import Callable, List, NamedTuple, Optional, Sequence

from ..io.fastx import QuerySequence
from ..io.gaf import GAFAlignment
from ..parallel.mesh import Mesh, shard_batch
from .mapper import Mapper
from .poa_aligner import PoaAligner

DEFAULT_BATCH = 8192


class GafBatch(NamedTuple):
    """One batch's GAF rows from every rank, merged in read order."""

    n_reads: int
    blob: bytes

    @property
    def n_rows(self) -> int:
        return self.blob.count(b"\n")

    def records(self) -> List[GAFAlignment]:
        return [GAFAlignment.from_string(line) for line in self.blob.decode().splitlines()]


def _merged(mesh: Mesh, to_blob, callback):
    """A per-rank emitter: this rank's rows of a batch as GAF text,
    gathered on rank 0, and handed to ``callback`` there."""

    def emit(per_read):
        got = mesh.gather_bytes(to_blob(per_read), len(per_read))
        if got is not None and callback is not None:
            callback(GafBatch(*got))

    return emit


def _alignments_blob(alns: List[GAFAlignment]) -> bytes:
    return "".join(a.to_string() for a in alns).encode()


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
    on_chains: Optional[Callable] = None,
    on_alignments: Optional[Callable] = None,
    mesh: Optional[Mesh] = None,
) -> None:
    """Drive queries through the pipelined map(+align) in input order.
    Without a mesh the callbacks get each batch's chains (a list per
    read) and alignments (one a read); with one, rank 0's get
    ``GafBatch``es.  Every rank passes the same queries."""
    n = len(queries)
    if n == 0:
        return
    worker = _Worker()

    def batch(s):
        part = queries[s : s + batch_size]
        return part if mesh is None else shard_batch(mesh, part)

    if mesh is not None:
        on_chains = _merged(mesh, mapper.chains_gaf_text, on_chains)
        on_alignments = _merged(mesh, _alignments_blob, on_alignments)

    if aligner is None:
        for s in range(0, n, batch_size):
            state = mapper.begin_map(batch(s))
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
        chains = mapper.map_reads(batch(s))
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
