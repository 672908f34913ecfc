"""Resumable GAF output for streaming map runs (extension beyond the
reference).

The reference's checkpoint design stops at the index file (SURVEY §5:
the `.idx` decouples indexing from mapping; mapping itself restarts
from scratch).  With the streaming pipeline (models/stream.py) mapping
becomes restartable per batch: GAF records are appended, flushed and
fsync'd per batch, and a sidecar `<out>.progress.json` records,
transactionally (fsync + atomic rename), how many reads are fully
written plus the exact byte offsets of both GAF files at that point.
On `--resume`, files are truncated back to the recorded offsets (chains
may have run ahead of alignments in the pipeline) and the completed
reads are skipped.  If a GAF file is shorter than its recorded offset
(e.g. it was deleted or the filesystem lost data the progress commit
predates), the progress record is discarded and the run restarts from
scratch rather than producing NUL-padded output.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

from ..utils.timing import TRACER

PROGRESS_SUFFIX = ".progress.json"


class ResumableGafWriter:
    """Per-batch GAF appender with transactional progress.

    Commit rule: a batch counts as done only when every output that
    will ever be produced for it has been flushed — its chains, and its
    alignments when aligning.  Because the pipeline writes batch N's
    chains before batch N-1's alignments, chains offsets are queued at
    chains-write time and committed when the same batch's alignments
    land.

    chains_path=None discards chain records (used when a literal .gaf
    out path makes the alignments GAF the single final product).
    """

    def __init__(self, out_prefix: str, chains_path: Optional[str],
                 align_path: Optional[str] = None, resume: bool = False):
        self.progress_path = out_prefix + PROGRESS_SUFFIX
        self.align_path = align_path
        self.reads_done = 0
        chains_bytes = align_bytes = 0
        if resume and os.path.exists(self.progress_path):
            with open(self.progress_path) as fh:
                state = json.load(fh)
            reads_done = int(state.get("reads_done", 0))
            chains_bytes = int(state.get("chains_bytes", 0))
            align_bytes = int(state.get("align_bytes", 0))
            # refuse to resume past data that is not actually on disk
            # (truncate would NUL-pad the gap): restart from scratch
            ok = self._size_of(chains_path) >= chains_bytes and (
                align_path is None or self._size_of(align_path) >= align_bytes
            )
            if ok:
                self.reads_done = reads_done
            else:
                chains_bytes = align_bytes = 0

        self._chains_f = (
            self._open_at(chains_path, chains_bytes) if chains_path else None
        )
        self._align_f = (
            self._open_at(align_path, align_bytes) if align_path else None
        )
        self._pending: List[tuple] = []  # (n_reads, chains_offset_after)

    @staticmethod
    def _size_of(path: Optional[str]) -> int:
        try:
            return os.path.getsize(path) if path else 0
        except OSError:
            return 0

    @staticmethod
    def _open_at(path: str, offset: int):
        fh = open(path, "a+b")
        fh.truncate(offset)
        fh.seek(offset)
        return fh

    @property
    def skip_reads(self) -> int:
        return self.reads_done

    @staticmethod
    def _write_batch(fh, records) -> None:
        start = fh.tell()
        with TRACER.span("writer.write"):
            if isinstance(records, (bytes, bytearray)):
                fh.write(records)  # pre-assembled text blob (native GAF path)
            else:
                for rec in records:
                    fh.write(rec.to_string().encode())
        TRACER.count("writer.bytes", fh.tell() - start)
        with TRACER.span("writer.fsync"):
            fh.flush()
            os.fsync(fh.fileno())  # data must be durable BEFORE the commit

    def write_chains(self, n_reads: int, records: Sequence) -> None:
        if self._chains_f is not None:
            self._write_batch(self._chains_f, records)
        if self._align_f is None:
            self._commit(n_reads)
        else:
            self._pending.append((
                n_reads,
                self._chains_f.tell() if self._chains_f is not None else 0,
            ))

    def write_alignments(self, records: Sequence, n_reads: Optional[int] = None) -> None:
        """One batch's alignments: records (one a read) or a text blob of
        ``n_reads`` reads' rows."""
        assert self._align_f is not None
        self._write_batch(self._align_f, records)
        queued, chains_off = self._pending.pop(0)
        n_reads = len(records) if n_reads is None else n_reads
        assert n_reads == queued
        self._commit(n_reads, chains_off)

    def _commit(self, n_reads: int, chains_off: Optional[int] = None) -> None:
        self.reads_done += n_reads
        if chains_off is None:
            chains_off = self._chains_f.tell() if self._chains_f is not None else 0
        state = {
            "reads_done": self.reads_done,
            "chains_bytes": chains_off,
            "align_bytes": self._align_f.tell() if self._align_f else 0,
        }
        tmp = self.progress_path + ".tmp"
        with TRACER.span("writer.fsync"):
            with open(tmp, "w") as fh:
                json.dump(state, fh)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.progress_path)

    def close(self, done: bool = True) -> None:
        if self._chains_f is not None:
            self._chains_f.close()
        if self._align_f is not None:
            self._align_f.close()
        if done and os.path.exists(self.progress_path):
            os.remove(self.progress_path)
