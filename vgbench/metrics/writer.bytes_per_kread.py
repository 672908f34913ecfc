"""GAF bytes the writer appended (chains and alignments): the counter
``writer.bytes`` per thousand reads of the window, what
``writer.fsync_ms_per_kread`` makes durable."""

from vgbench.program import per_kread


def read(record):
    return per_kread(record, "writer.bytes")
