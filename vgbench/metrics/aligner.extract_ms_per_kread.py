"""The aligner's native subgraph extraction (the span ``aligner.extract`` in
models/poa_aligner.py), ms per thousand reads of the window."""

from vgbench.program import ms_per_kread


def read(record):
    return ms_per_kread(record, "aligner.extract")
