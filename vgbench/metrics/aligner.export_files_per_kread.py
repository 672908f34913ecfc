"""Subgraph GFA files the abPOA route's ``-G`` export wrote, one a chain
aligned: the counter ``aligner.export_files`` per thousand reads of the
window, what ``aligner.export_write_ms_per_kread`` pays for."""

from vgbench.program import per_kread


def read(record):
    return per_kread(record, "aligner.export_files")
