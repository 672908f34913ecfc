"""The stream's calling thread waiting on its worker (the span
``stream.join`` around the worker's join in models/stream.py), ms per
thousand reads of the window."""

from vgbench.program import ms_per_kread


def read(record):
    return ms_per_kread(record, "stream.join")
