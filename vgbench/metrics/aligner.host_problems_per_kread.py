"""POA problems the abPOA route ran on the host (over 8,192 base
vertices, or a fan-in over P_MAX): the counter ``aligner.host_problems``
per thousand reads of the window."""

from vgbench.program import per_kread


def read(record):
    return per_kread(record, "aligner.host_problems")
