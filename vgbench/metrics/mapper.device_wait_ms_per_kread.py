"""The mapper's wait for the card: the span ``mapper.device_wait``, an
event's synchronisation before each bucket's results are copied back
(empty on the CPU), ms per thousand reads of the window."""

from vgbench.program import ms_per_kread


def read(record):
    return ms_per_kread(record, "mapper.device_wait")
