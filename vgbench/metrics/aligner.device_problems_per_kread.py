"""POA problems the abPOA route launched on the card: the counter
``aligner.device_problems`` per thousand reads of the window (with
``aligner.host_problems``, every chain aligned)."""

from vgbench.program import per_kread


def read(record):
    return per_kread(record, "aligner.device_problems")
