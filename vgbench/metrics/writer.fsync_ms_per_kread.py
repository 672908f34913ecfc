"""The GAF writer's durability: the span ``writer.fsync`` (each GAF
file's flush + fsync, and the progress file's fsync + rename a
batch), ms per thousand reads of the window."""

from vgbench.program import ms_per_kread


def read(record):
    return ms_per_kread(record, "writer.fsync")
