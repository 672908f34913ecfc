"""Collectives the ranks ran in the window (parallel.mesh's counter,
rank 0's), per thousand reads."""


def read(record):
    n = record.get("collectives")
    if n is None or not record["reads"]:
        return None
    return n * 1000.0 / record["reads"]
