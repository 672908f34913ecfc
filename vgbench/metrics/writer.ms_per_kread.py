"""Host time in the GAF write callbacks (the chains blob, then the
writer's append, flush and fsync), ms per thousand reads of the window."""


def read(record):
    s = record["layers"].get("writer")
    return None if s is None or not record["reads"] else s * 1e6 / record["reads"]
