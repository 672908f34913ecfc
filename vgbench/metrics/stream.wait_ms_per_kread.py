"""The window's time on the main thread outside the spans recorded there
(mapper, aligner begin, writer): the stream waiting on its worker (and
its own bookkeeping), ms per thousand reads."""


def read(record):
    if not record["reads"]:
        return None
    busy = sum(record["main"].values())
    return max(record["window_s"] - busy, 0.0) * 1e6 / record["reads"]
