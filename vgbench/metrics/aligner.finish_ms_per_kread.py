"""Host time in PoaAligner.finish_alignments (the drain, tape decode,
selection), on the stream's worker thread, ms per thousand reads."""


def read(record):
    s = record["layers"].get("aligner.finish")
    return None if s is None or not record["reads"] else s * 1e6 / record["reads"]
