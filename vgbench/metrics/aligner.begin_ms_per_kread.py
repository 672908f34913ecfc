"""Host time in PoaAligner.begin_alignments (extraction, subgraph
export, problem arrays, launches; rspoa's whole eager route), ms per
thousand reads."""


def read(record):
    s = record["layers"].get("aligner.begin")
    return None if s is None or not record["reads"] else s * 1e6 / record["reads"]
