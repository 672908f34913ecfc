"""The -G export's second half: each chain's GFA text and its file
(``create_subgraph_gfa`` + ``export_gfa``, summed over the chains as
``aligner.export.write``), ms per thousand reads of the window."""

from vgbench.program import ms_per_kread


def read(record):
    return ms_per_kread(record, "aligner.export.write")
