"""The -G export's first half: each chain's paths cut to its subgraph
(``get_subgraph_paths``, summed over the chains as
``aligner.export.paths``), ms per thousand reads of the window."""

from vgbench.program import ms_per_kread


def read(record):
    return ms_per_kread(record, "aligner.export.paths")
