"""Experiment and validation harness: the HLA-zoo suite runner.

Counterpart of ``vgaligner_tpu/experiments`` (the reference's
experiments-snakemake pipeline, Snakefile:7-151): per graph, simulate
reads from its embedded paths (the vg-sim protocol, seed 77), run index,
map and --also-align on an explicit device, and score each read's GAF
path against its source window by path Jaccard (``gafcompare``).
"""
