"""Long reads (1,000 bp) through the port's map + --also-align, on the CPU.

The counterpart of tests/test_long_reads.py's first two tests, which
need the DRB1-3123 HLA-zoo graph, on a seeded synthetic graph instead:
mapping (about 990 k-mers a read), chaining, corridor extraction and the
global POA at W 1,024 (K8's rows on the card; the plain twins here).

  * exact 1 kb path windows chain end to end and align full length with
    at least 99 % matches, and each alignment's node path equals its
    source window's (path Jaccard 1);
  * a mutated read (SNPs and a 3 bp deletion): the batch route's GAF
    equals the host oracle on the Python route's range, and the JAX
    package's GAF for the same read.
"""

import re

import numpy as np
import pytest
import torch

from vgaligner_tpu.graph import graph_from_gfa as jax_graph_from_gfa
from vgaligner_tpu.index import Index as JaxIndex
from vgaligner_tpu.io.fastx import QuerySequence as JaxQuery
from vgaligner_tpu.models.mapper import Mapper as JaxMapper
from vgaligner_tpu.models.poa_aligner import PoaAligner as JaxAligner

from vgaligner_tpu_torch.experiments.gafcompare import path_jaccard, signed_ids
from vgaligner_tpu_torch.experiments.run_suite import simulate_reads
from vgaligner_tpu_torch.graph import graph_from_gfa
from vgaligner_tpu_torch.index import Index
from vgaligner_tpu_torch.io.fastx import QuerySequence
from vgaligner_tpu_torch.io.gaf import GAFAlignment
from vgaligner_tpu_torch.models.mapper import Mapper
from vgaligner_tpu_torch.models.poa_aligner import (PoaAligner, PoaEngine,
                                                   _rebase_trimmed_offsets, find_nodes_edges)
from vgaligner_tpu_torch.ops import poa_device as PD
from vgaligner_tpu_torch.ops.poa import align_global_host
from vgaligner_tpu_torch.testing import one_torch_thread, write_synthetic_gfa

CPU = torch.device("cpu")
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    gfa = str(tmp_path_factory.mktemp("long") / "graph.gfa")
    write_synthetic_gfa(gfa, seed=6, backbone_len=5000, n_haplotypes=4)
    graph = graph_from_gfa(gfa)
    return gfa, graph, Index.build(graph, 11, 100, 100)


def test_long_reads_map_and_align(world):
    _gfa, graph, index = world
    reads, truth = simulate_reads(graph, 4, 1000, seed=101)
    queries = [QuerySequence.from_name_and_string(n, s) for n, s in reads]
    chains = Mapper(index, CPU, chain_min_n_anchors=3).map_reads(queries)
    for per_read in chains:
        c = per_read[0]
        assert not c.is_placeholder
        # an exact 1 kb read chains essentially end to end
        assert int(c.aqb[-1]) + c.k - int(c.aqb[0]) > 900
    alns = PoaAligner(index, CPU, engine=PoaEngine.ABPOA).best_alignments_for_queries(chains)
    for (name, read), aln in zip(reads, alns):
        assert aln.path_matching not in (None, "*")
        cigar = aln.notes.split("cg:Z:")[1]
        n_m = sum(int(n) for n, op in re.findall(r"(\d+)([MIDX=])", cigar) if op == "M")
        assert n_m >= 0.99 * len(read)
        assert aln.alignment_block_length == len(read)
        assert path_jaccard(signed_ids(aln.path_matching), truth[name]) == 1.0


def _mutated_read(graph):
    (_name, seq), = simulate_reads(graph, 1, 1000, seed=7)[0]
    mutated = list(seq)
    rng = np.random.default_rng(3)
    for pos in rng.integers(10, 990, 8):
        mutated[int(pos)] = "ACGT"[int(rng.integers(4))]
    return "".join(mutated[:500] + mutated[503:])  # a 3 bp deletion


def test_long_read_batch_route_matches_host_oracle_and_jax(world):
    """The batch route at W 1,024 equals the host oracle on the Python
    route's range (score, cigar, path: the GAF row), ``align_global_batch``
    on that range's problem, and the JAX package's map + align."""
    gfa, graph, index = world
    read = _mutated_read(graph)
    chains = Mapper(index, CPU, chain_min_n_anchors=3).map_reads(
        [QuerySequence.from_name_and_string("mut", read)])[0]
    assert not chains[0].is_placeholder
    aligner = PoaAligner(index, CPU, engine=PoaEngine.ABPOA)
    aln_dev = aligner.best_alignments_for_queries([chains])[0]

    rng = aligner._range_for_chain(chains[0])
    nodes, edges = find_nodes_edges(index, rng)
    assert PD._l_pad_for(len(read)) + 1 == 1024
    res = align_global_host(nodes, edges, read)
    assert PD.align_global_batch([(nodes, edges, read)], CPU) == [res]
    _rebase_trimmed_offsets(res, rng)
    aln_host = GAFAlignment.from_abpoa_result(res, chains[0], rng.handles)
    assert aln_dev.to_string() == aln_host.to_string()
    assert "*" in res.cs and "-" in res.cs  # the SNPs and the deletion

    jgraph = jax_graph_from_gfa(gfa)
    jindex = JaxIndex.build(jgraph, 11, 100, 100)
    jchains = JaxMapper(jindex, chain_min_n_anchors=3).map_reads(
        [JaxQuery.from_name_and_string("mut", read)])
    assert JaxAligner(jindex).best_alignments_for_queries(jchains)[0].to_string() \
        == aln_dev.to_string()
