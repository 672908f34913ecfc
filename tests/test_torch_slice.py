"""The slice end to end, port vs JAX package, on a small seeded graph.

Chains GAF and alignments GAF must be byte-identical to the JAX
``Mapper`` / ``PoaAligner`` on the CPU, in both precisions, with and
without --both-strands, for corridor, id and bubble-closure ranges, with
the host overflow route and --mapq, through the streaming pipeline, and
for reads over 1,023 bp through both CLIs.
"""

import os

import pytest
import torch

from vgaligner_tpu.graph import graph_from_gfa as jax_graph_from_gfa
from vgaligner_tpu.index import Index as JaxIndex
from vgaligner_tpu.io.fastx import QuerySequence as JaxQuery
from vgaligner_tpu.models.mapper import Mapper as JaxMapper
from vgaligner_tpu.models.poa_aligner import PoaAligner as JaxAligner
from vgaligner_tpu.models.poa_aligner import PoaEngine as JaxEngine

from vgaligner_tpu_torch.graph import graph_from_gfa
from vgaligner_tpu_torch.index import Index
from vgaligner_tpu_torch.io.fastx import QuerySequence
from vgaligner_tpu_torch.models.mapper import Mapper
from vgaligner_tpu_torch.models.poa_aligner import PoaAligner
from vgaligner_tpu_torch.models.stream import stream_map_align
from vgaligner_tpu_torch.testing import one_torch_thread, sample_reads, write_synthetic_gfa

K = 11
CPU = torch.device("cpu")
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    gfa = str(tmp_path_factory.mktemp("slice") / "graph.gfa")
    shape = write_synthetic_gfa(gfa, seed=11, backbone_len=600, n_haplotypes=6)
    assert shape["nodes"] <= 300
    graph = graph_from_gfa(gfa)
    reads = sample_reads(graph, 40, 100, seed=77, sub_rate=0.03, n_rate=0.01,
                         revcomp_frac=0.25)
    reads += [reads[0][:9], "N" * 100, reads[1][:60] + "ACGTTGCA" + reads[1][60:]]
    names = [f"r{i}" for i in range(len(reads))]
    return dict(
        jidx=JaxIndex.build(jax_graph_from_gfa(gfa), K, 100, 100),
        pidx=Index.build(graph, K, 100, 100),
        jq=[JaxQuery(name=n, seq=s) for n, s in zip(names, reads)],
        pq=[QuerySequence(name=n, seq=s) for n, s in zip(names, reads)],
    )


def _mappers(world, **kw):
    return (JaxMapper(world["jidx"], bandwidth=50, max_gap=1000, **kw),
            Mapper(world["pidx"], CPU, bandwidth=50, max_gap=1000, **kw))


@pytest.mark.parametrize("both_strands", [False, True])
@pytest.mark.parametrize("precision", ["fast", "exact"])
def test_chains_gaf_matches_jax(world, precision, both_strands):
    jm, pm = _mappers(world, precision=precision, both_strands=both_strands)
    want = jm.chains_gaf_text(jm.map_reads(world["jq"]))
    got = pm.chains_gaf_text(pm.map_reads(world["pq"]))
    assert got == want
    assert got.count(b"\n") >= len(world["pq"])
    if both_strands:
        assert b"\t-\t" in got


def test_overflow_route_and_mapq_match_jax(world):
    jm, pm = _mappers(world, precision="fast", max_anchors_cap=48, mapq=True)
    want = jm.chains_gaf_text(jm.map_reads(world["jq"]))
    got = pm.chains_gaf_text(pm.map_reads(world["pq"]))
    assert got == want


def _jax_alignments(world, **kw):
    """The JAX package's unbatched fast-mode GAFs (cached per range kw)."""
    key = tuple(sorted(kw.items()))
    cache = world.setdefault("jax_alns", {})
    if key not in cache:
        jm = JaxMapper(world["jidx"], bandwidth=50, max_gap=1000, precision="fast")
        chains = jm.map_reads(world["jq"])
        ja = JaxAligner(world["jidx"], JaxEngine.ABPOA, **kw)
        cache[key] = (jm.chains_gaf_text(chains), "".join(
            a.to_string() for a in ja.best_alignments_for_queries(chains)))
    return cache[key]


@pytest.mark.parametrize("mode", ["corridor", "id", "bubble"])
def test_alignments_gaf_matches_jax(world, mode):
    kw = dict(range_mode="id", bubble_closure=True) if mode == "bubble" \
        else dict(range_mode=mode)
    pm = Mapper(world["pidx"], CPU, bandwidth=50, max_gap=1000, precision="fast")
    pa = PoaAligner(world["pidx"], CPU, **kw)
    got = "".join(a.to_string() for a in
                  pa.best_alignments_for_queries(pm.map_reads(world["pq"])))
    assert got == _jax_alignments(world, **kw)[1]
    assert got.count("\tas:i:-30 cs:Z:") >= len(world["pq"]) // 2


def test_stream_matches_jax(world):
    """Batches of 16 through the pipelined stream give the unbatched GAFs."""
    pm = Mapper(world["pidx"], CPU, bandwidth=50, max_gap=1000, precision="fast")
    chains, alns = [], []
    stream_map_align(pm, world["pq"], PoaAligner(world["pidx"], CPU), batch_size=16,
                     on_chains=lambda c: chains.append(pm.chains_gaf_text(c)),
                     on_alignments=lambda a: alns.append("".join(x.to_string() for x in a)))
    assert len(chains) == len(alns) == 3
    assert (b"".join(chains), "".join(alns)) == _jax_alignments(world, range_mode="corridor")


def test_long_reads_cli_matches_jax(tmp_path):
    """Reads of 1,500-2,000 bp (POA rows of W = 2,048, past the old
    1,024-column limit of the POA kernel) and one 7.6 kb read (a subgraph
    of about 8,400 vertices, over the 8,192 cap: the native host POA)
    through both CLIs with --also-align: chains and alignments GAF
    byte-identical.  (The JAX package's CPU mapper needs about 17 GB for
    a 10 kb read and 4.6 GB at this length.)"""
    from vgaligner_tpu import cli as jax_cli
    from vgaligner_tpu_torch import cli
    from vgaligner_tpu_torch.testing import write_fasta

    gfa = str(tmp_path / "long.gfa")
    write_synthetic_gfa(gfa, seed=21, backbone_len=11000, n_haplotypes=3)
    graph = graph_from_gfa(gfa)
    reads = [sample_reads(graph, 1, n, seed=s, sub_rate=0.01)[0]
             for s, n in ((1, 1500), (2, 1700), (3, 1900), (4, 2000), (5, 7600))]
    fasta = str(tmp_path / "long.fa")
    write_fasta(fasta, reads)
    prefix = str(tmp_path / "long")
    cli.main(["index", "-i", gfa, "-k", str(K), "-o", prefix])
    out = {}
    for name, main, extra in (("jax", jax_cli.main, []), ("port", cli.main, ["--device", "cpu"])):
        work = tmp_path / name
        work.mkdir()
        cwd = os.getcwd()
        os.chdir(work)
        try:
            main(["map", "-i", prefix, "-f", fasta, "-p", "abpoa", "-D", "-G", gfa, "-t", "1",
                  "-o", str(work / "out"), *extra])
        finally:
            os.chdir(cwd)
        out[name] = [(work / f"out-{kind}.gaf").read_bytes() for kind in ("chains", "alignments")]
    assert out["port"] == out["jax"]
    rows = out["port"][1].decode().splitlines()
    assert len(rows) == len(reads)
    for row, read in zip(rows, reads):
        cols = row.split("\t")
        assert int(cols[1]) == len(read) and cols[5] != "*"
        assert int(cols[3]) - int(cols[2]) > 0.9 * len(read)
