"""Port vs JAX package: the rspoa engine (local gapless POA), tolerance 0.

  * ``poa_local_plain`` against JAX ``poa_local_kernel`` on random DAG
    batches with path-derived queries: best, tlen, qend and the whole
    tape (the END fill past tlen included), over P and W; problem 0 has
    no positive cell and most problems have nv < V;
  * ``align_local_batch`` against JAX's over several (V, L) buckets and
    the host route above 8,192 vertices;
  * a vertex fan-in above 8 raises ValueError in both;
  * ``map -p rspoa --also-align`` through both CLIs, chains and
    alignments GAF byte for byte over {corridor, id, bubble closure} x
    {--both-strands off, on} x {exact, fast}, with no subgraph GFA
    written by either;
  * the port's streaming pipeline against JAX's unbatched aligner.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vgaligner_tpu import cli as jax_cli
from vgaligner_tpu.io.fastx import QuerySequence as JaxQuery
from vgaligner_tpu.models.mapper import Mapper as JaxMapper
from vgaligner_tpu.models.poa_aligner import PoaAligner as JaxAligner
from vgaligner_tpu.models.poa_aligner import PoaEngine as JaxEngine
from vgaligner_tpu.index import Index as JaxIndex
from vgaligner_tpu.ops import poa_device as JPD

from vgaligner_tpu_torch import cli
from vgaligner_tpu_torch.graph import graph_from_gfa
from vgaligner_tpu_torch.io.fastx import QuerySequence
from vgaligner_tpu_torch.models.mapper import Mapper
from vgaligner_tpu_torch.models.poa_aligner import PoaAligner, PoaEngine
from vgaligner_tpu_torch.models.stream import stream_map_align
from vgaligner_tpu_torch.ops import poa_device as PD
from vgaligner_tpu_torch.testing import (one_torch_thread, random_poa_batch, sample_reads,
                                         write_fasta, write_synthetic_gfa)

K = 11
CPU = torch.device("cpu")
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


def _local_batch(seed, B, V, P, L):
    """random_poa_batch with each query (but problem 0's) holding a
    mutated walk back along first predecessors, so the local alignments
    are long; problem 0's query is all N, so it has no positive cell."""
    vcodes, vpred, _sink, nv, q, nq = random_poa_batch(seed, B, V, P, L)
    rng = np.random.default_rng(seed)
    for b in range(1, B):
        v, walk = int(rng.integers(nv[b] // 2, nv[b])), []
        while v >= 0 and len(walk) < nq[b]:
            walk.append(int(vcodes[b, v]))
            v = int(vpred[b, v, 0])
        codes = np.asarray(walk[::-1], dtype=np.int8)
        mut = rng.random(len(codes)) < 0.05
        codes[mut] = rng.integers(0, 5, int(mut.sum()))
        off = int(rng.integers(0, nq[b] - len(codes) + 1))
        q[b, off : off + len(codes)] = codes
    q[0] = 4
    return vcodes, vpred, nv, q, nq


@pytest.mark.parametrize("P,W", [(2, 128), (4, 128), (8, 128), (2, 256), (4, 256),
                                 (8, 256), (2, 2048)])
def test_poa_local_plain_matches_jax(P, W):
    V = 256 if W == 128 else 64
    arrs = _local_batch(30 + P + W, 8, V, P, W - 1)
    want = jax.device_get(JPD.poa_local_kernel(*(jnp.asarray(a) for a in arrs)))
    got = PD.poa_local(*(torch.from_numpy(a) for a in arrs))
    for name, g, w in zip(("best", "tape", "tlen", "qend"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype),
                                      err_msg=name)
    best, _tape, tlen, _qend = (g.numpy() for g in got)
    assert best[0] == 0 and tlen[0] == 0
    assert (tlen[1:] >= 4).all()
    assert (arrs[2] < V).any()


def _random_problem(rng, n_nodes, max_label, q_len):
    nodes = ["".join("ACGT"[c] for c in rng.integers(0, 4, int(rng.integers(1, max_label + 1))))
             for _ in range(n_nodes)]
    edges = [(b - 1, b) for b in range(1, n_nodes)]
    edges += [(int(a), b) for b in range(2, n_nodes) if rng.random() < 0.3
              for a in rng.choice(b - 1, size=1)]
    seq = "".join(nodes)
    start = int(rng.integers(0, max(1, len(seq) - q_len)))
    q = "".join(c if rng.random() > 0.06 else "ACGTN"[int(rng.integers(0, 5))]
                for c in seq[start : start + q_len])
    return nodes, edges, q or "A"


def test_align_local_batch_matches_jax():
    """Buckets (256, 127), (256, 255), (512, 127) and one subgraph over
    8,192 vertices on the host route."""
    rng = np.random.default_rng(5)
    problems = [_random_problem(rng, int(rng.integers(2, 14)), 5, int(rng.integers(5, 90)))
                for _ in range(9)]
    problems += [_random_problem(rng, 40, 5, 200), _random_problem(rng, 90, 6, 100),
                 _random_problem(rng, 1100, 9, 120)]
    want = JPD.align_local_batch(problems)
    got = PD.align_local_batch(problems, CPU)
    assert len(got) == len(want) == len(problems)
    for g, w in zip(got, want):
        assert dataclasses.astuple(g) == dataclasses.astuple(w)
    assert sum(g.n_aligned > 20 for g in got) >= 6


def test_fan_in_over_8_raises_as_in_jax():
    nodes = ["A"] * 9 + ["C"]
    problems = [(nodes, [(i, 9) for i in range(9)], "AAC")]
    with pytest.raises(ValueError, match="fan-in 9 exceeds 8"):
        JPD.align_local_batch(problems)
    with pytest.raises(ValueError, match="fan-in 9 exceeds 8"):
        PD.align_local_batch(problems, CPU)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("rspoa")
    gfa = str(root / "graph.gfa")
    write_synthetic_gfa(gfa, seed=11, backbone_len=600, n_haplotypes=6)
    graph = graph_from_gfa(gfa)
    reads = sample_reads(graph, 40, 100, seed=77, sub_rate=0.03, n_rate=0.01,
                         revcomp_frac=0.25)
    reads += [reads[0][:9], "N" * 100, reads[1][:60] + "ACGTTGCA" + reads[1][60:]]
    fasta = str(root / "reads.fa")
    write_fasta(fasta, reads)
    prefix = str(root / "graph")
    cli.main(["index", "-i", gfa, "-k", str(K), "-o", prefix])
    return dict(root=root, gfa=gfa, fasta=fasta, prefix=prefix, reads=reads)


_MODES = {"corridor": ["--range-mode", "corridor"], "id": ["--range-mode", "id"],
          "bubble": ["--range-mode", "id", "--bubble-closure"]}


def _map(main, world, workdir, argv):
    os.makedirs(workdir)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        main(["map", "-i", world["prefix"], "-f", world["fasta"], "-p", "rspoa", "-D",
              "-G", world["gfa"], "-t", "1", "-o", os.path.join(workdir, "out"), *argv])
    finally:
        os.chdir(cwd)
    with open(os.path.join(workdir, "out-chains.gaf"), "rb") as fh:
        chains = fh.read()
    with open(os.path.join(workdir, "out-alignments.gaf"), "rb") as fh:
        alns = fh.read()
    return chains, alns, sorted(os.listdir(workdir))


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("both_strands", [False, True])
@pytest.mark.parametrize("mode", sorted(_MODES))
def test_cli_rspoa_matches_jax(world, tmp_path, mode, both_strands, precision):
    argv = ["--precision", precision, *_MODES[mode]]
    argv += ["--both-strands"] if both_strands else []
    want = _map(jax_cli.main, world, str(tmp_path / "jax"), argv)
    got = _map(cli.main, world, str(tmp_path / "port"), argv + ["--device", "cpu"])
    assert got == want
    chains, alns, files = got
    assert files == ["out-alignments.gaf", "out-chains.gaf"]  # no subgraphs/ from -G
    rows = alns.decode().splitlines()
    assert len(rows) == len(world["reads"])
    assert sum(r.split("\t")[5] != "*" for r in rows) >= len(rows) // 2
    if both_strands:
        assert any(r.split("\t")[4] == "-" for r in rows)


def test_stream_rspoa_matches_jax(world):
    """Batches of 16 through the port's stream equal JAX's unbatched
    rspoa alignments of the same chains."""
    names = [f"r{i}" for i in range(len(world["reads"]))]
    jidx = JaxIndex.load_from_prefix(world["prefix"])
    jm = JaxMapper(jidx, bandwidth=50, max_gap=1000, precision="exact")
    jchains = jm.map_reads([JaxQuery(name=n, seq=s) for n, s in zip(names, world["reads"])])
    want = "".join(a.to_string() for a in
                   JaxAligner(jidx, JaxEngine.RSPOA).best_alignments_for_queries(jchains))

    from vgaligner_tpu_torch.index import Index

    pidx = Index.load_from_prefix(world["prefix"])
    pm = Mapper(pidx, CPU, bandwidth=50, max_gap=1000, precision="exact")
    alns = []
    stream_map_align(pm, [QuerySequence(name=n, seq=s) for n, s in zip(names, world["reads"])],
                     PoaAligner(pidx, CPU, engine=PoaEngine.RSPOA), batch_size=16,
                     on_alignments=lambda a: alns.append("".join(x.to_string() for x in a)))
    assert len(alns) == 3
    assert "".join(alns) == want
