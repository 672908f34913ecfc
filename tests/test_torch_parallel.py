"""Multi-device map and align on CPU ranks over gloo, one process a rank.

Every multi-rank output is held byte for byte (tolerance 0) against the
single-device run of the port, and the offset-sharded chains against the
JAX package's 8-device ``shard_index=True`` mesh (conftest's virtual CPU
devices) on the same reads:

  * the library at 2 and 3 ranks (``testing.run_ranks``, once per size in
    a module fixture): the index's position-table shards, the sharded
    position gather, a rank with no read, a read over the anchor cap on a
    non-zero rank, several batches, the collectives counted, and a
    2-process ``merge_gaf_shards``;
  * the CLI: ``map --device cpu -t 2|3`` with and without
    ``--shard-index`` on both engines, and ``VGALIGNER_TRACE``;
  * ``--resume`` over ranks, stopped after a committed batch.

Every spawn and subprocess has a 240 s limit, so a hang fails one test.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vgaligner_tpu.graph import graph_from_gfa as jax_graph_from_gfa
from vgaligner_tpu.index import Index as JaxIndex
from vgaligner_tpu.io.fastx import QuerySequence as JaxQuery
from vgaligner_tpu.models.mapper import Mapper as JaxMapper
from vgaligner_tpu.parallel.mesh import make_mesh as jax_make_mesh

from vgaligner_tpu_torch import cli
from vgaligner_tpu_torch.graph import graph_from_gfa
from vgaligner_tpu_torch.index import Index
from vgaligner_tpu_torch.index.device_index import device_index
from vgaligner_tpu_torch.io.fastx import QuerySequence
from vgaligner_tpu_torch.models.mapper import Mapper
from vgaligner_tpu_torch.models.poa_aligner import PoaAligner, PoaEngine
from vgaligner_tpu_torch.parallel import Mesh, host_shard, pad_batch_to_multiple, place_index
from vgaligner_tpu_torch.parallel.check import _outputs
from vgaligner_tpu_torch.parallel.distributed import read_seqs_sharded
from vgaligner_tpu_torch.testing import (one_torch_thread, run_ranks, sample_reads, write_fasta,
                                         write_synthetic_gfa)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
LIMIT = 240
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

# 13 reads: uneven slices on 2 and 3 ranks
MAP = dict(shard_index=True, both_strands=True, mapq=True)
CAP = dict(shard_index=True, precision="fast", max_anchors_cap=70)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel")
    gfa = str(d / "g.gfa")
    write_synthetic_gfa(gfa, seed=2, backbone_len=400, n_haplotypes=4)
    graph = graph_from_gfa(gfa)
    reads = sample_reads(graph, 13, 100, seed=1, sub_rate=0.02, revcomp_frac=0.3)
    fasta = str(d / "reads.fa")
    write_fasta(fasta, reads)
    cli.main(["index", "-i", gfa, "-k", "11", "-o", str(d / "g")])
    return dict(dir=d, gfa=gfa, graph=graph, reads=reads, fasta=fasta, prefix=str(d / "g"),
                index=Index.build(graph, 11, 100, 100))


def _queries(reads):
    return [QuerySequence(name=f"read{i}", seq=s) for i, s in enumerate(reads)]


def _single(world, reads, engine=None, **kw):
    """The single-device port: (chains GAF, alignments GAF)."""
    m = Mapper(world["index"], CPU, **kw)
    chains = m.map_reads(_queries(reads))
    alns = b""
    if engine:
        a = PoaAligner(world["index"], CPU, engine=PoaEngine(engine), graph=world["graph"])
        alns = "".join(r.to_string() for r in a.best_alignments_for_queries(chains)).encode()
    return m.chains_gaf_text(chains), alns


def _gather_rows(world, size):
    n = len(world["index"].fo_positions)
    rng = np.random.default_rng(size)
    return [rng.integers(0, n, (5, 7)).astype(np.int64) for _ in range(size)]


def _cap_reads(world):
    """The reads under the cap (70 anchors), then two over it: the last
    read is on the last rank at 2 and 3 ranks."""
    from vgaligner_tpu_torch.native import count_anchors_native

    idx = world["index"]
    totals = count_anchors_native(world["reads"], idx.kmer_codes, idx.fo_counts, 11,
                                  lut=idx.host_lut())
    over = [r for r, t in zip(world["reads"], totals) if t > 70]
    assert len(over) >= 2, totals
    rest = [r for r, t in zip(world["reads"], totals) if t <= 70]
    return rest + over[:2]


@pytest.fixture(scope="module")
def ranks(world):
    """The library on 2 and 3 ranks, one spawn a size."""
    reads, out = world["reads"], {}
    for size in (2, 3):
        runs = [dict(reads=reads, mapper=MAP),
                dict(reads=_cap_reads(world), mapper=CAP)]
        if size == 2:  # several batches (rspoa; the abPOA route is the 3-rank run's)
            runs.append(dict(reads=reads, mapper=dict(precision="exact"), engine="rspoa",
                             batch_size=4))
        else:  # 2 reads on 3 ranks: rank 2 has none and joins every collective
            runs.append(dict(reads=reads[:2], mapper=dict(shard_index=True), engine="abpoa"))
        merge = str(world["dir"] / "merged.gaf") if size == 2 else None
        out[size] = run_ranks("rank_map_job", size, str(world["dir"]), world["gfa"], runs,
                              _gather_rows(world, size), merge, timeout=LIMIT)
    return out


@pytest.mark.parametrize("n,pc", [(10, 3), (7, 8), (100, 4), (0, 2)])
def test_host_shard_covers_every_index_in_order(n, pc):
    seen = []
    for pi in range(pc):
        seen.extend(range(n)[host_shard(n, pi, pc)])
    assert seen == list(range(n))


def test_read_seqs_sharded_keeps_order(world):
    parts = [read_seqs_sharded(world["fasta"], pi, 3) for pi in range(3)]
    assert [q.seq for p in parts for q in p] == world["reads"]
    assert [len(p) for p in parts] == [5, 5, 3]


@pytest.mark.parametrize("size", [2, 3])
def test_place_index_splits_the_position_table(world, size):
    """Equal contiguous ranges whose concatenation is the padded table;
    the rest of the index whole on every rank."""
    dindex = device_index(world["index"], CPU)
    n = dindex.fo_start.shape[0]
    n_pad = pad_batch_to_multiple(n, size)
    parts = [place_index(Mesh(rank=r, size=size, device=CPU), dindex, shard_positions=True)
             for r in range(size)]
    for name in ("fo_start", "fo_end"):
        whole = getattr(dindex, name)
        shards = [getattr(p, name) for p in parts]
        assert {s.shape[0] for s in shards} == {n_pad // size}
        assert torch.equal(torch.cat(shards)[:n], whole)
        assert not torch.cat(shards)[n:].any()
        assert all(s.dtype == whole.dtype for s in shards)
    assert n_pad != n or size == 2  # 3 ranks pad the power-of-two table
    rep = place_index(Mesh(rank=1, size=size, device=CPU), dindex)
    for p in parts + [rep]:
        for name in dindex._fields:
            a, b = getattr(p, name), getattr(dindex, name)
            if p is rep or name not in ("fo_start", "fo_end"):
                assert (a is None and b is None) or torch.equal(a, b), name


@pytest.mark.parametrize("size", [2, 3])
def test_spawned_ranks_hold_their_table_shards(world, ranks, size):
    dindex = device_index(world["index"], CPU)
    n = dindex.fo_start.shape[0]
    fo_start = np.concatenate([r["shard"][0] for r in ranks[size]])
    fo_end = np.concatenate([r["shard"][1] for r in ranks[size]])
    assert np.array_equal(fo_start[:n], dindex.fo_start.numpy())
    assert np.array_equal(fo_end[:n], dindex.fo_end.numpy())


@pytest.mark.parametrize("size", [2, 3])
def test_sharded_gather_equals_the_table(world, ranks, size):
    dindex = device_index(world["index"], CPU)
    for rows, r in zip(_gather_rows(world, size), ranks[size]):
        tb, te = r["gathered"]
        assert np.array_equal(tb, dindex.fo_start.numpy()[rows])
        assert np.array_equal(te, dindex.fo_end.numpy()[rows])


@pytest.mark.parametrize("size", [2, 3])
def test_sharded_chains_equal_one_device_and_the_jax_mesh(world, ranks, size):
    got = ranks[size][0]["runs"][0]
    assert got["chains"] == _single(world, world["reads"], **MAP)[0]
    jidx = JaxIndex.build(jax_graph_from_gfa(world["gfa"]), 11, 100, 100)
    jm = JaxMapper(jidx, mesh=jax_make_mesh(8), **MAP)
    jq = [JaxQuery(name=f"read{i}", seq=s) for i, s in enumerate(world["reads"])]
    assert got["chains"] == jm.chains_gaf_text(jm.map_reads(jq))
    assert b"\t-\t" in got["chains"]  # --both-strands took a reverse strand
    assert all(r["runs"][0]["chains"] == b"" for r in ranks[size][1:])


@pytest.mark.parametrize("size", [2, 3])
def test_collectives_counted(ranks, size):
    """One agreement a batch, one all-gather and one reduce-scatter a
    mapping launch, and two all-gathers a merge (lengths, then blobs)."""
    counts = [r["runs"][0]["collectives"] for r in ranks[size]]
    assert all(c == counts[0] for c in counts)
    c = counts[0]
    assert c["all_reduce"] == 1 and c["broadcast"] == 0
    assert c["reduce_scatter_tensor"] >= 1
    assert c["all_gather_into_tensor"] == c["reduce_scatter_tensor"] + 2


@pytest.mark.parametrize("size", [2, 3])
def test_overflow_read_on_a_non_zero_rank(world, ranks, size):
    reads = _cap_reads(world)
    got = ranks[size][0]["runs"][1]
    assert got["chains"] == _single(world, reads, **CAP)[0]
    last = len(reads) - 1
    assert f"read{last}" in ranks[size][-1]["runs"][1]["overflow"]
    assert not any(f"read{last}" in r["runs"][1]["overflow"] for r in ranks[size][:-1])


def test_several_batches_on_two_ranks(world, ranks):
    got = ranks[2][0]["runs"][2]
    assert (got["chains"], got["alignments"]) == _single(world, world["reads"], "rspoa",
                                                         precision="exact")
    assert ranks[2][0]["runs"][2]["collectives"]["all_reduce"] == 4  # 13 reads, batches of 4


def test_empty_rank_joins_every_collective(world, ranks):
    got = ranks[3][0]["runs"][2]
    want = _single(world, world["reads"][:2], "abpoa")
    assert (got["chains"], got["alignments"]) == want and want[1].count(b"\n") == 2
    counts = [r["runs"][2]["collectives"] for r in ranks[3]]
    assert all(c == counts[0] for c in counts) and counts[0]["reduce_scatter_tensor"] >= 1


def test_two_process_merge_equals_one_process(world, ranks):
    m = Mapper(world["index"], CPU, **MAP)
    want = [r.to_string() for r in m.chains_to_gaf(m.map_reads(_queries(world["reads"])))]
    assert ranks[2][0]["merged"] == want
    assert ranks[2][1]["merged"] is None
    with open(world["dir"] / "merged.gaf") as fh:
        assert fh.read() == "".join(want)


def _map_cli(world, cwd, argv, env=None):
    os.makedirs(cwd, exist_ok=True)
    proc = subprocess.run(
        [sys.executable, "-m", "vgaligner_tpu_torch", "map", "-i", world["prefix"], "-f",
         world["fasta"], "-G", world["gfa"], "--device", "cpu", "--both-strands", "--mapq",
         "-o", "out", *argv],
        cwd=cwd, capture_output=True, text=True, timeout=LIMIT,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO, **(env or {})))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


@pytest.fixture(scope="module")
def one_rank(world):
    """``-t 1`` runs: abPOA (with its subgraph GFAs) and rspoa + exact."""
    out = {}
    for engine, extra in (("abpoa", []), ("rspoa", ["--precision", "exact"])):
        cwd = str(world["dir"] / f"t1-{engine}")
        _map_cli(world, cwd, ["-t", "1", "-D", "-p", engine, *extra])
        out[engine] = _outputs(cwd)
    assert any(k.startswith("subgraphs/") for k in out["abpoa"])
    assert not any(k.startswith("subgraphs/") for k in out["rspoa"])
    return out


@pytest.mark.parametrize("name,argv", [
    ("t3-shard-abpoa", ["-t", "3", "--shard-index", "-D", "-p", "abpoa"]),
    ("t2-abpoa", ["-t", "2", "-D", "-p", "abpoa"]),
    ("t2-shard-rspoa", ["-t", "2", "--shard-index", "-D", "-p", "rspoa", "--precision", "exact"]),
    ("t3-map-trace", ["-t", "3", "-p", "abpoa"]),
])
def test_cli_ranks_match_one_rank(world, one_rank, name, argv):
    """Chains GAF, alignments GAF and the subgraph GFA files of a
    multi-rank run equal the one-rank run's; with VGALIGNER_TRACE rank 0
    writes a Chrome trace."""
    cwd = str(world["dir"] / name)
    trace = os.path.join(cwd, "trace")
    proc = _map_cli(world, cwd, argv, env={"VGALIGNER_TRACE": trace} if "trace" in name else None)
    n_ranks = int(argv[1])
    assert f"mapping on {n_ranks} cpu ranks" in proc.stderr
    assert f"[rank {n_ranks - 1}]" in proc.stderr
    got = _outputs(cwd)
    want = one_rank["rspoa" if "rspoa" in argv else "abpoa"]
    if "-D" not in argv:
        want = {"out-chains.gaf": want["out-chains.gaf"]}
    assert got == want
    if "trace" in name:
        assert [n for n in os.listdir(trace) if n.endswith(".pt.trace.json")]
        assert os.path.getsize(os.path.join(trace, os.listdir(trace)[0])) > 1000


def test_resume_over_ranks(world, one_rank):
    """Batches of 4 reads on 2 ranks with --shard-index, stopped just
    before the fourth batch (the first batch's alignments committed),
    then resumed: the same bytes as one rank in one go."""
    cwd = str(world["dir"] / "resume")
    os.makedirs(cwd)
    argv = ["map", "-i", world["prefix"], "-f", world["fasta"], "-G", world["gfa"], "-D",
            "-p", "abpoa", "--device", "cpu", "--both-strands", "--mapq", "-o", "out",
            "--shard-index"]
    progress = run_ranks("rank_resume_job", 2, cwd, cwd, argv, 4, 4, timeout=LIMIT)
    assert progress[0]["reads_done"] == 4 and progress[0]["align_bytes"] > 0
    assert _outputs(cwd) == one_rank["abpoa"]
    assert not os.path.exists(os.path.join(cwd, "out.progress.json"))


_INIT_RUN = r"""
import sys
sys.path.insert(0, {repo!r})
from vgaligner_tpu_torch.graph import graph_from_gfa
from vgaligner_tpu_torch.index import Index
from vgaligner_tpu_torch.models.mapper import Mapper
from vgaligner_tpu_torch.parallel.distributed import (initialize, merge_gaf_shards,
                                                      read_seqs_sharded)
rank, size = initialize(device="cpu")
assert size == 2, (rank, size)
mine = read_seqs_sharded({fasta!r})
m = Mapper(Index.build(graph_from_gfa({gfa!r}), 11, 100, 100), "cpu")
merged = merge_gaf_shards(m.chains_to_gaf(m.map_reads(mine)), {out!r})
print("RANK", rank, len(mine), None if merged is None else len(merged))
"""


def test_initialize_from_the_environment_and_merge(world, tmp_path):
    """Two processes join over tcp:// from VGALIGNER_COORDINATOR,
    VGALIGNER_NUM_PROCESSES and VGALIGNER_PROCESS_ID, each maps its
    shard of the reads, and process 0 writes the merged chains GAF."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = str(tmp_path / "merged.gaf")
    code = _INIT_RUN.format(repo=REPO, fasta=world["fasta"], gfa=world["gfa"], out=out)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1", VGALIGNER_COORDINATOR=f"127.0.0.1:{port}",
                 VGALIGNER_NUM_PROCESSES="2", VGALIGNER_PROCESS_ID=str(pid)))
        for pid in range(2)]
    try:
        outs = [p.communicate(timeout=LIMIT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), [e[-2000:] for _o, e in outs]
    assert "RANK 0 7 " in outs[0][0] and "RANK 1 6 None" in outs[1][0]
    m = Mapper(world["index"], CPU)
    want = m.chains_gaf_text(m.map_reads(_queries(world["reads"])))
    with open(out, "rb") as fh:
        assert fh.read() == want


def test_shard_index_on_one_rank_is_the_single_device_path(world):
    m = Mapper(world["index"], CPU, shard_index=True)
    assert not m.shard_index and m.mesh is None


@pytest.mark.parametrize("threads,want", [(1, 1), (0, 1), (3, 3), (-2, 1)])
def test_cpu_ranks_from_threads(threads, want):
    assert cli.resolve_ranks(threads, CPU) == want
