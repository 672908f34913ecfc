"""CUDA kernels against their plain twins, and the slice on the card
against the CPU path.  Every test here needs an NVIDIA GPU: the module
carries the ``cuda`` marker (registered in pytest.ini) and uses the
``cuda_device`` fixture, which skips the test where
``torch.cuda.is_available()`` is false.

Run on the card (tests/conftest.py imports jax, which that machine
lacks) with:  python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

from vgaligner_tpu_torch.ops import chain as C
from vgaligner_tpu_torch.ops import poa_device as PD
from vgaligner_tpu_torch.testing import (far_jump_local_batch, random_local_batch,
                                         random_poa_batch, sample_reads, with_local_edge_cases,
                                         with_poa_edge_cases, write_synthetic_gfa)

pytestmark = [pytest.mark.cuda, pytest.mark.usefixtures("cuda_device")]
K = 11


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("seed,B,A,bw", [(0, 64, 256, 50), (1, 3, 3000, 50), (2, 16, 128, 100)])
def test_chain_kernel_matches_plain(cuda_device, seed, B, A, bw):
    rng = np.random.default_rng(seed)
    qb = torch.from_numpy(rng.integers(0, 90, (B, A)).astype(np.int32))
    tb = torch.from_numpy(rng.integers(0, 2 * A, (B, A)).astype(np.int64))
    valid = torch.from_numpy(rng.random((B, A)) < 0.9)
    _o, qb_s, tb_s, te_s, v_s = C.sort_anchors(qb, tb, tb + K, valid)
    args = [x.to(cuda_device).contiguous() for x in (qb_s, tb_s.int(), te_s.int(), v_s)]
    got = C.chain_dp(*args, K, bw, 1000)
    want = C.chain_dp_plain(*[a.cpu() for a in args], K, bw, 1000)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_gap_cost_kernel_matches_plain(cuda_device):
    g = torch.arange(0, 1001, dtype=torch.int32)
    assert torch.equal(C.gap_cost_scaled_i32(g.to(cuda_device), K).cpu(),
                       C.gap_cost_scaled_i32_plain(g, K))


@pytest.mark.parametrize("P,W,V", [(2, 128, 256), (4, 256, 128), (8, 128, 512), (8, 1024, 128)])
def test_poa_kernels_match_plain(cuda_device, P, W, V):
    arrs = random_poa_batch(P + W + V, 12, V, P, W - 1)
    t = [torch.from_numpy(a) for a in arrs]
    init = torch.from_numpy(PD.make_init_row(W - 1))
    s, k, tb = PD.poa_dp(*[x.to(cuda_device) for x in t], init.to(cuda_device))
    tape, tl = PD.poa_traceback(tb, t[1].to(cuda_device), k, t[5].to(cuda_device))
    ws, wk, wtb = PD.poa_dp_plain(*t, init)
    wtape, wtl = PD.poa_traceback_plain(tb.cpu(), t[1], k.cpu(), t[5])
    assert torch.equal(s.cpu(), ws) and torch.equal(k.cpu(), wk)
    for b, n in enumerate(arrs[3]):
        assert torch.equal(tb[b, :n].cpu(), wtb[b, :n])
    assert torch.equal(tl.cpu(), wtl)
    for b, n in enumerate(wtl.tolist()):
        assert torch.equal(tape[b, :n].cpu(), wtape[b, :n])


@pytest.mark.parametrize("W", [2048, 4096, 8192])
def test_poa_kernels_wide_rows_match_plain(cuda_device, W):
    """Rows over 1,024 columns: several columns per thread."""
    arrs = random_poa_batch(W, 4, 128, 2, W - 1)
    t = [torch.from_numpy(a) for a in arrs]
    init = torch.from_numpy(PD.make_init_row(W - 1))
    s, k, tb = PD.poa_dp(*[x.to(cuda_device) for x in t], init.to(cuda_device))
    tape, tl = PD.poa_traceback(tb, t[1].to(cuda_device), k, t[5].to(cuda_device))
    ws, wk, wtb = PD.poa_dp_plain(*t, init)
    wtape, wtl = PD.poa_traceback_plain(tb.cpu(), t[1], k.cpu(), t[5])
    assert torch.equal(s.cpu(), ws) and torch.equal(k.cpu(), wk)
    for b, n in enumerate(arrs[3]):
        assert torch.equal(tb[b, :n].cpu(), wtb[b, :n])
    assert torch.equal(tl.cpu(), wtl) and torch.equal(tape.cpu(), wtape)


def _fused_matches_plain(dev, arrs):
    """poa_dp_tb's kernel against poa_dp_plain + poa_traceback_plain on
    the same CUDA tensors, bit for bit; returns n_backing."""
    W = arrs[4].shape[1] + 1
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrs]
    init = torch.from_numpy(PD.make_init_row(W - 1)).to(dev)
    before = PD.kernels.LAUNCHES["poa_dp_tb"]
    score, sink, tbits, tape, tlen, n_backing = PD.poa_dp_tb(*t, init)
    assert PD.kernels.LAUNCHES["poa_dp_tb"] == before + 1
    ws, wk, wtb = PD.poa_dp_plain(*t, init)
    wtape, wtl = PD.poa_traceback_plain(wtb, t[1], wk, t[5])
    assert torch.equal(score, ws) and torch.equal(sink, wk)
    for b, n in enumerate(arrs[3]):
        assert torch.equal(tbits[b, :n], wtb[b, :n])
    assert torch.equal(tlen, wtl) and torch.equal(tape, wtape)
    assert torch.equal(n_backing, PD.backing_rows_plain(t[1], t[3]))
    return n_backing.cpu()


@pytest.mark.parametrize("P,W,V", [(2, 32, 96), (4, 64, 128), (2, 128, 256), (8, 128, 128),
                                   (4, 256, 64), (8, 256, 256), (2, 128, 2048)])
def test_poa_dp_tb_kernel_matches_plain(cuda_device, P, W, V):
    """Far predecessors beyond the row ring, problems over the pin budget
    (the backing store) and problems within the ring, nv < V."""
    far = random_poa_batch(P * W + V, 12, V, P, W - 1, far_frac=0.3)
    near = random_poa_batch(P * W + V + 1, 4, V, P, W - 1, far_frac=0.0)
    n_backing = _fused_matches_plain(cuda_device, [np.concatenate(x) for x in zip(far, near)])
    assert (n_backing[:12] > 0).any() and (n_backing[12:] == 0).all()


def test_poa_dp_tb_kernel_main_shape(cuda_device):
    """The main path's chunk shape: 1,024 problems x V 256 x W 128, P 2."""
    _fused_matches_plain(cuda_device, random_poa_batch(7, 1024, 256, 2, 127))


def _cluster_matches_plain(dev, arrs):
    """poa_dp_tb_cluster's kernel against poa_dp_plain +
    poa_traceback_plain on the same CUDA tensors, bit for bit, through
    ``dp_and_traceback`` (which must route there); returns n_backing."""
    W = arrs[4].shape[1] + 1
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrs]
    init = torch.from_numpy(PD.make_init_row(W - 1)).to(dev)
    before = PD.kernels.launch_counts()
    score, tape, tlen = PD.dp_and_traceback(*t, init)
    after = PD.kernels.launch_counts()
    assert after["poa_dp_tb_cluster"] == before["poa_dp_tb_cluster"] + 1
    assert after["poa_dp"] == before["poa_dp"] and after["poa_dp_tb"] == before["poa_dp_tb"]
    _s, sink, tbits, _tape, _tlen, n_backing = PD.poa_dp_tb_cluster(*t, init)
    ws, wk, wtb = PD.poa_dp_plain(*t, init)
    wtape, wtl = PD.poa_traceback_plain(wtb, t[1], wk, t[5])
    assert torch.equal(score, ws) and torch.equal(sink, wk)
    for b, n in enumerate(arrs[3]):
        assert torch.equal(tbits[b, :n], wtb[b, :n])
    assert torch.equal(tlen, wtl) and torch.equal(tape, wtape)
    assert torch.equal(n_backing, PD.backing_rows_plain(t[1], t[3]))
    return n_backing.cpu()


@pytest.mark.parametrize("P,W,V", [(2, 512, 256), (4, 1024, 128), (8, 2048, 128), (2, 4096, 96),
                                   (4, 8192, 64), (2, 2048, 8192)])
def test_poa_dp_tb_cluster_kernel_matches_plain(cuda_device, P, W, V):
    """Every width of CLUSTER_WIDTHS (1-16 CTAs a cluster), V 8,192 at W
    2,048: far predecessors beyond the row ring, problems over the pin
    budget (the backing store), a predecessor at and past its vertex, nv
    far below V, and problems within the ring."""
    far = with_poa_edge_cases(random_poa_batch(P * W + V, 6, V, P, W - 1, far_frac=0.3),
                              empty=False)
    near = random_poa_batch(P * W + V + 1, 2, V, P, W - 1, far_frac=0.0)
    n_backing = _cluster_matches_plain(cuda_device, [np.concatenate(x) for x in zip(far, near)])
    assert (n_backing[:6] > 0).any() and (n_backing[6:] == 0).all()


def test_long_reads_take_the_cluster_kernel(cuda_device, tmp_path):
    """Reads of 600-2,000 bp (rows of 1,024 and 2,048 columns) through the
    abPOA aligner: the cluster kernel, never K2/K3, and the CPU path's
    alignments."""
    from vgaligner_tpu_torch.graph import graph_from_gfa
    from vgaligner_tpu_torch.index import Index
    from vgaligner_tpu_torch.io.fastx import QuerySequence
    from vgaligner_tpu_torch.models.mapper import Mapper
    from vgaligner_tpu_torch.models.poa_aligner import PoaAligner, PoaEngine

    gfa = str(tmp_path / "g.gfa")
    write_synthetic_gfa(gfa, seed=5, backbone_len=6000, n_haplotypes=4)
    graph = graph_from_gfa(gfa)
    index = Index.build(graph, K, 100, 100)
    qs = [QuerySequence(name=f"r{i}", seq=sample_reads(graph, 1, n, seed=40 + i, sub_rate=0.01)[0])
          for i, n in enumerate((600, 1500, 2000))]
    out = []
    PD.kernels.reset_launch_counts()
    for d in (cuda_device, torch.device("cpu")):
        chains = Mapper(index, d, precision="fast").map_reads(qs)
        alns = PoaAligner(index, d, engine=PoaEngine.ABPOA).best_alignments_for_queries(chains)
        out.append("".join(a.to_string() for a in alns))
    assert out[0] == out[1]
    launches = PD.kernels.launch_counts()
    assert launches["poa_dp_tb_cluster"] >= 2
    assert launches["poa_dp"] == launches["poa_traceback"] == launches["poa_dp_tb"] == 0


@pytest.mark.parametrize("P,W,V", [(2, 128, 256), (4, 256, 512), (8, 2048, 128)])
def test_poa_local_kernel_matches_plain(cuda_device, P, W, V):
    vcodes, vpred, _sink, nv, q, nq = random_poa_batch(P * W + V, 16, V, P, W - 1)
    q[0] = 4  # no positive cell
    n = min(V, W - 1) // 2
    q[1:, :n] = vcodes[1:, :n]  # long local matches along the vertex order
    arrs = [torch.from_numpy(a) for a in (vcodes, vpred, nv, q, nq)]
    got = PD.poa_local(*[a.to(cuda_device) for a in arrs])
    want = PD.poa_local_plain(*arrs)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _local_warp_matches_plain(dev, arrs):
    """poa_local_warp's kernel against poa_local_plain on the same CUDA
    tensors, bit for bit, through ``poa_local`` (which must route there);
    returns n_backing."""
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrs]
    before = PD.kernels.launch_counts()
    got = PD.poa_local(*t)
    after = PD.kernels.launch_counts()
    assert after["poa_local_warp"] == before["poa_local_warp"] + 1
    assert after["poa_local"] == before["poa_local"]
    want = PD.poa_local_plain(*t)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    n_backing = PD.poa_local_warp(*t)[4]
    assert torch.equal(n_backing, PD.backing_rows_plain(t[1], t[2], PD.LOCAL_RING, PD.LOCAL_PINS))
    return n_backing.cpu()


@pytest.mark.parametrize("P,W,V", [(2, 32, 64), (4, 64, 256), (8, 128, 64), (2, 128, 256),
                                   (4, 128, 2048), (8, 256, 256), (2, 256, 64), (4, 32, 2048)])
def test_poa_local_warp_kernel_matches_plain(cuda_device, P, W, V):
    """Far predecessors beyond the ring, problems over the pin budget (the
    backing store), a predecessor at and past its vertex, nv far below V
    and nv = 0, and problems within the ring."""
    far = with_local_edge_cases(random_local_batch(P * W + V, 12, V, P, W - 1, far_frac=0.3))
    near = random_local_batch(P * W + V + 1, 4, V, P, W - 1, far_frac=0.0)
    n_backing = _local_warp_matches_plain(cuda_device, [np.concatenate(x) for x in zip(far, near)])
    assert (n_backing[:12] > 0).any() and (n_backing[12:] == 0).all()


def test_poa_local_warp_kernel_rspoa_batch_shape(cuda_device):
    """The rspoa path's batch shape: 8,192 problems x V 256 x W 128, P 2."""
    _local_warp_matches_plain(cuda_device, random_local_batch(9, 8192, 256, 2, 127, far_frac=0.0))


def _local_cluster_matches_plain(dev, arrs):
    """poa_local_cluster's kernel against poa_local_plain on the same CUDA
    tensors, bit for bit, directly and through ``poa_local`` (which must
    route there); returns n_backing."""
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrs]
    want = PD.poa_local_plain(*t)
    before = PD.kernels.launch_counts()
    got = PD.poa_local(*t)
    after = PD.kernels.launch_counts()
    assert after["poa_local_cluster"] == before["poa_local_cluster"] + 1
    assert after["poa_local"] == before["poa_local"]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    *got, n_backing = PD.poa_local_cluster(*t)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(n_backing, PD.backing_rows_plain(t[1], t[2], PD.LOCAL_RING, PD.LOCAL_PINS))
    return n_backing.cpu()


@pytest.mark.parametrize("P,W,V", [(2, 512, 256), (4, 1024, 128), (8, 2048, 128), (2, 4096, 96),
                                   (4, 8192, 64), (2, 2048, 4096), (8, 4096, 128),
                                   (2, 8192, 128)])
def test_poa_local_cluster_kernel_matches_plain(cuda_device, P, W, V):
    """Every width of CLUSTER_WIDTHS (1, 2 and 4 CTAs a cluster): far
    predecessors beyond the ring, problems over the pin budget (the
    backing store), a predecessor at and past its vertex, nv far below V
    and nv = 0, and problems within the ring."""
    far = with_local_edge_cases(random_local_batch(P * W + V, 6, V, P, W - 1, far_frac=0.3))
    near = random_local_batch(P * W + V + 1, 2, V, P, W - 1, far_frac=0.0)
    n_backing = _local_cluster_matches_plain(cuda_device, [np.concatenate(x) for x in
                                                           zip(far, near)])
    assert (n_backing[:6] > 0).any() and (n_backing[6:] == 0).all()


@pytest.mark.parametrize("W,boundary", [(4096, 2048), (8192, 2048), (8192, 4096), (8192, 6144)])
def test_poa_local_cluster_halo_over_a_far_edge(cuda_device, W, boundary):
    """The best match run takes a far edge where a CTA's columns start:
    the left column comes from the pinned halo (problem 1) and from the
    backing row another CTA wrote (problem 0)."""
    arrs = far_jump_local_batch(W, boundary, boundary + 200)
    assert boundary % (W // PD.poa_local_cluster_occupancy(2, W, boundary + 200)[0]) == 0
    n_backing = _local_cluster_matches_plain(cuda_device, arrs)
    assert n_backing.tolist() == [1, 0]
    best = PD.poa_local_plain(*(torch.from_numpy(a) for a in arrs))[0]
    assert float(best.min()) >= 2 * (boundary - 1)


def test_poa_local_cluster_flags_too_few_backing_rows(cuda_device):
    """Given one backing row fewer than a problem needs, the kernel writes
    no row past those it was given and marks the problem with tlen -1;
    the others are unchanged."""
    arrs = with_local_edge_cases(random_local_batch(31, 8, 256, 4, 1023, far_frac=0.3))
    t = [torch.from_numpy(a).to(cuda_device) for a in arrs]
    back = PD.backing_rows_plain(t[1], t[2], PD.LOCAL_RING, PD.LOCAL_PINS).cpu().numpy()
    assert (back > 0).any() and (back == 0).any()
    _best, _tape, tlen, _qend, n_backing = PD.poa_local_cluster(*t, np.maximum(back - 1, 0))
    want = PD.poa_local_plain(*t)[2].cpu().numpy()
    tlen = tlen.cpu().numpy()
    assert (tlen[back > 0] == -1).all() and (tlen[back == 0] == want[back == 0]).all()
    assert n_backing.cpu().numpy().tolist() == back.tolist()


def test_long_reads_take_the_local_cluster_kernel(cuda_device, tmp_path):
    """Reads of 600-2,000 bp (local POA rows of 1,024 and 2,048 columns)
    through the rspoa aligner: the cluster kernel, never K4 or K7, and the
    CPU path's alignments."""
    from vgaligner_tpu_torch.graph import graph_from_gfa
    from vgaligner_tpu_torch.index import Index
    from vgaligner_tpu_torch.io.fastx import QuerySequence
    from vgaligner_tpu_torch.models.mapper import Mapper
    from vgaligner_tpu_torch.models.poa_aligner import PoaAligner, PoaEngine

    gfa = str(tmp_path / "g.gfa")
    write_synthetic_gfa(gfa, seed=5, backbone_len=6000, n_haplotypes=4)
    graph = graph_from_gfa(gfa)
    index = Index.build(graph, K, 100, 100)
    qs = [QuerySequence(name=f"r{i}", seq=sample_reads(graph, 1, n, seed=40 + i, sub_rate=0.01)[0])
          for i, n in enumerate((600, 1500, 2000))]
    out = []
    PD.kernels.reset_launch_counts()
    for d in (cuda_device, torch.device("cpu")):
        chains = Mapper(index, d, precision="exact").map_reads(qs)
        alns = PoaAligner(index, d, engine=PoaEngine.RSPOA).best_alignments_for_queries(chains)
        out.append("".join(a.to_string() for a in alns))
    assert out[0] == out[1]
    launches = PD.kernels.launch_counts()
    assert launches["poa_local_cluster"] >= 2
    assert launches["poa_local"] == launches["poa_local_warp"] == 0


def test_chain_kernel_long_read_shape(cuda_device):
    """The long-read launch's shape, B 65 x A 16,384: one read of 9,544
    valid anchors, the rest under 2,100, valid anchors not a prefix in
    some."""
    B, A = 65, 16384
    rng = np.random.default_rng(12)
    te = np.sort(rng.integers(0, 3 * A, (B, A)), axis=1).astype(np.int32) + K
    qb = np.sort(rng.integers(0, 10000, (B, A)), axis=1).astype(np.int32)
    n_valid = np.concatenate([[9544], rng.integers(1400, 2100, B - 1)])
    valid = np.arange(A)[None, :] < n_valid[:, None]
    valid[1::3] &= rng.random((len(valid[1::3]), A)) < 0.7  # not a prefix
    args = [torch.from_numpy(x).to(cuda_device) for x in (qb, te - K, te, valid)]
    want = C.chain_dp_plain(*[a.cpu() for a in args], K, 50, 1000)
    got = C.chain_dp(*args, K, 50, 1000)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert int((want[1] >= 0).sum()) > 10000


def _exact_args(dev, seed, B, A, unsorted=False):
    rng = np.random.default_rng(seed)
    qb = torch.from_numpy(rng.integers(0, 90, (B, A)).astype(np.int32))
    if unsorted:  # valid anchors not a prefix
        te = torch.from_numpy(np.sort(rng.integers(0, 3 * A, (B, A)), axis=1) + K)
        valid = torch.from_numpy(rng.random((B, A)) < 0.5)
        return [x.to(dev).contiguous() for x in (qb, te - K, te, valid)]
    tb = torch.from_numpy(rng.integers(0, 2 * A, (B, A)).astype(np.int64))
    valid = torch.from_numpy(rng.random((B, A)) < 0.7)
    valid[1] = False  # a read with no valid anchor
    _o, qb_s, tb_s, te_s, v_s = C.sort_anchors(qb, tb, tb + K, valid)
    return [x.to(dev).contiguous() for x in (qb_s, tb_s, te_s, v_s)]


@pytest.mark.parametrize("per_pair", [False, True])
@pytest.mark.parametrize("bw", [20, 50, 100])
@pytest.mark.parametrize("unsorted", [False, True])
def test_chain_exact_kernel_paths_match_plain(cuda_device, unsorted, bw, per_pair):
    """The last-valid stop, one divide a row and (a table with a
    negative entry) one a pair, at bands under, near and over the warp,
    on sorted reads and on reads whose valid anchors are scattered, bit
    for bit."""
    args = _exact_args(cuda_device, 11 + bw, 37, 300, unsorted)
    table = C.make_gap_cost_table(K, 1000)
    if per_pair:
        table[-1] = -table[-1]
    assert C.exact_divide_once(300, K, table) != per_pair
    got = C.chain_dp_exact(*args, K, bw, table)
    want = C.chain_dp_exact_plain(*args, K, bw, table)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int64) if g.dtype == torch.float64 else g,
                           w.view(torch.int64) if w.dtype == torch.float64 else w)
    assert bool((got[1] >= 0).any())


@pytest.mark.parametrize("seed", [5, 6])
def test_chain_exact_kernel_over_the_bound(cuda_device, seed):
    """A gap table whose milli-unit scores pass 2^41: the per-pair-divide
    path, bit for bit."""
    args = _exact_args(cuda_device, seed, 16, 200)
    table = -C.make_gap_cost_table(K, 1000) * 1e8
    assert not C.exact_divide_once(200, K, table)
    got = C.chain_dp_exact(*args, K, 50, table)
    want = C.chain_dp_exact_plain(*args, K, 50, table)
    assert torch.equal(got[0].view(torch.int64), want[0].view(torch.int64))
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2].view(torch.int64), want[2].view(torch.int64))
    assert float(want[2].abs().max()) * 1000 > 2 ** 41


@pytest.mark.parametrize("seed,B,A,bw,max_gap", [(0, 64, 256, 50, 1000), (1, 3, 3000, 50, 1000),
                                                  (2, 16, 128, 100, 1000), (3, 8, 512, 50, 30000)])
def test_chain_exact_kernel_matches_plain(cuda_device, seed, B, A, bw, max_gap):
    """max_gap 30,000: a gap table too large for shared memory."""
    rng = np.random.default_rng(seed)
    qb = torch.from_numpy(rng.integers(0, 90, (B, A)).astype(np.int32))
    tb = torch.from_numpy(rng.integers(0, 2 * A, (B, A)).astype(np.int64))
    valid = torch.from_numpy(rng.random((B, A)) < 0.9)
    _o, qb_s, tb_s, te_s, v_s = C.sort_anchors(qb, tb, tb + K, valid)
    table = C.make_gap_cost_table(K, max_gap)
    args = [x.to(cuda_device).contiguous() for x in (qb_s, tb_s, te_s, v_s)]
    f, pred, cmax = C.chain_dp_exact(*args, K, bw, table)
    wf, wpred, wcmax = C.chain_dp_exact_plain(*args, K, bw, table)
    assert torch.equal(f.view(torch.int64), wf.view(torch.int64))  # bit for bit
    assert torch.equal(pred, wpred)
    assert torch.equal(cmax.view(torch.int64), wcmax.view(torch.int64))
    cf, cpred, ccmax = C.chain_dp_exact_plain(*[a.cpu() for a in args], K, bw, table)
    assert torch.equal(f.cpu().view(torch.int64), cf.view(torch.int64))
    assert torch.equal(pred.cpu(), cpred)


def test_slice_on_the_card_matches_cpu(cuda_device, tmp_path):
    from vgaligner_tpu_torch.graph import graph_from_gfa
    from vgaligner_tpu_torch.index import Index
    from vgaligner_tpu_torch.io.fastx import QuerySequence
    from vgaligner_tpu_torch.models.mapper import Mapper
    from vgaligner_tpu_torch.models.poa_aligner import PoaAligner, PoaEngine

    gfa = str(tmp_path / "g.gfa")
    write_synthetic_gfa(gfa, seed=4, backbone_len=1500, n_haplotypes=5)
    graph = graph_from_gfa(gfa)
    index = Index.build(graph, K, 100, 100)
    qs = [QuerySequence(name=f"r{i}", seq=s) for i, s in
          enumerate(sample_reads(graph, 96, 100, sub_rate=0.02, n_rate=0.01))]
    for precision, engine in (("fast", PoaEngine.ABPOA), ("exact", PoaEngine.RSPOA)):
        out = []
        PD.kernels.reset_launch_counts()
        for d in (cuda_device, torch.device("cpu")):
            m = Mapper(index, d, precision=precision)
            chains = m.map_reads(qs)
            alns = PoaAligner(index, d, engine=engine).best_alignments_for_queries(chains)
            out.append((m.chains_gaf_text(chains), "".join(a.to_string() for a in alns)))
        assert out[0] == out[1], (precision, engine)
        launches = PD.kernels.launch_counts()
        if engine == PoaEngine.ABPOA:  # 100 bp reads: rows of 128 columns, the fused kernel
            assert launches["poa_dp_tb"] > 0 and launches["poa_dp"] == launches["poa_traceback"] == 0


def test_nccl_sharded_map_matches_one_device(cuda_device, tmp_path):
    """A world-size-1 NCCL group through the whole sharded path (bucket
    agreement, sharded position gather, per-batch merge) gives the
    single-device run's chains and alignments GAF on the card."""
    import datetime

    import torch.distributed as dist

    from vgaligner_tpu_torch.graph import graph_from_gfa
    from vgaligner_tpu_torch.index import Index
    from vgaligner_tpu_torch.io.fastx import QuerySequence
    from vgaligner_tpu_torch.models.mapper import Mapper
    from vgaligner_tpu_torch.models.poa_aligner import PoaAligner
    from vgaligner_tpu_torch.models.stream import stream_map_align
    from vgaligner_tpu_torch.parallel import collective_counts, make_mesh, reset_collective_counts

    gfa = str(tmp_path / "g.gfa")
    write_synthetic_gfa(gfa, seed=4, backbone_len=1500, n_haplotypes=5)
    graph = graph_from_gfa(gfa)
    index = Index.build(graph, K, 100, 100)
    qs = [QuerySequence(name=f"r{i}", seq=s) for i, s in
          enumerate(sample_reads(graph, 96, 100, sub_rate=0.02, revcomp_frac=0.3))]
    torch.cuda.set_device(cuda_device)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(1)
        got = {"chains": [], "alignments": []}
        reset_collective_counts()
        stream_map_align(Mapper(index, mesh=mesh, shard_index=True, precision="fast",
                                both_strands=True),
                         qs, PoaAligner(index, mesh=mesh), batch_size=40,
                         on_chains=lambda b: got["chains"].append(b.blob),
                         on_alignments=lambda b: got["alignments"].append(b.blob), mesh=mesh)
        counts = collective_counts()
    finally:
        dist.destroy_process_group()
    m = Mapper(index, cuda_device, precision="fast", both_strands=True)
    chains = m.map_reads(qs)
    alns = PoaAligner(index, cuda_device).best_alignments_for_queries(chains)
    assert b"".join(got["chains"]) == m.chains_gaf_text(chains)
    assert b"".join(got["alignments"]) == "".join(a.to_string() for a in alns).encode()
    assert counts["all_reduce"] == 3 and counts["reduce_scatter_tensor"] >= 3
    assert counts["all_gather_into_tensor"] == counts["reduce_scatter_tensor"] + 4 * 3
