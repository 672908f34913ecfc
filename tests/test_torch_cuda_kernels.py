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
from vgaligner_tpu_torch.testing import (far_jump_local_batch, far_rows_local_batch,
                                         random_local_batch, random_poa_batch, sample_reads,
                                         wide_route_problems, with_local_edge_cases,
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
    assert after["poa_dp_tb"] == before["poa_dp_tb"]
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
                                   (4, 8192, 64), (2, 2048, 8192), (2, 16384, 128),
                                   (4, 16384, 96), (8, 16384, 64)])
def test_poa_dp_tb_cluster_kernel_matches_plain(cuda_device, P, W, V):
    """Every width of CLUSTER_WIDTHS (1-16 CTAs of 512 columns a cluster,
    16 of 1,024 at W 16,384), V 8,192 at W 2,048: far predecessors beyond
    the row ring, problems over the pin budget (the backing store), a
    predecessor at and past its vertex, nv far below V, and problems
    within the ring."""
    far = with_poa_edge_cases(random_poa_batch(P * W + V, 6, V, P, W - 1, far_frac=0.3),
                              empty=False)
    near = random_poa_batch(P * W + V + 1, 2, V, P, W - 1, far_frac=0.0)
    n_backing = _cluster_matches_plain(cuda_device, [np.concatenate(x) for x in zip(far, near)])
    assert (n_backing[:6] > 0).any() and (n_backing[6:] == 0).all()


def test_poa_dp_tb_cluster_kernel_at_its_largest_problem(cuda_device):
    """V 8,192 x W 16,384 (the device route's vertex cap and widest row),
    nv near V, far predecessors past the pins: equal to the plain pair."""
    arrs = random_poa_batch(230, 2, 8192, 4, 16383, far_frac=0.3, min_nv=8000)
    assert (_cluster_matches_plain(cuda_device, arrs) > 0).all()


def _backing_batch(W, V, seed):
    """Six problems with far predecessors past the pins (the cluster
    widths with the edge cases: a predecessor at and past its vertex, nv
    = 4), then two within the row ring."""
    far = random_poa_batch(seed, 6, V, 4, W - 1, far_frac=0.3)
    if W > 256:
        far = with_poa_edge_cases(far, empty=False)
    near = random_poa_batch(seed + 1, 2, V, 4, W - 1, far_frac=0.0)
    return [np.concatenate(x) for x in zip(far, near)]


@pytest.mark.parametrize("W,V", [(128, 256), (512, 256), (2048, 256), (16384, 128)])
def test_fused_kernels_take_host_counted_backing_rows(cuda_device, W, V):
    """K6 (W 128) and K8 (W 512-16,384) given the host's backing-row
    counts, as the route calls them: a backing store of exactly those
    rows, and every output equal to the plain pair's, bit for bit."""
    arrs = _backing_batch(W, V, 900 + W)
    t = [torch.from_numpy(a).to(cuda_device) for a in arrs]
    init = torch.from_numpy(PD.make_init_row(W - 1)).to(cuda_device)
    back = PD.backing_rows_plain(t[1], t[3]).cpu().numpy()
    assert (back[:6] > 0).any() and (back[6:] == 0).all()
    fused = PD.poa_dp_tb if W <= 256 else PD.poa_dp_tb_cluster
    score, sink, tbits, tape, tlen, n_backing = fused(*t, init, back)
    ws, wk, wtb = PD.poa_dp_plain(*t, init)
    wtape, wtl = PD.poa_traceback_plain(wtb, t[1], wk, t[5])
    assert torch.equal(score, ws) and torch.equal(sink, wk)
    for b, n in enumerate(arrs[3]):
        assert torch.equal(tbits[b, :n], wtb[b, :n])
    assert torch.equal(tlen, wtl) and torch.equal(tape, wtape)
    assert n_backing.cpu().numpy().tolist() == back.tolist()


@pytest.mark.parametrize("W", [128, 2048])
def test_fused_kernels_flag_too_few_backing_rows(cuda_device, W):
    """Given one backing row fewer than a problem needs, K6 and K8 write
    no row past those they were given and mark the problem with tlen -1
    (the others unchanged), and the route's drain raises."""
    V = 256
    arrs = _backing_batch(W, V, 950 + W)
    t = [torch.from_numpy(a).to(cuda_device) for a in arrs]
    init = torch.from_numpy(PD.make_init_row(W - 1)).to(cuda_device)
    back = PD.backing_rows_plain(t[1], t[3]).cpu().numpy()
    short = np.maximum(back - 1, 0)
    fused = PD.poa_dp_tb if W <= 256 else PD.poa_dp_tb_cluster
    tlen, n_backing = (x.cpu().numpy() for x in fused(*t, init, short)[4:])
    _ws, wk, wtb = PD.poa_dp_plain(*t, init)
    want = PD.poa_traceback_plain(wtb, t[1], wk, t[5])[1].cpu().numpy()
    assert (tlen[back > 0] == -1).all() and (tlen[back == 0] == want[back == 0]).all()
    assert n_backing.tolist() == back.tolist()
    zeros = np.zeros((len(back), V), dtype=np.int32)
    chunk = (arrs[0], arrs[1], arrs[2], arrs[3], zeros, zeros)
    qs = [arrs[4][b, : arrs[5][b]] for b in range(len(back))]
    pending = PD.kernel_dispatch(chunk, qs, V, W - 1, cuda_device, short)
    with pytest.raises(RuntimeError, match="backing rows"):
        PD.kernel_finish_all([pending])


@pytest.mark.parametrize("P", [2, 4, 8])
def test_cluster_kernels_resident_at_the_widest_rows(cuda_device, P):
    """At W 16,384 and V 8,192 the card keeps a cluster of each kernel
    resident: K8's 16 CTAs of 1,024 columns, K9's 8 of 2,048."""
    ctas, clusters, smem = PD.poa_dp_tb_cluster_occupancy(P, 16384, 8192)
    assert ctas == 16 and clusters > 0 and smem <= 232448
    ctas, clusters, smem = PD.poa_local_cluster_occupancy(P, 16384, 8192)
    assert ctas == 8 and clusters > 0 and smem <= 232448


def test_off_ladder_widths_take_the_redesigned_kernels(cuda_device):
    """Rows off the power-of-two ladder (the lane-padded contract's l_w
    384 and 9,088, and local rows of 300 and 9,000 columns) run padded
    on K8 and K9, equal to the unpadded plain twins."""
    dev = cuda_device
    for L in (300, 9000):
        arrs = random_poa_batch(L, 4, 128, 2, L)
        t = [torch.from_numpy(a).to(dev) for a in arrs]
        init = torch.from_numpy(PD.make_init_row(L)).to(dev)
        PD.kernels.reset_launch_counts()
        score, tape, tlen = PD.poa_global_kernel(*t, init)
        local = PD.poa_local(*(t[i] for i in (0, 1, 3, 4, 5)))
        launches = PD.kernels.launch_counts()
        assert launches["poa_dp_tb_cluster"] == launches["poa_local_cluster"] == 1
        q_w, init_w = PD.lane_pad(t[4], init)
        ws, wk, wtb = PD.poa_dp_plain(*t[:4], q_w, t[5], init_w)
        wtape, wtl = PD.poa_traceback_plain(wtb, t[1], wk, t[5])
        assert torch.equal(score, ws) and torch.equal(tlen, wtl) and torch.equal(tape, wtape)
        for g, w in zip(local, PD.poa_local_plain(*(t[i] for i in (0, 1, 3, 4, 5)))):
            assert torch.equal(g, w)


def test_wide_rows_take_the_cluster_kernels(cuda_device):
    """Problems of 8,192-16,383 bp queries on subgraphs under 8,192 base
    vertices through ``align_global_batch`` and ``align_local_batch``:
    K8 and K9 at W 16,384, and every result the host
    oracle's."""
    import os
    import tempfile

    from vgaligner_tpu_torch.graph import graph_from_gfa
    from vgaligner_tpu_torch.native import poa_global_host_native
    from vgaligner_tpu_torch.ops.poa import align_local_no_gap_host

    with tempfile.TemporaryDirectory() as tmp:
        gfa = os.path.join(tmp, "g.gfa")
        write_synthetic_gfa(gfa, seed=0)
        problems = wide_route_problems(graph_from_gfa(gfa))[:2]
    PD.kernels.reset_launch_counts()
    got_g = PD.align_global_batch(problems, cuda_device)
    got_l = PD.align_local_batch(problems, cuda_device)
    launches = PD.kernels.launch_counts()
    assert launches["poa_dp_tb_cluster"] >= 1 and launches["poa_local_cluster"] >= 1
    for p, g, loc in zip(problems, got_g, got_l):
        assert g == poa_global_host_native(*p)
        assert loc == align_local_no_gap_host(*p)


def test_long_reads_take_the_cluster_kernel(cuda_device, tmp_path):
    """Reads of 600-2,000 bp (rows of 1,024 and 2,048 columns) through the
    abPOA aligner: the cluster kernel, never K6, and the CPU path's
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
    assert launches["poa_dp_tb"] == 0


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


def _local_warp_with_rows(dev, arrs, back=None):
    """K7 given the host's backing-row counts (``back``, or
    ``backing_rows_plain``'s), as the route calls it: a backing store of
    exactly those rows, every output equal to the twin's bit for bit, and
    n_backing the host's count.  Returns the counts."""
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrs]
    if back is None:
        back = PD.backing_rows_plain(t[1], t[2], PD.LOCAL_RING, PD.LOCAL_PINS).cpu().numpy()
    before = PD.kernels.launch_counts()["poa_local_warp"]
    *got, n_backing = PD.poa_local_warp(*t, back)
    assert PD.kernels.launch_counts()["poa_local_warp"] == before + 1
    for name, g, w in zip(("best", "tape", "tlen", "qend"), got, PD.poa_local_plain(*t)):
        assert torch.equal(g, w), name
    assert n_backing.cpu().numpy().tolist() == list(back)
    return back


@pytest.mark.parametrize("W", [32, 64, 128, 256])
@pytest.mark.parametrize("P", [2, 4, 8])
def test_poa_local_warp_takes_host_counted_backing_rows(cuda_device, P, W):
    """Far-heavy problems (past the pins: backing rows) and near-only
    ones (none) in one launch, with the host's counts."""
    far = with_local_edge_cases(random_local_batch(700 + P * W, 12, 256, P, W - 1, far_frac=0.3))
    near = random_local_batch(701 + P * W, 4, 256, P, W - 1, far_frac=0.0)
    back = _local_warp_with_rows(cuda_device, [np.concatenate(x) for x in zip(far, near)])
    assert (back[:12] > 0).any() and (back[12:] == 0).all()


@pytest.mark.parametrize("B", [1, 3, 5])
def test_poa_local_warp_odd_batches(cuda_device, B):
    """B not a multiple of the block's 4 problems: the absent warps return
    before reading back_off, and the last real problem keeps its rows."""
    _local_warp_with_rows(cuda_device, random_local_batch(730 + B, B, 256, 4, 127, far_frac=0.3))


@pytest.mark.parametrize("V", [2048, 8192])
def test_poa_local_warp_far_rows_in_the_last_bitmap_words(cuda_device, V):
    """More bitmap words than lanes (64 and 256): far rows across words
    31/32 and 63/64 and the best run over a far edge whose backing row
    ranks behind every other (problem 0), or whose row is pinned (1)."""
    back = _local_warp_with_rows(cuda_device, far_rows_local_batch(V, 256))
    assert back[0] > 50 and back[1] == 0


def test_poa_local_warp_flags_too_few_backing_rows(cuda_device, monkeypatch):
    """Given one backing row fewer than a problem needs, K7 writes and
    reads no row past those it was given and marks the problem with tlen
    -1 (the others unchanged), and the rspoa route's drain raises."""
    arrs = with_local_edge_cases(random_local_batch(740, 8, 256, 4, 127, far_frac=0.3))
    t = [torch.from_numpy(a).to(cuda_device) for a in arrs]
    back = PD.backing_rows_plain(t[1], t[2], PD.LOCAL_RING, PD.LOCAL_PINS).cpu().numpy()
    assert (back > 0).any() and (back == 0).any()
    _best, _tape, tlen, _qend, n_backing = PD.poa_local_warp(*t, np.maximum(back - 1, 0))
    want = PD.poa_local_plain(*t)[2].cpu().numpy()
    tlen = tlen.cpu().numpy()
    assert (tlen[back > 0] == -1).all() and (tlen[back == 0] == want[back == 0]).all()
    assert n_backing.cpu().numpy().tolist() == back.tolist()
    # the route: one-base nodes on a chain, every third also reached from
    # 12 back (far rows past the pins), and a query read off the chain
    nodes = ["ACGT"[c] for c in np.random.default_rng(741).integers(0, 4, 120)]
    edges = [(b - 1, b) for b in range(1, 120)] + [(b - 12, b) for b in range(12, 120, 3)]
    problems = [(nodes, edges, "".join(nodes[:100]))] * 3
    real = PD.local_chunks

    def one_short(*args, **kw):
        for s, e, a, rows in real(*args, **kw):
            assert (rows > 0).all()
            yield s, e, a, rows - 1

    before = PD.kernels.launch_counts()["poa_local_warp"]
    monkeypatch.setattr(PD, "local_chunks", one_short)
    with pytest.raises(RuntimeError, match="local POA route.*backing rows"):
        PD.align_local_batch(problems, cuda_device)
    assert PD.kernels.launch_counts()["poa_local_warp"] == before + 1


@pytest.mark.parametrize("kernel", ["warp", "cluster"])
def test_local_wrappers_back_to_back_with_pinned_offsets(cuda_device, kernel):
    """K7 and K9 launched four times in a row on different batches with
    the host's counts, with no wait between: each launch's offsets,
    copied pinned and non-blocking, are its own, so every result equals
    its twin."""
    W = 128 if kernel == "warp" else 1024
    fn = PD.poa_local_warp if kernel == "warp" else PD.poa_local_cluster
    batches = [[torch.from_numpy(a).to(cuda_device) for a in with_local_edge_cases(
        random_local_batch(750 + i, 8 + 4 * i, 256, 2 + 2 * (i % 2), W - 1, far_frac=0.3))]
        for i in range(4)]
    backs = [PD.backing_rows_plain(t[1], t[2], PD.LOCAL_RING, PD.LOCAL_PINS).cpu().numpy()
             for t in batches]
    assert all((b > 0).any() for b in backs)
    torch.cuda.synchronize()
    outs = [fn(*t, back) for t, back in zip(batches, backs)]
    torch.cuda.synchronize()
    for t, got in zip(batches, outs):
        for g, w in zip(got[:4], PD.poa_local_plain(*t)):
            assert torch.equal(g, w)
        assert torch.equal(got[4], PD.backing_rows_plain(t[1], t[2], PD.LOCAL_RING,
                                                          PD.LOCAL_PINS))


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
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    *got, n_backing = PD.poa_local_cluster(*t)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(n_backing, PD.backing_rows_plain(t[1], t[2], PD.LOCAL_RING, PD.LOCAL_PINS))
    return n_backing.cpu()


@pytest.mark.parametrize("P,W,V", [(2, 512, 256), (4, 1024, 128), (8, 2048, 128), (2, 4096, 96),
                                   (4, 8192, 64), (2, 2048, 4096), (8, 4096, 128),
                                   (2, 8192, 128), (2, 16384, 128), (4, 16384, 96),
                                   (8, 16384, 64)])
def test_poa_local_cluster_kernel_matches_plain(cuda_device, P, W, V):
    """Every width of CLUSTER_WIDTHS (1, 2, 4 and 8 CTAs a cluster): far
    predecessors beyond the ring, problems over the pin budget (the
    backing store), a predecessor at and past its vertex, nv far below V
    and nv = 0, and problems within the ring."""
    far = with_local_edge_cases(random_local_batch(P * W + V, 6, V, P, W - 1, far_frac=0.3))
    near = random_local_batch(P * W + V + 1, 2, V, P, W - 1, far_frac=0.0)
    n_backing = _local_cluster_matches_plain(cuda_device, [np.concatenate(x) for x in
                                                           zip(far, near)])
    assert (n_backing[:6] > 0).any() and (n_backing[6:] == 0).all()


@pytest.mark.parametrize("W,boundary", [(4096, 2048), (8192, 2048), (8192, 4096), (8192, 6144),
                                        (16384, 8192), (16384, 14336)])
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


def test_poa_local_cluster_int16_extreme(cuda_device):
    """H at the top of K9's int16 range: a chain of 16,384 vertices and a
    query of 16,383 bases that matches it, one run of 16,383 matches, so
    H reaches 2 x 16,383 = 32,766 at W 16,384.  Equal to the twin."""
    rng = np.random.default_rng(8)
    V, L = 16384, 16383
    seq = rng.integers(0, 4, V).astype(np.int8)
    vpred = np.full((1, V, 2), -1, dtype=np.int32)
    vpred[0, 1:, 0] = np.arange(V - 1)
    arrs = (seq[None], vpred, np.array([V], np.int32), seq[None, :L].copy(),
            np.array([L], np.int32))
    _local_cluster_matches_plain(cuda_device, arrs)
    best, _tape, tlen, qend, _nb = PD.poa_local_cluster(
        *(torch.from_numpy(a).to(cuda_device) for a in arrs))
    assert float(best[0]) == 2 * L == 32766 and int(tlen[0]) == L and int(qend[0]) == L


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
    through the rspoa aligner: the cluster kernel, never K7, and the
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
    assert launches["poa_local_warp"] == 0


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


def _edge_case(name):
    """(qb, tb, te, valid as numpy, bandwidth, max_gap) of a case of the
    exact kernel's block edges and shapes."""
    if name.startswith("odd_B"):  # a block's second read absent
        B = int(name[5:])
        rng = np.random.default_rng(B)
        qb = rng.integers(0, 90, (B, 300)).astype(np.int32)
        tb = rng.integers(0, 600, (B, 300)).astype(np.int64)
        valid = rng.random((B, 300)) < 0.8
        _o, qb, tb, te, valid = C.sort_anchors(*(torch.from_numpy(x) for x in (qb, tb, tb + K, valid)))
        return [x.numpy() for x in (qb, tb, te, valid)], 50, 1000
    if name == "rows_multiple_of_rb":  # n_g 48 and 36, rb 12 at bw 50; a read with none
        qb = np.tile(np.arange(100, dtype=np.int32) % 80, (4, 1))
        tb = np.tile(np.arange(100, dtype=np.int64), (4, 1)) + 100
        valid = np.zeros((4, 100), bool)
        valid[0, :48] = valid[1, :36] = valid[3, :12] = True
        return [qb, tb, tb + K, valid], 50, 1000
    rng = np.random.default_rng(len(name))
    B, A, bw, max_gap = {"bw700": (5, 2000, 700, 1000), "A65536": (2, 65536, 50, 1000),
                         "max_gap30000": (6, 600, 50, 30000)}[name]
    te = np.sort(rng.integers(0, 3 * A, (B, A)), axis=1).astype(np.int64) + K
    qb = np.sort(rng.integers(0, A // 4 + 90, (B, A)), axis=1).astype(np.int32)
    valid = rng.random((B, A)) < 0.8
    valid[0, A // 2:] = False  # the rows after the last valid one
    return [qb, te - K, te, valid], bw, max_gap


@pytest.mark.parametrize("per_pair", [False, True])
@pytest.mark.parametrize("case", ["odd_B1", "odd_B3", "odd_B5", "rows_multiple_of_rb", "bw700",
                                  "A65536", "max_gap30000"])
def test_chain_exact_kernel_edges_match_plain(cuda_device, case, per_pair):
    """chain_dp_exact.cu's producer and consumer warps on both divide
    paths, bit for bit: odd B (a block's second read absent), rows to the
    last valid anchor a multiple of the term block and a read with none,
    bw 700 (one row a block), A 65,536 (the mapper's cap) and a gap table
    of 30,001 entries."""
    args, bw, max_gap = _edge_case(case)
    table = C.make_gap_cost_table(K, max_gap)
    if per_pair:
        table[1::7] *= -1.0
    assert C.exact_divide_once(args[0].shape[1], K, table) != per_pair
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device) for x in args]
    want = C.chain_dp_exact_plain(*t, K, bw, table)
    got = C.chain_dp_exact(*t, K, bw, table)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int64) if g.dtype == torch.float64 else g,
                           w.view(torch.int64) if w.dtype == torch.float64 else w)
    assert bool((want[1] >= 0).any())


def test_chain_exact_kernel_residency(cuda_device):
    """Two reads a block, 8 blocks an SM at bw 50 (64 registers, 3 named
    barriers and 27,712 B of shared memory a block): the long-read
    launch's 65 reads and half the main path's 4,096 are resident at
    once."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for div_once in (True, False):
        occ = C.chain_dp_exact_occupancy(50, div_once)
        assert occ == {"reads_a_block": 2, "blocks_an_sm": 8, "smem": 27712}
    assert 2 * 8 * sms >= 4096 // 2
    # bw 700: one row a block, a ring of 1,024, over 48 KB a block (the opt-in)
    wide = C.chain_dp_exact_occupancy(700)
    assert wide["smem"] == 2 * 36976 and wide["blocks_an_sm"] >= 1


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
            assert launches["poa_dp_tb"] > 0


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
