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
from vgaligner_tpu_torch.testing import random_poa_batch, sample_reads, write_synthetic_gfa

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
