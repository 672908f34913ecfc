"""Port vs JAX package: the global POA DP and traceback as the
cluster kernel (kernels/csrc/poa_dp_tb_cluster.cu) must reproduce them,
tolerance 0.

  * ``poa_dp_tb_cluster``'s CPU route (the plain pair the kernel is held
    to on the card) against JAX ``poa_dp_xla`` + ``traceback_batch`` at
    W 512/1,024/2,048 (V 64) and 16,384 (V 128) x P 2/4/8, on batches
    with far predecessors (``far_frac`` 0.3), more far vertices than the
    kernel pins, a predecessor at and one past its vertex, nv = 4 and
    nv = 0;
  * a numpy model of the kernel's column split: each slice computes its
    row from its own columns, the H it derives for the column left of its
    first and the earlier slices' records only, and equals
    ``poa_dp_plain`` bit for bit at 1/2/4/8 slices of W 128 and at 16
    slices of 1,024 columns (W 16,384, the kernel's CTAs there), on
    random batches and on a chain whose match run ends at a slice
    boundary and whose long insertion crosses several;
  * ``dp_and_traceback`` routes each width to its kernel, off-ladder
    widths padded on the right, and CPU tensors launch none; every width
    from 1 to 16,384 maps to K6 or K8 (and K7 or K9 for the local POA);
    the padded plain twins equal the unpadded ones
    and JAX ``poa_global_kernel`` at L 300 and 9,000;
  * the kernel source's ring, pin and slice sizes are the wrapper's.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vgaligner_tpu.ops import poa_device as JPD

from vgaligner_tpu_torch import kernels
from vgaligner_tpu_torch.ops import poa_device as PD
from vgaligner_tpu_torch.testing import one_torch_thread, random_poa_batch, with_poa_edge_cases

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)
F32 = np.float32
NEG = F32(PD.NEGF)
O1, E1, O2, E2 = F32(4), F32(2), F32(24), F32(1)


def _batch(P, W, V=64):
    far = with_poa_edge_cases(random_poa_batch(70 + P * 3 + W, 5, V, P, W - 1, far_frac=0.3))
    near = random_poa_batch(71 + P * 3 + W, 2, V, P, W - 1, far_frac=0.0)
    return [np.concatenate(x) for x in zip(far, near)]


@pytest.mark.parametrize("W", [512, 1024, 2048, 16384])
@pytest.mark.parametrize("P", [2, 4, 8])
def test_cluster_cpu_route_matches_jax(P, W):
    arrs = _batch(P, W, 128 if W == 16384 else 64)
    vcodes, vpred, is_sink, nv, q, nq = arrs
    init_row = PD.make_init_row(W - 1)
    js, jk, jtb = jax.device_get(JPD.poa_dp_xla(
        jnp.asarray(vcodes), jnp.asarray(vpred), jnp.asarray(is_sink != 0), jnp.asarray(nv),
        jnp.asarray(q), jnp.asarray(nq), jnp.asarray(init_row)))
    jtape, jtl = jax.device_get(JPD.traceback_batch(
        jnp.asarray(jtb), jnp.asarray(vpred), jnp.asarray(jk), jnp.asarray(nq)))
    before = kernels.launch_counts()
    score, sink, tbits, tape, tlen, n_backing = PD.poa_dp_tb_cluster(
        *(torch.from_numpy(a) for a in arrs), torch.from_numpy(init_row))
    assert kernels.launch_counts() == before  # CPU tensors: the plain pair, no kernel
    np.testing.assert_array_equal(score.numpy(), js)
    np.testing.assert_array_equal(sink.numpy(), jk)
    for b in range(len(nv)):
        np.testing.assert_array_equal(tbits[b, : nv[b]].numpy(), jtb[b, : nv[b]])
    np.testing.assert_array_equal(tlen.numpy(), jtl)
    for b in range(len(nv)):
        np.testing.assert_array_equal(tape[b, : tlen[b]].numpy(),
                                      jtape[b, : jtl[b]].astype(np.int32))
    assert nv[2] == 4 and nv[3] == 0 and (tlen.numpy() > 0).all()
    assert (n_backing.numpy()[:5] > 0).any() and (n_backing.numpy()[5:] == 0).all()
    np.testing.assert_array_equal(n_backing.numpy(), [
        max(0, len({int(p) for v in range(int(nv[b])) for p in vpred[b, v]
                    if 0 <= p < v - PD.TB_RING}) - PD.TB_PINS) for b in range(len(nv))])


# ---------------------------------------------------------------------------
# the column split in numpy


def _slot_max(cands, extra=None):
    """The first slot at the max of each column (strictly greater takes
    over), as the kernels loop over slots: (best, slot, extra at slot)."""
    best, slot = cands[0].copy(), np.zeros(cands[0].shape, np.int64)
    ex = None if extra is None else extra[0].copy()
    for p in range(1, len(cands)):
        upd = cands[p] > best
        best = np.where(upd, cands[p], best)
        slot = np.where(upd, p, slot)
        if extra is not None:
            ex = np.where(upd, extra[p], ex)
    return best, slot, ex


def _split_model(arrs, init_row, n_slices):
    """(score, best_sink, tbits) of the DP with the row cut into
    ``n_slices`` column slices.  A slice holds H/E1/E2 of its own columns
    only; for the M term of its first column it keeps ``halo[v]``, the H
    of the column left of it, which it derives from the slice before it;
    across slices it sees only each earlier slice's record {x1, x2, hl}
    (the max of h_pre + e*j over the slice's columns but its last, and
    h_pre of its last column)."""
    vcodes, vpred, is_sink, nv, q, nq = arrs
    B, V = vcodes.shape
    P, L = vpred.shape[2], q.shape[1]
    W = L + 1
    wc = W // n_slices
    jall = np.arange(W).astype(F32)
    e1j_all, e2j_all = E1 * jall, E2 * jall
    tbits = np.zeros((B, V, W), np.int32)
    sink_scores = np.full((B, V), NEG, F32)
    for b in range(B):
        H = np.full((n_slices, V, wc), NEG, F32)
        S1, S2 = H.copy(), H.copy()
        halo = np.full((n_slices, V), NEG, F32)
        qi = np.concatenate([[4], q[b].astype(np.int64)])  # the query code of column j
        for v in range(int(nv[b])):
            preds = vpred[b, v]
            code = int(vcodes[b, v])
            has_any = preds[0] >= 0
            rows = []
            for s in range(n_slices):
                j0 = s * wc
                cols = slice(j0, j0 + wc)
                jc = np.arange(j0, j0 + wc)
                sub = np.where((qi[cols] == code) & (qi[cols] < 4) & (code < 4), F32(2), F32(-4))
                c1, c2, cm, o1, o2 = [], [], [], [], []
                for p in range(P):
                    pp = int(preds[p])
                    if 0 <= pp < v:
                        h, e1, e2, hl = H[s, pp], S1[s, pp], S2[s, pp], halo[s, pp]
                    elif pp < 0 and p == 0 and not has_any:
                        h, e1, e2 = init_row[cols], np.full(wc, NEG), np.full(wc, NEG)
                        hl = init_row[j0 - 1] if j0 >= 1 else NEG
                    else:
                        h = e1 = e2 = np.full(wc, NEG)
                        hl = NEG
                    hm = np.concatenate([[hl], h[:-1]]).astype(F32)
                    open1, ext1 = h - (O1 + E1), e1 - E1
                    open2, ext2 = h - (O2 + E2), e2 - E2
                    c1.append(np.maximum(open1, ext1))
                    c2.append(np.maximum(open2, ext2))
                    o1.append(open1 >= ext1)
                    o2.append(open2 >= ext2)
                    cm.append(np.where(jc >= 1, hm + sub, NEG).astype(F32))
                best1, slot1, opn1 = _slot_max(c1, o1)
                best2, slot2, opn2 = _slot_max(c2, o2)
                mbest, mslot, _ = _slot_max(cm)
                mx12 = np.maximum(best1, best2)
                h_pre = np.maximum(mbest, mx12)
                case = np.where(mbest >= mx12, 0, np.where(best1 >= best2, 1, 2))
                live = preds >= 0
                store = [np.where(live[sl], sl, 15) for sl in (mslot, slot1, slot2)]
                bits = (store[0] << 3) | (opn1.astype(np.int64) << 7) | (store[1] << 8) | \
                    (opn2.astype(np.int64) << 12) | (store[2] << 13)
                t1, t2 = h_pre + e1j_all[cols], h_pre + e2j_all[cols]
                ninf = F32(-np.inf)
                rec = (t1[:-1].max(initial=ninf), t2[:-1].max(initial=ninf), h_pre[-1])
                rows.append((h_pre, case, bits, best1, best2, t1, t2, rec))
            for s in range(n_slices):
                h_pre, case, bits, best1, best2, t1, t2, _rec = rows[s]
                j0 = s * wc
                jc = np.arange(j0, j0 + wc)
                tot1 = [max(r[7][0], r[7][2] + e1j_all[k * wc + wc - 1])
                        for k, r in enumerate(rows[:s])]
                tot2 = [max(r[7][1], r[7][2] + e2j_all[k * wc + wc - 1])
                        for k, r in enumerate(rows[:s])]
                m1 = max(tot1, default=F32(-np.inf))
                m2 = max(tot2, default=F32(-np.inf))
                hprev = NEG
                if s >= 1:
                    x1, x2, hl = rows[s - 1][7]
                    k1 = max(tot1[:-1] + [x1])
                    k2 = max(tot2[:-1] + [x2])
                    jp = F32(j0 - 1)
                    hprev = max(hl, max((k1 - O1) - E1 * jp, (k2 - O2) - E2 * jp))
                excl1 = np.maximum(m1, np.concatenate([[F32(-np.inf)],
                                                       np.maximum.accumulate(t1)[:-1]]))
                excl2 = np.maximum(m2, np.concatenate([[F32(-np.inf)],
                                                       np.maximum.accumulate(t2)[:-1]]))
                f1 = np.where(jc >= 1, (excl1 - O1) - e1j_all[j0 : j0 + wc], NEG).astype(F32)
                f2 = np.where(jc >= 1, (excl2 - O2) - e2j_all[j0 : j0 + wc], NEG).astype(F32)
                hrow = np.maximum(h_pre, np.maximum(f1, f2))
                case = np.where(hrow <= h_pre, case, np.where(hrow == f1, 3, 4))
                prev_h = np.concatenate([[hprev], hrow[:-1]]).astype(F32)
                f1o = f1 == prev_h - (O1 + E1)
                f2o = f2 == prev_h - (O2 + E2)
                tbits[b, v, j0 : j0 + wc] = (case | bits | (f1o.astype(np.int64) << 17)
                                             | (f2o.astype(np.int64) << 18))
                H[s, v], S1[s, v], S2[s, v], halo[s, v] = hrow, best1, best2, hprev
                if j0 <= nq[b] < j0 + wc and is_sink[b, v]:
                    sink_scores[b, v] = hrow[nq[b] - j0]
    score = sink_scores.max(axis=1)
    return score, (sink_scores == score[:, None]).argmax(axis=1).astype(np.int32), tbits


def _chain_batch(W, gap_at, gap_len, V=96, B=3):
    """One linear graph of V vertices; the query matches it up to column
    ``gap_at`` (the run's last column), then inserts ``gap_len`` bases
    (each unlike the graph's base it would otherwise meet, the last unlike
    the base before the gap, so the gap cannot slide), then matches the
    rest of the graph (or as much as fits the row); plus B - 1 random
    problems."""
    rng = np.random.default_rng(W + gap_at)
    L = W - 1
    ext = rng.integers(0, 4, max(V, gap_at + gap_len)).astype(np.int8)
    seq = ext[:V]
    ins = (ext[gap_at : gap_at + gap_len] + 1 + rng.integers(0, 3, gap_len)) % 4
    if ins[-1] == seq[gap_at - 1]:
        ins[-1] = (ins[-1] + 1) % 4 if (ins[-1] + 1) % 4 != ext[gap_at + gap_len - 1] \
            else (ins[-1] + 2) % 4
    qry = np.concatenate([seq[:gap_at], ins, seq[gap_at:]])[:L].astype(np.int8)
    arrs = [np.array(a, copy=True) for a in random_poa_batch(W + gap_at, B, V, 2, L)]
    vcodes, vpred, is_sink, nv, q, nq = arrs
    vcodes[0] = seq
    vpred[0] = -1
    vpred[0, 1:, 0] = np.arange(V - 1)
    is_sink[0] = 0
    is_sink[0, V - 1] = 1
    nv[0] = V
    q[0] = 4
    q[0, : len(qry)] = qry
    nq[0] = len(qry)
    return arrs


@pytest.mark.parametrize("n_slices", [1, 2, 4, 8])
def test_column_split_model_matches_plain(n_slices):
    W = 128
    cases = [random_poa_batch(90 + n_slices, 4, 48, 4, W - 1, far_frac=0.3),
             _chain_batch(W, 15, 40)]  # slices of 16+ columns: a run to 15, a gap over 32
    for arrs in cases:
        init_row = PD.make_init_row(W - 1)
        score, sink, tbits = _split_model(arrs, init_row, n_slices)
        t = [torch.from_numpy(a) for a in arrs]
        ws, wk, wtb = PD.poa_dp_plain(*t, torch.from_numpy(init_row))
        assert np.array_equal(score.view(np.int32), ws.numpy().view(np.int32))
        np.testing.assert_array_equal(sink, wk.numpy())
        for b in range(len(arrs[3])):
            np.testing.assert_array_equal(tbits[b, : arrs[3][b]], wtb[b, : arrs[3][b]].numpy())
    # the chain's walk: matches to column 15, then one insertion run over
    # columns 16-55, across the slice boundaries at 16, 32 and 48
    tape, tlen = PD.poa_traceback_plain(wtb, t[1], wk, t[5])
    ops, vids = PD.unpack_tape(tape[0, : tlen[0]].numpy()[::-1])
    assert "".join("MID"[o] for o in ops[:15]) == "M" * 15
    assert "".join("MID"[o] for o in ops[15:55]) == "I" * 40


def test_column_split_model_16_slices_of_1024():
    """W 16,384 as the kernel cuts it there: 16 slices of 1,024 columns.
    A random batch, and a chain whose match run ends at column 1,023 (the
    last of the first slice) and whose insertion of 2,100 bases crosses
    the boundaries at 1,024, 2,048 and 3,072."""
    W, n_slices = 16384, 16
    cases = [random_poa_batch(916, 2, 40, 4, W - 1, far_frac=0.3),
             _chain_batch(W, 1023, 2100, V=1100, B=1)]
    for arrs in cases:
        init_row = PD.make_init_row(W - 1)
        score, sink, tbits = _split_model(arrs, init_row, n_slices)
        t = [torch.from_numpy(a) for a in arrs]
        ws, wk, wtb = PD.poa_dp_plain(*t, torch.from_numpy(init_row))
        assert np.array_equal(score.view(np.int32), ws.numpy().view(np.int32))
        np.testing.assert_array_equal(sink, wk.numpy())
        for b in range(len(arrs[3])):
            np.testing.assert_array_equal(tbits[b, : arrs[3][b]], wtb[b, : arrs[3][b]].numpy())
    tape, tlen = PD.poa_traceback_plain(wtb, t[1], wk, t[5])
    ops, vids = PD.unpack_tape(tape[0, : tlen[0]].numpy()[::-1])
    walk = "".join("MID"[o] for o in ops)
    assert walk == "M" * 1023 + "I" * 2100 + "M" * 77


# ---------------------------------------------------------------------------
# routing and the source's sizes


def test_each_width_takes_its_kernel():
    calls = []
    real = PD.poa_dp_tb, PD.poa_dp_tb_cluster

    def spy(name, fn):
        return lambda *a: calls.append(name) or fn(*a)

    PD.poa_dp_tb, PD.poa_dp_tb_cluster = (spy(n, f) for n, f in zip(("K6", "K8"), real))
    before = kernels.launch_counts()
    try:
        for W in (128, 384, 512, 1024, 2048):
            arrs = [torch.from_numpy(a) for a in random_poa_batch(W, 2, 24, 2, W - 1)]
            score, tape, tlen = PD.dp_and_traceback(*arrs, torch.from_numpy(PD.make_init_row(W - 1)))
            assert tape.shape == (2, 24 + W + 1) and (tlen > 0).all()
    finally:
        PD.poa_dp_tb, PD.poa_dp_tb_cluster = real
    assert calls == ["K6", "K8", "K8", "K8", "K8"]  # 384 runs padded to 512
    assert kernels.launch_counts() == before


def test_every_width_routes_to_a_redesigned_kernel():
    """Every row width up to 16,384, off the ladder too, runs on K6 or K8
    (global) and K7 or K9 (local) at the narrowest width they take that
    holds it, and wider rows are refused."""
    assert PD.ROUTE_WIDTHS == (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)
    for W in range(1, 16385):
        kernel, w = PD.global_route(W)
        local, lw = PD.local_route(W)
        assert w == lw == min(x for x in PD.ROUTE_WIDTHS if x >= W)
        assert kernel == ("poa_dp_tb" if w <= 256 else "poa_dp_tb_cluster")
        assert local == ("poa_local_warp" if w <= 256 else "poa_local_cluster")
    assert PD.ROUTE_WIDTHS[:4] == PD.TB_WIDTHS == PD.LOCAL_WARP_WIDTHS
    assert PD.ROUTE_WIDTHS[4:] == PD.CLUSTER_WIDTHS
    for route in (PD.global_route, PD.local_route):
        with pytest.raises(ValueError):
            route(16385)
    calls = []
    names = ("poa_dp_tb", "poa_dp_tb_cluster", "poa_local_warp", "poa_local_cluster")
    real = {n: getattr(PD, n) for n in names}
    try:
        for n, fn in real.items():
            setattr(PD, n, (lambda n, fn: lambda *a, **k: calls.append(n) or fn(*a, **k))(n, fn))
        for W in (20, 100, 300, 640, 1500, 3000, 9000):
            arrs = [torch.from_numpy(a) for a in random_poa_batch(W, 2, 16, 2, W - 1)]
            init = torch.from_numpy(PD.make_init_row(W - 1))
            _s, tape, _tl = PD.dp_and_traceback(*arrs, init)
            local = PD.poa_local(*(arrs[i] for i in (0, 1, 3, 4, 5)))
            assert tape.shape == (2, 16 + W + 1) and local[1].shape == (2, W)
    finally:
        for n, fn in real.items():
            setattr(PD, n, fn)
    assert calls == ["poa_dp_tb", "poa_local_warp"] * 2 + [
        "poa_dp_tb_cluster", "poa_local_cluster"] * 5


@pytest.mark.parametrize("L", [300, 9000])
def test_off_ladder_rows_run_padded(L):
    """A row of L + 1 columns off the ladder (l_w 384 or 9,088 under the
    lane-padded contract) runs padded to 512 or 16,384: the padded plain
    pair's score, best sink, tbits over the first columns and walk equal
    the unpadded pair's, and the route equals JAX ``poa_global_kernel``
    (its Pallas kernel in interpret mode at 384; its XLA scan at the
    unpadded width at 9,088, which its VMEM budget picks)."""
    V = 128
    arrs = random_poa_batch(400 + L, 4, V, 2, L)
    t = [torch.from_numpy(a) for a in arrs]
    init = torch.from_numpy(PD.make_init_row(L))
    W = L + 1
    kernel, w = PD.global_route(W)
    assert kernel == "poa_dp_tb_cluster" and w == (512 if L == 300 else 16384)
    q_w, init_w = PD.pad_row(t[4], init, w)
    ps, pk, ptb = PD.poa_dp_plain(*t[:4], q_w, t[5], init_w)
    us, uk, utb = PD.poa_dp_plain(*t, init)
    assert torch.equal(ps, us) and torch.equal(pk, uk)
    for b, n in enumerate(arrs[3]):
        assert torch.equal(ptb[b, :n, :W], utb[b, :n])
    ptape, ptl = PD.poa_traceback_plain(ptb, t[1], pk, t[5])
    utape, utl = PD.poa_traceback_plain(utb, t[1], uk, t[5])
    assert torch.equal(ptl, utl) and torch.equal(ptape[:, : V + W + 1], utape)
    vcodes, vpred, is_sink, nv, q, nq = arrs
    js, jtape, jtl = jax.device_get(JPD.poa_global_kernel(
        jnp.asarray(vcodes), jnp.asarray(vpred), jnp.asarray(is_sink != 0), jnp.asarray(nv),
        jnp.asarray(q), jnp.asarray(nq), jnp.asarray(init.numpy()), use_pallas=True))
    score, tape, tlen = PD.poa_global_kernel(*t, init)
    l_w = ((L + 1 + 127) // 128) * 128
    assert tape.shape == (4, V + l_w + 1)
    np.testing.assert_array_equal(score.numpy(), js)
    np.testing.assert_array_equal(tlen.numpy(), jtl)
    for b in range(4):
        np.testing.assert_array_equal(tape[b, : tlen[b]].numpy(),
                                      jtape[b, : jtl[b]].astype(np.int32))
    assert (tlen.numpy() > 0).all()


def test_kernel_source_sizes_match_the_wrapper():
    src = os.path.join(os.path.dirname(kernels.__file__), "csrc", "poa_dp_tb_cluster.cu")
    with open(src) as fh:
        text = fh.read()
    sizes = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (RING|PINS|SLICE|WIDE_SLICE|C|MAX_CTAS) = (\d+);", text)}
    assert sizes["RING"] == PD.TB_RING and sizes["PINS"] == PD.TB_PINS
    slice_, wide, ctas = sizes["SLICE"], sizes["WIDE_SLICE"], sizes["MAX_CTAS"]
    assert slice_ % (32 * sizes["C"]) == 0 and wide % (32 * sizes["C"]) == 0
    # the source's cta_cols: SLICE up to SLICE x MAX_CTAS columns, WIDE_SLICE above
    assert "return W <= SLICE * MAX_CTAS ? SLICE : WIDE_SLICE;" in text
    assert PD.CLUSTER_SLICE == {W: slice_ if W <= slice_ * ctas else wide
                                for W in PD.CLUSTER_WIDTHS}
    assert PD.CLUSTER_WIDTHS == tuple(slice_ * n for n in (1, 2, 4, 8, 16)) + (wide * ctas,)
    assert all(W // PD.CLUSTER_SLICE[W] in (1, 2, 4, 8, 16) for W in PD.CLUSTER_WIDTHS)
    assert "poa_dp_tb_cluster.cu" in kernels.SOURCES and "poa_dp_tb_cluster" in kernels.LAUNCHES


def test_probe_edits_the_kernel_source():
    """The probe's variants (``poa_cluster_probe``) each change what they
    name, and its entry point refuses to run without a card."""
    from vgaligner_tpu_torch import poa_cluster_probe

    src = os.path.join(os.path.dirname(kernels.__file__), "csrc", "poa_dp_tb_cluster.cu")
    with open(src) as fh:
        text = fh.read()
    var = poa_cluster_probe.variant_sources(text)
    assert var["slice512"] == text
    for name, cols in (("slice256", 256), ("slice1024", 1024)):
        assert f"constexpr int SLICE = {cols};" in var[name] and var[name] != text
    assert "if (nqc < jw" in text and "if (nqc < jw" not in var["nowalk"]
    with pytest.raises(ValueError):
        poa_cluster_probe.variant_sources(text.replace("SLICE = 512", "SLICE = 64"))
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            poa_cluster_probe.main([])
