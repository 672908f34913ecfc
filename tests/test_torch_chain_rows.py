"""The fast chaining kernel's row rule, checked on the CPU.

kernels/csrc/chain_dp.cu stops each read after its last valid anchor
(writing k*1000 and -1 to every later row), has a producer warp compute
the f-independent pair terms of each block of RB rows ahead of the rows,
lets the 32 lanes of a consumer warp take a row's pairs (lane l: j = i-1-l, i-33-l, ...), each keeping its first
pair at its max, and reduces them in two steps: the max of p, then the
max of j among the lanes at that max.  ``_row_rule`` repeats that in
numpy, lane by lane; it must equal ``chain_dp_plain`` and the JAX
package's Pallas kernel ``chain_dp_pallas`` (interpret mode) bit for bit,
on reads whose valid anchors are a prefix, are scattered, end early or
are absent.  Tolerance 0: every value is an integer.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vgaligner_tpu.ops.chain_pallas import chain_dp_pallas

from vgaligner_tpu_torch import kernels
from vgaligner_tpu_torch.ops import chain as C
from vgaligner_tpu_torch.testing import one_torch_thread

K = 11
LANES = 32  # lanes a read in chain_dp.cu
NEGI = -(1 << 30)
NONE = np.iinfo(np.int32).min
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


def _row_rule(qb, tb, te, valid, k, bw, max_gap=1000, rb=None):
    """The kernel's rule in numpy, all reads at once -> (f, pred,
    curr_max, rows run)."""
    B, A = qb.shape
    rb = rb or max(1, 640 // bw)
    k_i = k * 1000
    idx = np.arange(A)
    n_g = np.where(valid, idx + 1, 0).max(axis=1)  # rows to the last valid anchor
    f = np.full((B, A), k_i, dtype=np.int64)
    pred = np.full((B, A), -1, dtype=np.int64)
    cmax = np.zeros(B, dtype=np.int64)
    n_lanes = -(-bw // LANES) * LANES
    r = np.arange(n_lanes)
    q64, t64, e64 = (x.astype(np.int64) for x in (qb, tb, te))
    for i0 in range(0, int(n_g.max(initial=0)), rb):
        rows = np.arange(i0, min(i0 + rb, A))
        # the block's terms: [B, rows, lanes-padded window]
        j = rows[:, None] - 1 - r[None, :]
        jc = np.clip(j, 0, A - 1)
        ql = q64[:, rows, None] - q64[:, jc]
        tl = np.minimum(np.abs(t64[:, rows, None] - t64[:, jc]), np.abs(e64[:, rows, None] - e64[:, jc]))
        gap = np.abs(ql - tl)
        ok = ((j >= 0) & (r[None, :] < bw))[None] & valid[:, rows, None] & valid[:, jc]
        ok &= (ql > 0) & (e64[:, jc] < e64[:, rows, None]) & (gap <= max_gap)
        gc = C.gap_cost_scaled_i32_plain(torch.from_numpy(np.clip(gap, 0, max_gap)), k).numpy()
        terms = np.where(ok, np.minimum(np.minimum(ql, tl), k) * 1000 - gc, NONE)
        for t, i in enumerate(rows):
            live = (i < n_g) & valid[:, i]
            p = np.where(terms[:, t] == NONE, NEGI, f[:, jc[t]] + terms[:, t])  # [B, lanes]
            lanes = p.reshape(B, -1, LANES)  # [B, pairs a lane, lane]
            at = lanes.argmax(axis=1)  # the lane's first pair at its max: its largest j
            best = np.take_along_axis(lanes, at[:, None], 1)[:, 0]
            bj = np.where(best == NEGI, -1, i - 1 - (at * LANES + np.arange(LANES)))
            m = best.max(axis=1)
            mj = np.where(best == m[:, None], bj, -1).max(axis=1)
            imp = live & (m > k_i)
            f[:, i] = np.where(imp, m, k_i)
            pred[:, i] = np.where(imp, mj, -1)
            cmax = np.where(live, np.maximum(cmax, m), cmax)
    return f.astype(np.int32), pred.astype(np.int32), cmax.astype(np.int32), n_g


def _sorted(seed, B, A, n_valid=130):
    """Sorted anchors with about ``n_valid`` valid a read."""
    rng = np.random.default_rng(seed)
    qb = rng.integers(0, 90, (B, A)).astype(np.int32)
    tb = rng.integers(0, 2 * A, (B, A)).astype(np.int64)
    valid = rng.random((B, A)) < n_valid / A
    _o, qb, tb, te, valid = C.sort_anchors(*(torch.from_numpy(x) for x in (qb, tb, tb + K, valid)))
    return [x.numpy().astype(np.int32) if x.dtype != torch.bool else x.numpy()
            for x in (qb, tb, te, valid)]


def _scattered(seed, B, A, n_valid=130):
    """Target ends ascending, valid anchors scattered (not a prefix) over
    the first 400 rows, so every read ends on invalid rows."""
    rng = np.random.default_rng(seed)
    te = (np.sort(rng.integers(0, 3 * A, (B, A)), axis=1) + K).astype(np.int32)
    qb = rng.integers(0, 90, (B, A)).astype(np.int32)
    valid = rng.random((B, A)) < n_valid / 400
    valid[:, 400:] = False
    return [qb, te - K, te, valid]


def _pallas(qb, tb, te, valid, bw):
    B = qb.shape[0]
    b_pad = -(-B // 128) * 128
    pad = lambda x, fill: jnp.pad(jnp.asarray(x), ((0, b_pad - B), (0, 0)),  # noqa: E731
                                  constant_values=fill)
    with jax.enable_x64(False):
        out = chain_dp_pallas(pad(qb, 0), pad(tb, 0), pad(te, 0), pad(valid, False), K, bw, 1000,
                              interpret=True)
    return [np.asarray(x)[:B] for x in out]


@pytest.mark.parametrize("layout", ["sorted", "scattered"])
def test_row_rule_matches_plain_and_pallas(layout):
    args = (_sorted if layout == "sorted" else _scattered)(3, 24, 512)
    args[3][1] = False  # a read with no valid anchor
    args[3][2] = False
    args[3][2, 7] = True  # and one with a single one
    f, pred, cmax, n_g = _row_rule(*args, K, 50)
    want = C.chain_dp_plain(*(torch.from_numpy(x) for x in args), K, 50, 1000)
    pal = _pallas(*args, 50)
    for name, got, w, p in zip(("f", "pred", "curr_max"), (f, pred, cmax), want, pal):
        np.testing.assert_array_equal(got, w.numpy(), err_msg=name)
        np.testing.assert_array_equal(got, p, err_msg=name)
    assert 100 <= args[3].sum(axis=1).mean() <= 160 and (pred >= 0).sum() > 500
    assert n_g[1] == 0 and n_g[2] == 8 and n_g.max() < 512  # every read stops early


@pytest.mark.parametrize("bw", [20, 50, 100])
def test_row_rule_bands_and_term_blocks(bw):
    """Bands under one pair a lane, near two (the CLI's 50) and up to
    four; term blocks of one row, the kernel's RB, and more rows than a
    read has."""
    args = _scattered(10 + bw, 6, 512, n_valid=200)
    want = C.chain_dp_plain(*(torch.from_numpy(x) for x in args), K, bw, 1000)
    for rb in (1, None, 600):
        for name, got, w in zip(("f", "pred", "curr_max"), _row_rule(*args, K, bw, rb=rb), want):
            np.testing.assert_array_equal(got, w.numpy(), err_msg=f"{name} rb={rb}")


def test_two_step_reduction_is_the_larger_j_tie_rule():
    """Equal p on many pairs of a row: the larger j wins, as in the
    plain twin's ``r_star``; a dense diagonal makes every pair tie."""
    A = 256
    qb = np.tile(np.arange(A, dtype=np.int32) % 80, (3, 1))
    tb = np.tile(np.arange(A, dtype=np.int32) % 80, (3, 1)) + 100
    args = [qb, tb, tb + K, np.ones((3, A), bool)]
    f, pred, _cmax, _n = _row_rule(*args, K, 50)
    wf, wp, _wc = C.chain_dp_plain(*(torch.from_numpy(x) for x in args), K, 50, 1000)
    np.testing.assert_array_equal(pred, wp.numpy())
    np.testing.assert_array_equal(f, wf.numpy())
    assert (pred[:, 1:80] == np.arange(80)[None, : 79]).all()  # the nearest of the tied


def test_scores_stay_inside_i32_at_the_mappers_cap():
    """f <= k * 1000 * (A + 1) at A 65,536 and a pair's term is above
    -(10 k max_gap + 500 log2(max_gap) + 1): both far from 2^31."""
    assert K * 1000 * (65536 + 1) < 2 ** 31 - K * 1000
    low = -(10 * K * 1000 + 500 * np.log2(1000) + 1)
    # f >= 0, so p = f + term >= low: above NEGI (no tie with "none") and
    # every term above the INT_MIN that marks a pair that is not ok
    assert NEGI < low and NONE < low


def test_kernel_source_keeps_the_plan():
    src = os.path.join(os.path.dirname(kernels.__file__), "csrc", "chain_dp.cu")
    with open(src) as fh:
        text = fh.read()
    assert re.search(r"constexpr int READS = 2;", text) and "bar.sync" in text
    assert text.count("__reduce_max_sync") == 3  # the last valid row, the max of p, its j
    assert "640 / bw" in text
    assert "chain_dp.cu" in kernels.SOURCES
