"""The exact (f64) chaining kernel's row rule, checked on the CPU.

kernels/csrc/chain_dp_exact.cu stops each read after its last valid
anchor, lets the 32 lanes of a warp take the pairs of a row, compares
rr (the rounded milli-unit score before its divide by 1000) with the
larger-j tie rule, and divides only the row's winner.  ``_row_rule``
repeats that in numpy, lane by lane and butterfly step by step; it must
equal ``chain_dp_exact_plain`` and JAX's exact ``chain_scores`` bit for
bit (f64 compared as int64 patterns), on sorted reads, reads whose valid
anchors are not a prefix, and reads with no valid anchor, at bands
narrower than, near and wider than the warp.  The divide
once is exact because a -> fl(a / 1000) is strictly increasing on the
integers |a| <= 2^42, checked here at and near both ends and on 10^6
random integers.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vgaligner_tpu.ops import chain as jax_chain

from vgaligner_tpu_torch.ops import chain as C
from vgaligner_tpu_torch.testing import one_torch_thread

K = 11
NEG = -np.finfo(np.float64).max
LANES = 32  # lanes a read in chain_dp_exact.cu
BANDS = [20, 50, 100]  # under one pair a lane, up to two (the CLI's 50), up to four
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


def _row_rule(qb, tb, te, valid, k, bw, table):
    """The kernel's rule in numpy -> (f, pred, curr_max, max |rr| seen)."""
    B, A = qb.shape
    max_gap = len(table) - 1
    f = np.full((B, A), float(k))
    pred = np.full((B, A), -1, dtype=np.int32)
    cmax = np.zeros(B)
    rr_max = 0.0
    for b in range(B):
        idx = np.nonzero(valid[b])[0]
        n = int(idx[-1]) + 1 if len(idx) else 0  # rows after the last valid anchor: k, -1
        cm = np.float64(0.0)
        for i in range(n):
            if not valid[b, i]:
                continue
            lane_best = []
            for gl in range(LANES):
                best, bj = np.float64(NEG), -1
                for r in range(gl, bw, LANES):
                    j = i - 1 - r
                    if j < 0 or not valid[b, j]:
                        continue
                    ql = int(qb[b, i]) - int(qb[b, j])
                    tl = min(abs(int(tb[b, i]) - int(tb[b, j])), abs(int(te[b, i]) - int(te[b, j])))
                    gap = abs(ql - tl)
                    if ql <= 0 or te[b, j] >= te[b, i] or gap > max_gap:
                        continue
                    x = (np.float64(f[b, j]) + np.float64(min(ql, tl, k))) - table[gap]
                    y = x * np.float64(1000.0)
                    rr = np.floor(y + 0.5) if y >= 0 else np.ceil(y - 0.5)
                    rr_max = max(rr_max, abs(float(rr)))
                    if rr > best or (rr == best and j > bj):
                        best, bj = rr, j
                lane_best.append((best, bj))
            off = LANES // 2
            while off:
                nxt = []
                for gl in range(LANES):
                    (a, aj), (o, oj) = lane_best[gl], lane_best[gl ^ off]
                    nxt.append((o, oj) if o > a or (o == a and oj > aj) else (a, aj))
                lane_best = nxt
                off //= 2
            best, bj = lane_best[0]
            m = best / np.float64(1000.0) if bj >= 0 else np.float64(NEG)
            if m > k:
                f[b, i], pred[b, i] = m, bj
            cm = max(cm, m)
        cmax[b] = cm
    return f, pred, cmax, rr_max


def _anchors(seed, B, A, p_valid=0.85, all_invalid=()):
    rng = np.random.default_rng(seed)
    qb = rng.integers(0, 90, (B, A)).astype(np.int32)
    tb = rng.integers(0, 4 * A, (B, A)).astype(np.int64)
    valid = rng.random((B, A)) < p_valid
    valid[list(all_invalid)] = False
    return qb, tb, tb + K, valid


def _dense_diagonal(B, A):
    qb = np.tile(np.arange(A, dtype=np.int32) % 80, (B, 1))
    tb = np.tile(np.arange(A, dtype=np.int64) % 80, (B, 1)) + 100
    return qb, tb, tb + K, np.ones((B, A), bool)


def _unsorted_valid(seed, B, A):
    """Target ends ascending, but the valid anchors scattered: valid
    slots are not a prefix, and read 0 ends on invalid ones."""
    rng = np.random.default_rng(seed)
    te = np.sort(rng.integers(0, 3 * A, (B, A)), axis=1).astype(np.int64) + K
    qb = rng.integers(0, 90, (B, A)).astype(np.int32)
    valid = rng.random((B, A)) < 0.5
    valid[0, -7:] = False
    return qb, te - K, te, valid


CASES = {
    "random": lambda: _anchors(0, 8, 64),
    "random_long": lambda: _anchors(3, 3, 400),
    "some_reads_all_invalid": lambda: _anchors(5, 6, 96, p_valid=0.6, all_invalid=(1, 4)),
    "dense_diagonal": lambda: _dense_diagonal(3, 128),
}


@pytest.mark.parametrize("bw", BANDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_row_rule_matches_plain_and_jax(case, bw):
    qb, tb, te, valid = CASES[case]()
    table = C.make_gap_cost_table(K, 1000)
    want = jax_chain.chain_scores(jnp.asarray(qb), jnp.asarray(tb), jnp.asarray(te),
                                  jnp.asarray(valid), jnp.asarray(table), seed_length=K,
                                  bandwidth=bw, precision="exact")
    s = C.chain_scores(*(torch.from_numpy(x) for x in (qb, tb, te, valid)), table,
                       seed_length=K, bandwidth=bw, precision="exact")
    args = [x.numpy() for x in (s.qb, s.tb, s.te, s.valid)]
    f, pred, cmax, rr_max = _row_rule(*args, K, bw, table)
    for name, got in (("f", f), ("pred", pred), ("curr_max", cmax)):
        plain = getattr(s, name).numpy()
        jx = np.asarray(getattr(want, name))
        if got.dtype == np.float64:
            got, plain, jx = (a.view(np.int64) for a in (got, plain, jx))
        np.testing.assert_array_equal(got, plain, err_msg=name)
        np.testing.assert_array_equal(got, jx, err_msg=name)
    assert (pred >= 0).any()
    A = qb.shape[1]
    assert C.exact_divide_once(A, K, table)
    assert rr_max + 1 < 1000.0 * (A * (K + 1) + 2 * K + np.abs(table).max())


@pytest.mark.parametrize("bw", BANDS)
def test_row_rule_on_unsorted_valid_matches_plain(bw):
    qb, tb, te, valid = _unsorted_valid(2, 6, 150)
    table = C.make_gap_cost_table(K, 1000)
    wf, wp, wc = C.chain_dp_exact_plain(*(torch.from_numpy(x) for x in (qb, tb, te, valid)),
                                        K, bw, table)
    f, pred, cmax, _ = _row_rule(qb, tb, te, valid, K, bw, table)
    np.testing.assert_array_equal(f.view(np.int64), wf.numpy().view(np.int64))
    np.testing.assert_array_equal(pred, wp.numpy())
    np.testing.assert_array_equal(cmax.view(np.int64), wc.numpy().view(np.int64))
    assert (pred >= 0).any() and not valid[0, -7:].any()


@pytest.mark.parametrize("lo,hi", [(2 ** 42 - 300_000, 2 ** 42), (-(2 ** 42), -(2 ** 42) + 300_000),
                                   (-300_000, 300_000)])
def test_divide_by_1000_strictly_increasing_near(lo, hi):
    a = np.arange(lo, hi + 1, dtype=np.int64).astype(np.float64)
    assert (a == np.arange(lo, hi + 1)).all()  # exact doubles
    q = a / np.float64(1000.0)
    assert (np.diff(q) > 0).all()


def test_divide_by_1000_strictly_increasing_on_random_integers():
    rng = np.random.default_rng(0)
    a = np.unique(rng.integers(-(2 ** 42), 2 ** 42, 1_000_000)).astype(np.float64)
    assert (np.diff(a / np.float64(1000.0)) > 0).all()


def test_divide_once_bound():
    table = C.make_gap_cost_table(K, 1000)
    assert C.exact_divide_once(256, K, table) and C.exact_divide_once(65536, K, table)
    assert not C.exact_divide_once(256, K, table * 1e9)
    assert not C.exact_divide_once(256, K, -table)  # f could grow by |gcost| a row
    assert not C.exact_divide_once(256, K, np.concatenate([table[:1], -table[1:2]]))
    assert not C.exact_divide_once((1 << 21) + 1, 0, table * 0)  # j past the key's 21 bits
    assert C.exact_divide_once(1 << 21, 0, table * 0)
    assert not C.exact_divide_once(1 << 31, K, table)
    bad = table.copy()
    bad[5] = np.inf
    assert not C.exact_divide_once(256, K, bad)


def test_gap_table_uploaded_once_per_table():
    table = C.make_gap_cost_table(K, 1000)
    cpu = torch.device("cpu")
    first = C._device_gap_table(table, K, cpu)
    assert C._device_gap_table(table.copy(), K, cpu) is first
    changed = C._device_gap_table(table * 2, K, cpu)
    assert changed is not first and torch.equal(changed, torch.from_numpy(table * 2))
    assert C._device_gap_table(C.make_gap_cost_table(K, 500), K, cpu).shape == (501,)


def test_cpu_route_ignores_kernel_options():
    """On the CPU the wrapper is the plain twin, whichever divide path
    the table would take on the card."""
    qb, tb, te, valid = _anchors(7, 4, 80)
    t = [torch.from_numpy(x) for x in (qb, tb, te, valid)]
    for table in (C.make_gap_cost_table(K, 1000), -C.make_gap_cost_table(K, 1000) * 1e8):
        want = C.chain_dp_exact_plain(*t, K, 50, table)
        for g, w in zip(C.chain_dp_exact(*t, K, 50, table), want):
            assert torch.equal(g, w)


def _key(rr, j):
    """chain_dp_exact.cu's row key of a pair: (rr + 2^41 + 1) << 21 | j."""
    return ((int(rr) + (1 << 41) + 1) << 21) | int(j)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_row_key_order_is_the_tie_rule(seed):
    """The largest key is the pair with the largest rr, the larger j on a
    tie; it decodes to that rr and j, stays below 2^63 and above 0."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        n = int(rng.integers(1, 60))
        rr = rng.integers(-(2 ** 41) + 1, 2 ** 41 - 1, n)
        rr[rng.random(n) < 0.5] = rr[0]  # ties
        j = rng.choice(1 << 21, n, replace=False)
        best = max(range(n), key=lambda t: (rr[t], j[t]))
        keys = [_key(a, b) for a, b in zip(rr, j)]
        top = max(keys)
        assert top == keys[best] and 0 < min(keys) and top < 2 ** 63
        assert (top >> 21) - (1 << 41) - 1 == rr[best] and top & ((1 << 21) - 1) == j[best]
