"""The exact (f64) chaining kernel's row rule, checked on the CPU.

kernels/csrc/chain_dp_exact.cu stops each read after its last valid
anchor, computes the f-independent pair terms of each block of RB rows
(the f64 gap cost and a 16-bit match length, 0xffff for a pair that is
not ok) from an anchor window copied from rows i0 - bw, into the other
of two buffers while the rows of the block before run (a producer warp
and a consumer warp), lets the 32 lanes of a warp take the pairs of a
row, packs each pair into the key (rr + 2^41 + 1) << 21 | j, rr the
rounded milli-unit score before its divide by 1000, reduces the keys in
two steps (the high word, then the low word among the lanes at its
maximum) and divides only the row's winner.  ``_row_rule`` repeats that
in numpy, block by block and lane by lane; it must equal
``chain_dp_exact_plain`` and JAX's exact ``chain_scores`` bit for bit
(f64 compared as int64 patterns), on sorted reads, reads whose valid
anchors are not a prefix, reads with no valid anchor and reads whose
rows to the last valid anchor are a multiple of the block, at bands
narrower than, near and wider than the warp and at blocks of one row,
the kernel's RB and more rows than a read has.  The divide once is exact
because a -> fl(a / 1000) is strictly increasing on the integers |a| <=
2^42, checked here at and near both ends and on 10^6 random integers.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vgaligner_tpu.ops import chain as jax_chain

from vgaligner_tpu_torch import kernels
from vgaligner_tpu_torch.ops import chain as C
from vgaligner_tpu_torch.testing import one_torch_thread

K = 11
NEG = -np.finfo(np.float64).max
LANES = 32  # lanes a read in chain_dp_exact.cu
NONE16 = 0xFFFF  # the match length of a pair that is not ok
KEY_OFF = (1 << 41) + 1
BANDS = [20, 50, 100]  # under one pair a lane, up to two (the CLI's 50), up to four
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


def _block_terms(qb, tb, te, valid, i0, rows, k, bw, table):
    """One read's pair terms for rows i0 .. i0 + rows - 1, from the window
    of rows i0 - bw .. i0 + rows - 1 (rows below 0 invalid) -> (gcost
    [rows, bw] f64, mlen [rows, bw] with NONE16 for a pair not ok)."""
    max_gap = len(table) - 1
    x = np.arange(i0 - bw, i0 + rows)
    inside = x >= 0
    xc = np.where(inside, x, 0)
    wq, wt, we = (np.where(inside, a[xc].astype(np.int64), 0) for a in (qb, tb, te))
    wv = inside & valid[xc]
    ii = bw + np.arange(rows)[:, None]  # row i0 + rr at ii in the window
    jj = ii - 1 - np.arange(bw)[None, :]
    ql = wq[ii] - wq[jj]
    tl = np.minimum(np.abs(wt[ii] - wt[jj]), np.abs(we[ii] - we[jj]))
    gap = np.abs(ql - tl)
    ok = wv[ii] & wv[jj] & (wq[jj] < wq[ii]) & (we[jj] < we[ii]) & (gap <= max_gap)
    gcost = table[np.where(ok, gap, 0)]
    mlen = np.where(ok, np.minimum(np.minimum(ql, tl), k), NONE16)
    return gcost, mlen


def _row_rule(qb, tb, te, valid, k, bw, table, rb=None):
    """The kernel's rule in numpy -> (f, pred, curr_max, max |rr| seen)."""
    B, A = qb.shape
    rb = rb or max(1, 640 // bw)
    f = np.full((B, A), float(k))
    pred = np.full((B, A), -1, dtype=np.int32)
    cmax = np.zeros(B)
    rr_max = 0.0
    n_lanes = -(-bw // LANES) * LANES
    for b in range(B):
        idx = np.nonzero(valid[b])[0]
        n_g = int(idx[-1]) + 1 if len(idx) else 0  # rows after the last valid anchor: k, -1
        nblk = -(-n_g // rb)
        bufs = [None, None]
        block = lambda blk: _block_terms(qb[b], tb[b], te[b], valid[b], blk * rb,  # noqa: E731
                                         min(rb, n_g - blk * rb), k, bw, table)
        if nblk:
            bufs[0] = block(0)
        cm = np.float64(0.0)
        for blk in range(nblk):
            if blk + 1 < nblk:  # the producer fills the other buffer first
                bufs[(blk + 1) & 1] = block(blk + 1)
            gcost, mlen = bufs[blk & 1]
            for rr in range(gcost.shape[0]):
                i = blk * rb + rr
                j = i - 1 - np.arange(bw)
                fj = f[b, np.maximum(j, 0)]
                x = (fj + mlen[rr].astype(np.float64)) - gcost[rr]
                y = x * np.float64(1000.0)
                a = np.where(y >= 0, np.floor(y + 0.5), np.ceil(y - 0.5))
                ok = mlen[rr] != NONE16
                if ok.any():
                    rr_max = max(rr_max, float(np.abs(a[ok]).max()))
                keys = np.where(ok, ((a.astype(np.int64) + KEY_OFF) << 21) | np.where(j >= 0, j, 0), 0)
                lane = np.zeros(n_lanes, dtype=np.int64)
                lane[:bw] = keys
                lane = lane.reshape(-1, LANES).max(axis=0)  # each lane's pairs r = l, l + 32, ...
                hi = (lane >> 32).max()
                lo = np.where(lane >> 32 == hi, lane & 0xFFFFFFFF, 0).max()
                key = int((hi << 32) | lo)
                m = np.float64((key >> 21) - KEY_OFF) / np.float64(1000.0) if key else np.float64(NEG)
                if m > k:
                    f[b, i], pred[b, i] = m, key & ((1 << 21) - 1)
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


def _layout(name, seed, B=5, A=640):
    """Anchors of a layout: ``sorted`` (a read with no valid anchor),
    ``scattered`` (target ends ascending, valid anchors not a prefix) and
    ``rows_multiple_of_rb`` (valid prefixes of 600 rows, none, 1, 12 and
    600: a multiple of a block of 1, 12 and 600 rows)."""
    if name == "sorted":
        return _anchors(seed, B, A, all_invalid=(1,))
    if name == "scattered":
        return _unsorted_valid(seed, B, A)
    rng = np.random.default_rng(seed)
    te = np.sort(rng.integers(0, 3 * A, (B, A)), axis=1).astype(np.int64) + K
    qb = np.sort(rng.integers(0, A // 2, (B, A)), axis=1).astype(np.int32)
    valid = np.zeros((B, A), bool)
    for b, n in enumerate((600, 0, 1, 12, 600)):
        valid[b, :n] = True
    return qb, te - K, te, valid


@pytest.mark.parametrize("rb", [1, None, 600])
@pytest.mark.parametrize("layout", ["sorted", "scattered", "rows_multiple_of_rb"])
def test_block_schedule_matches_plain_and_jax(layout, rb):
    """The producer's blocks of one row, the kernel's RB (12 at bw 50)
    and 600 rows, built from their windows into alternating buffers: the
    rows equal the plain twin on the anchors as given and, after the
    sort, JAX's exact chain_scores, bit for bit."""
    qb, tb, te, valid = _layout(layout, 21)
    table = C.make_gap_cost_table(K, 1000)
    t = [torch.from_numpy(x) for x in (qb, tb, te, valid)]
    want = C.chain_dp_exact_plain(*t, K, 50, table)
    got = _row_rule(qb, tb, te, valid, K, 50, table, rb=rb)
    for name, g, w in zip(("f", "pred", "curr_max"), got, want):
        w = w.numpy()
        if g.dtype == np.float64:
            g, w = g.view(np.int64), w.view(np.int64)
        np.testing.assert_array_equal(g, w, err_msg=f"{name} (as given)")
    jx = jax_chain.chain_scores(jnp.asarray(qb), jnp.asarray(tb), jnp.asarray(te),
                                jnp.asarray(valid), jnp.asarray(table), seed_length=K,
                                bandwidth=50, precision="exact")
    s = C.chain_scores(*t, table, seed_length=K, bandwidth=50, precision="exact")
    got = _row_rule(*(x.numpy() for x in (s.qb, s.tb, s.te, s.valid)), K, 50, table, rb=rb)
    for name, g in zip(("f", "pred", "curr_max"), got):
        w = np.asarray(getattr(jx, name))
        if g.dtype == np.float64:
            g, w = g.view(np.int64), w.view(np.int64)
        np.testing.assert_array_equal(g, w, err_msg=f"{name} (sorted, against JAX)")
    n_g = np.where(valid, np.arange(valid.shape[1]) + 1, 0).max(axis=1)
    assert (got[1] >= 0).any()
    if layout == "rows_multiple_of_rb":
        assert (n_g % (rb or 640 // 50) == 0).sum() >= 3
    else:
        assert (n_g == 0).any() or not valid[0, -7:].any()


def test_kernel_source_keeps_the_plan():
    """Two warps a read (a producer of pair terms and a consumer of rows)
    that meet at a named barrier of 64 threads with a constant id, two
    reads a block held to 64 registers (8 blocks an SM), the gap cost
    looked up by the producer, and RB = 640 / bw rows a block, as the
    rule above."""
    src = os.path.join(os.path.dirname(kernels.__file__), "csrc", "chain_dp_exact.cu")
    with open(src) as fh:
        text = fh.read()
    assert "constexpr int READS = 2;" in text and "THREADS = READS * 64;" in text
    assert re.search(r"__launch_bounds__\(THREADS, MIN_BLOCKS\)", text)
    assert "constexpr int MIN_BLOCKS = 8;" in text
    assert '"bar.sync 1, 64;"' in text and '"bar.sync 2, 64;"' in text
    assert "bar.sync %0" not in text  # an id in a register reserves all 16 barriers
    assert "__ldg(gap_table + (ok ? gap : 0))" in text and "NONE16 = 0xffffu" in text
    # the last valid row, the key's high word and its low word
    assert text.count("__reduce_max_sync") == 3
    assert text.count("max(1, 640 / bw)") == 1 and "rows a term block: 12 at bw 50" in text
    assert "chain_dp_exact.cu" in kernels.SOURCES and "chain_dp_exact" in kernels.LAUNCHES


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


def test_probe_takes_an_earlier_exact_kernel():
    """``kernel_probe --old-chain-dp-exact PATH`` is a flag of its own
    (``--old-chain-dp`` no longer required beside it), and the probe
    refuses to run without a card."""
    from vgaligner_tpu_torch import kernel_probe

    src = os.path.join(os.path.dirname(kernels.__file__), "csrc", "chain_dp_exact.cu")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a CUDA GPU"):
            kernel_probe.main(["--old-chain-dp-exact", src])
    with pytest.raises(SystemExit):
        kernel_probe.main(["--old-chain-dp-exact"])  # the flag takes a path
    assert "--old-chain-dp-exact PATH" in kernel_probe.__doc__


def test_probe_edits_one_design_choice_a_copy():
    """``kernel_probe``'s copies of chain_dp_exact.cu each differ from it
    in one edit, and an edit whose text is gone raises."""
    from vgaligner_tpu_torch import kernel_probe

    src = os.path.join(os.path.dirname(kernels.__file__), "csrc", "chain_dp_exact.cu")
    with open(src) as fh:
        text = fh.read()
    var = kernel_probe.exact_variant_sources(text)
    assert set(var) == {"exact_regbar", "exact_nolb", "exact_ringload", "exact_rb6",
                        "exact_rb24"}
    for name, (old, new) in kernel_probe._EXACT_EDITS.items():
        edited = var[f"exact_{name}"]
        assert edited != text and edited.replace(new, old) == text
    assert 'bar.sync %0' in var["exact_regbar"] and "MIN_BLOCKS)" not in var["exact_nolb"]
    with pytest.raises(ValueError):
        kernel_probe.exact_variant_sources(text.replace("640 / bw", "320 / bw"))
