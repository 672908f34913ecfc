"""Chaining: the banded DP over a read's anchors and its backtrack.

The recurrence of rs-vgaligner's chain_anchors / score_anchor
(chain.rs:274-655), forward anchors only: anchors stably sorted by
target end; anchor i takes the best strictly improving predecessor
among the ``bandwidth`` anchors before it, the later one on a tie;
``curr_max`` is the best proposal of the read.  A chain starts at each
anchor, last first, whose score equals ``curr_max`` and that has a
predecessor; walking back clears each predecessor, and a chain of at
least ``min_anchors`` anchors is kept.

Three arithmetics, each computed over a block of reads with numpy:
  * ``exact``: f64, each proposal rounded half away from zero to three
    decimals;
  * ``fast``: int32 milli-units, the gap cost rounded once as
    10 k g + floor(500 log2(g) + 0.5), log2 by a degree-7 polynomial in
    float32 with one rounding an operation;
  * ``int16``: ``fast`` in int16 deci-units (gap cost rounded to a
    tenth), the step below int32 that fits a 100 bp read's scores.
The last serves nothing: it is the control of the comparison.
"""

from __future__ import annotations

from typing import List

import numpy as np

_LOG2_COEF = (
    8.121406e-07, 1.4426336, -0.72020257, 0.47172138,
    -0.32148254, 0.18865165, -0.07592032, 0.01459849,
)
SCALE = {"fast": 1000, "int16": 10}
INT_TYPE = {"fast": np.int32, "int16": np.int16}


def gap_cost_exact(gap: np.ndarray, k: int) -> np.ndarray:
    g = gap.astype(np.float64)
    with np.errstate(divide="ignore"):
        cost = 0.01 * float(k) * g + 0.5 * np.log2(g)
    return np.where(gap == 0, 0.0, cost)


def log2_poly_f32(g: np.ndarray) -> np.ndarray:
    gf = g.astype(np.float32)
    bits = gf.view(np.int32)
    e = ((bits >> 23) & 0xFF) - 127
    x = ((bits & 0x7FFFFF) | (127 << 23)).astype(np.int32).view(np.float32)
    t = x - np.float32(1.0)
    acc = np.full_like(t, np.float32(_LOG2_COEF[7]))
    for d in range(6, -1, -1):
        acc = acc * t
        acc = acc + np.float32(_LOG2_COEF[d])
    return e.astype(np.float32) + acc


def gap_cost_scaled(gap: np.ndarray, k: int, precision: str) -> np.ndarray:
    """round(scale * (0.01 k g + 0.5 log2 g)) as an integer."""
    g = gap.astype(np.int32)
    if precision == "fast":
        lg = log2_poly_f32(g) * np.float32(500.0)
        lg = np.floor(lg + np.float32(0.5)).astype(np.int32)
        cost = g * np.int32(10 * k) + lg
    else:
        cost = np.floor(SCALE[precision] * gap_cost_exact(g, k) + 0.5).astype(np.int32)
    return np.where(g == 0, 0, cost).astype(np.int32)


def chain_dp(rid, qb_f, tb_f, te_f, off, k: int, bandwidth: int, max_gap: int,
             precision: str):
    """DP over a block of reads' anchors (flat, generation order, read
    ``r`` at ``off[r]:off[r + 1]``) -> (flat index of each sorted slot
    [B, A], f, pred, curr_max [B], valid [B, A]), each read's anchors
    stably sorted by target end."""
    B = len(off) - 1
    A = int(np.diff(off).max(initial=0))
    order = np.lexsort((te_f, rid))  # stable: ties keep generation order
    r_o = rid[order]
    pos = np.arange(len(order)) - off[r_o]
    qb = np.zeros((B, A), np.int64)
    tb = np.zeros((B, A), np.int64)
    te = np.full((B, A), np.iinfo(np.int64).max, np.int64)
    valid = np.zeros((B, A), bool)
    src = np.full((B, A), -1, np.int64)
    qb[r_o, pos], tb[r_o, pos], te[r_o, pos] = qb_f[order], tb_f[order], te_f[order]
    valid[r_o, pos] = True
    src[r_o, pos] = order
    exact = precision == "exact"
    g_all = np.arange(max_gap + 1)
    if exact:
        ft = np.float64
        low = np.finfo(ft).min
        kf = ft(k)
        gtab = gap_cost_exact(g_all, k)
        f = np.full((B, bandwidth + A), np.finfo(ft).min, ft)
        f[:, bandwidth:] = kf
        cmax = np.zeros(B, ft)
    else:
        dt = INT_TYPE[precision]
        kf = dt(k * SCALE[precision])
        gtab = gap_cost_scaled(g_all, k, precision).astype(np.int64)
        low = np.iinfo(dt).min // 2
        f = np.full((B, bandwidth + A), low, dt)
        cmax = np.zeros(B, dt)
    pred = np.full((B, A), -1, np.int32)
    r = np.arange(bandwidth)
    pad = lambda x, v: np.concatenate([np.full((B, bandwidth), v, x.dtype), x], 1)  # noqa: E731
    qbp, tbp, tep, vp = pad(qb, 0), pad(tb, 0), pad(te, 0), pad(valid, False)
    step = max(1, (1 << 15) // max(B * bandwidth, 1))
    for i0 in range(0, A, step):
        i1 = min(A, i0 + step)
        # the f-free terms of pairs (j, i), rows i0..i1: j = i - bw + r
        jj = np.arange(i0, i1)[:, None] + r[None, :]
        qi, ti, ei = qb[:, i0:i1, None], tb[:, i0:i1, None], te[:, i0:i1, None]
        ql = qi - qbp[:, jj]
        tl = np.minimum(np.abs(ti - tbp[:, jj]), np.abs(ei - tep[:, jj]))
        gap = np.abs(ql - tl)
        ok = ((jj - bandwidth) >= 0)[None] & vp[:, jj] & valid[:, i0:i1, None]
        ok &= (qbp[:, jj] < qi) & (tep[:, jj] < ei) & (gap <= max_gap)
        mlen = np.minimum(np.minimum(ql, tl), k)
        gc = gtab[np.clip(gap, 0, max_gap)]
        if exact:
            mlen = mlen.astype(ft)
        else:
            term = mlen * SCALE[precision] - gc
        for i in range(i0, i1):
            fj = f[:, i:i + bandwidth]
            o = ok[:, i - i0]
            if exact:
                with np.errstate(over="ignore", invalid="ignore"):
                    y = (fj + mlen[:, i - i0] - gc[:, i - i0]) * 1000.0
                    rr = np.where(y >= 0, np.floor(y + 0.5), np.ceil(y - 0.5))
                    prop = np.where(o, rr / 1000.0, low)
            else:
                sc = fj.astype(np.int64) + term[:, i - i0]
                if np.any(o & ((sc > np.iinfo(dt).max) | (sc < np.iinfo(dt).min))):
                    raise OverflowError(f"{precision} chain score out of range")
                prop = np.where(o, sc, low).astype(dt)
            m = prop.max(axis=1)
            r_star = np.where(prop == m[:, None], r[None, :], -1).max(axis=1)
            improved = m > kf
            f[:, bandwidth + i] = np.where(improved, m, kf)
            pred[:, i] = np.where(improved, i - bandwidth + r_star, -1)
            cmax = np.maximum(cmax, m)
    return src, f[:, bandwidth:], pred, cmax, valid


def backtrack(f: np.ndarray, pred: np.ndarray, cmax, valid: np.ndarray,
              min_anchors: int) -> List[List[int]]:
    """One read's chains as ascending lists of sorted positions."""
    pred = pred.copy()
    chains = []
    for i in np.flatnonzero(valid & (pred != -1) & (f == cmax))[::-1].tolist():
        if pred[i] == -1:
            continue
        chain = []
        cur = i
        while pred[cur] != -1:
            p = int(pred[cur])
            pred[cur] = -1
            chain.append(cur)
            cur = p
        chain.append(cur)
        if len(chain) >= min_anchors:
            chains.append(chain[::-1])
    return chains


def map_reads(index, seqs: List[str], bandwidth: int, max_gap: int, min_anchors: int,
              precision: str, block: int = 256):
    """Per read, its chains as (qb, tb, te) arrays of ascending anchors."""
    out = []
    for s in range(0, len(seqs), block):
        part = seqs[s:s + block]
        rid, qb, tb, te, off = index.anchors(part)
        src, f, pred, cmax, valid = chain_dp(rid, qb, tb, te, off, index.k, bandwidth,
                                             max_gap, precision)
        for b in range(len(part)):
            chains = []
            for c in backtrack(f[b], pred[b], cmax[b], valid[b], min_anchors):
                sel = src[b, np.asarray(c)]
                chains.append((qb[sel], tb[sel], te[sel]))
            out.append(chains)
    return out
