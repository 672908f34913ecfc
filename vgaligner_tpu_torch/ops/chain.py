"""The chaining DP: plain PyTorch twins and the CUDA kernel wrapper.

Counterpart of ``vgaligner_tpu/ops/chain.py`` and ``ops/chain_pallas.py``
(reference: chain_anchors / score_anchor, chain.rs:274-655).  Anchors
are stably sorted by target end (invalid slots last); for each anchor i
the previous ``bandwidth`` anchors j are scored and the best strictly
improving predecessor kept, the largest j winning ties; ``curr_max`` is
the global best proposed score.

  * fast mode: scores in i32 milli-units with the deterministic
    ``gap_cost_scaled_i32``.  ``chain_dp`` launches the CUDA kernel
    (kernels/csrc/chain_dp.cu) on a CUDA tensor and runs
    ``chain_dp_plain`` on a CPU tensor;
  * exact mode: f64 with Rust's round-half-away to 3 decimals and a
    true IEEE divide by 1000 over the host's f64 gap table.
    ``chain_dp_exact`` launches the CUDA kernel
    (kernels/csrc/chain_dp_exact.cu) on a CUDA tensor and runs
    ``chain_dp_exact_plain`` on a CPU tensor.  The kernel divides only
    each row's winner where ``exact_divide_once`` says that is exact, and
    runs each read on two warps: a producer of pair terms ahead of a
    consumer of rows (``chain_dp_exact_occupancy``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels

NEG = -np.finfo(np.float64).max  # the reference's -f64::MAX
NEGI = -(1 << 30)
# Degree-7 least-squares polynomial for log2 on [1, 2) (ops/chain.py).
_LOG2_COEF = (
    8.121406e-07, 1.4426336, -0.72020257, 0.47172138,
    -0.32148254, 0.18865165, -0.07592032, 0.01459849,
)
# (anchor, window row) pairs per block of the plain DPs' pair precompute.
_PAIR_ROWS = 1 << 20


def make_gap_cost_table(seed_length: int, max_gap: int) -> np.ndarray:
    """gap -> 0.01*k*g + 0.5*log2(g), f64, for g in [0, max_gap]."""
    g = np.arange(max_gap + 1, dtype=np.float64)
    with np.errstate(divide="ignore"):
        cost = 0.01 * float(seed_length) * g + 0.5 * np.log2(g)
    cost[0] = 0.0
    return cost


class ChainScores(NamedTuple):
    order: torch.Tensor  # [B, A] int32 sorted position -> generation slot
    qb: torch.Tensor  # [B, A] int32 (sorted)
    tb: torch.Tensor  # [B, A] int64
    te: torch.Tensor  # [B, A] int64
    valid: torch.Tensor  # [B, A] bool
    f: torch.Tensor  # [B, A] int32 (fast) or float64 (exact)
    pred: torch.Tensor  # [B, A] int32 predecessor sorted position, -1 none
    curr_max: torch.Tensor  # [B] int32 (fast) or float64 (exact)


def _log2_poly_f32(gf: torch.Tensor) -> torch.Tensor:
    """Deterministic f32 log2: exponent extraction + Horner, one IEEE
    rounding per operation (each torch op is its own kernel)."""
    bits = gf.view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    x = ((bits & 0x7FFFFF) | (127 << 23)).view(torch.float32)
    t = x - 1.0
    acc = torch.full_like(t, _LOG2_COEF[7])
    for d in range(6, -1, -1):
        acc = acc * t
        acc = acc + _LOG2_COEF[d]
    return e.to(torch.float32) + acc


def gap_cost_scaled_i32_plain(gap: torch.Tensor, seed_length: int) -> torch.Tensor:
    """round(1000 * (0.01*k*g + 0.5*log2(g))) as 10*k*g + floor(500*poly + 0.5)."""
    gap = gap.to(torch.int32)
    lg = _log2_poly_f32(gap.to(torch.float32)) * 500.0
    lg = torch.floor(lg + 0.5).to(torch.int32)
    cost = gap * (10 * seed_length) + lg
    return torch.where(gap == 0, 0, cost).to(torch.int32)


def gap_cost_scaled_i32(gap: torch.Tensor, seed_length: int) -> torch.Tensor:
    """Gap cost on ``gap``'s device: the chain kernel's own device
    function on CUDA (the exhaustive check of its bits), the plain
    version on the CPU."""
    if gap.device.type == "cpu":
        return gap_cost_scaled_i32_plain(gap, seed_length)
    g = gap.to(torch.int32).contiguous()
    out = torch.empty_like(g)
    so = kernels.lib()
    kernels.LAUNCHES["chain_gap_cost"] += 1
    kernels.check(
        so.vg_chain_gap_cost(g.data_ptr(), g.numel(), seed_length, out.data_ptr(),
                             kernels.stream_ptr(g.device)),
        "chain_gap_cost",
    )
    return out


def sort_anchors(qb, tb, te, valid):
    """Stable sort by target end, invalid slots at int max."""
    key = torch.where(valid, te.to(torch.int64), torch.iinfo(torch.int64).max)
    order = torch.sort(key, dim=1, stable=True).indices
    take = lambda x: torch.gather(x, 1, order)  # noqa: E731
    return (order.to(torch.int32), take(qb.to(torch.int32)), take(tb.to(torch.int64)),
            take(te.to(torch.int64)), take(valid))


def _pair_terms(qb, tb, te, valid, i0, i1, bandwidth, max_gap, seed_length, exact,
                gap_table=None):
    """Everything about pairs (j, i) that does not depend on f, for rows
    i in [i0, i1): (mask [B, n, bw], then the f64 match length and gap
    cost (exact) or their i32 milli-unit difference (fast)).  Row i's
    window j = i - bw + r is column r of the columns left-padded by bw."""
    pad = lambda x: torch.nn.functional.pad(x, (bandwidth, 0))  # noqa: E731
    r = torch.arange(bandwidth, device=qb.device)
    jpos = torch.arange(i0, i1, device=qb.device)[:, None] + r[None, :]
    qb_j, tb_j, te_j, v_j = (pad(x)[:, jpos] for x in (qb, tb, te, valid))
    qb_i = qb[:, i0:i1, None]
    tb_i = tb[:, i0:i1, None]
    te_i = te[:, i0:i1, None]
    v_i = valid[:, i0:i1, None]
    j_real = (jpos - bandwidth) >= 0
    bad = (qb_j >= qb_i) | (te_j >= te_i)
    ql = qb_i - qb_j
    tl = torch.minimum((tb_i - tb_j).abs(), (te_i - te_j).abs())
    gap = (ql - tl).abs()
    bad |= gap > max_gap
    mask = j_real[None] & v_j & v_i & ~bad
    if exact:
        gcost = gap_table[gap.clamp(0, max_gap)]
        mlen = torch.minimum(ql, tl).clamp_max(seed_length).to(torch.float64)
        return mask, mlen, gcost
    mlen = torch.minimum(ql, tl).clamp_max(seed_length) * 1000
    gcost = gap_cost_scaled_i32_plain(gap.clamp(0, max_gap), seed_length)
    return mask, (mlen - gcost).to(torch.int32), None


def chain_dp_plain(qb, tb, te, valid, seed_length: int, bandwidth: int, max_gap: int):
    """Plain twin of the fast-mode DP over sorted anchors.

    qb/tb/te int32 [B, A], valid bool [B, A] -> (f, pred [B, A] int32,
    curr_max [B] int32).  Pair terms are precomputed per block of rows;
    the serial loop over anchors does only the f-dependent max/argmax."""
    B, A = qb.shape
    dev = qb.device
    qb, tb, te = qb.to(torch.int32), tb.to(torch.int32), te.to(torch.int32)
    k_i = seed_length * 1000
    fpad = torch.full((B, bandwidth + A), NEGI, dtype=torch.int32, device=dev)
    pred = torch.full((B, A), -1, dtype=torch.int32, device=dev)
    cmax = torch.zeros(B, dtype=torch.int32, device=dev)
    r_iota = torch.arange(bandwidth, dtype=torch.int32, device=dev)
    step = max(1, _PAIR_ROWS // max(B * bandwidth, 1))
    for i0 in range(0, A, step):
        i1 = min(A, i0 + step)
        mask, cterm, _ = _pair_terms(qb, tb, te, valid, i0, i1, bandwidth, max_gap,
                                     seed_length, exact=False)
        for i in range(i0, i1):
            prop = torch.where(mask[:, i - i0], fpad[:, i : i + bandwidth] + cterm[:, i - i0],
                               NEGI)
            m = prop.max(dim=1).values
            r_star = torch.where(prop == m[:, None], r_iota, -1).max(dim=1).values
            improved = m > k_i
            fpad[:, bandwidth + i] = torch.where(improved, m, k_i)
            pred[:, i] = torch.where(improved, i - bandwidth + r_star, -1)
            cmax = torch.maximum(cmax, m)
    return fpad[:, bandwidth:].contiguous(), pred, cmax


def chain_dp_exact_plain(qb, tb, te, valid, seed_length: int, bandwidth: int,
                         gap_table: np.ndarray):
    """Plain twin of the exact-mode (f64) DP over sorted anchors, on
    ``qb``'s device.  qb int32/int64, tb/te int64 [B, A], valid bool ->
    (f [B, A] f64, pred [B, A] int32, curr_max [B] f64).  The divide by
    1000 takes a tensor on the data's device: PyTorch turns a division
    of a CUDA tensor by a CPU scalar into a multiply by its reciprocal,
    which is not the IEEE divide."""
    B, A = qb.shape
    dev = qb.device
    max_gap = len(gap_table) - 1
    table = torch.from_numpy(np.asarray(gap_table, dtype=np.float64)).to(dev)
    qb, tb, te = qb.to(torch.int64), tb.to(torch.int64), te.to(torch.int64)
    k_f = float(seed_length)
    thousand = torch.tensor(1000.0, dtype=torch.float64, device=dev)
    fpad = torch.full((B, bandwidth + A), NEG, dtype=torch.float64, device=dev)
    fpad[:, bandwidth:] = k_f
    pred = torch.full((B, A), -1, dtype=torch.int32, device=dev)
    cmax = torch.zeros(B, dtype=torch.float64, device=dev)
    r_iota = torch.arange(bandwidth, dtype=torch.int32, device=dev)
    step = max(1, _PAIR_ROWS // max(B * bandwidth, 1))
    for i0 in range(0, A, step):
        i1 = min(A, i0 + step)
        mask, mlen, gcost = _pair_terms(qb, tb, te, valid, i0, i1, bandwidth, max_gap,
                                        seed_length, exact=True, gap_table=table)
        for i in range(i0, i1):
            x = (fpad[:, i : i + bandwidth] + mlen[:, i - i0]) - gcost[:, i - i0]
            y = x * thousand
            rr = torch.where(y >= 0.0, torch.floor(y + 0.5), torch.ceil(y - 0.5))
            prop = torch.where(mask[:, i - i0], rr / thousand, NEG)
            m = prop.max(dim=1).values
            r_star = torch.where(prop == m[:, None], r_iota, -1).max(dim=1).values
            improved = m > k_f
            fpad[:, bandwidth + i] = torch.where(improved, m, k_f)
            pred[:, i] = torch.where(improved, i - bandwidth + r_star, -1)
            cmax = torch.maximum(cmax, m)
    return fpad[:, bandwidth:].contiguous(), pred, cmax


def chain_dp(qb, tb, te, valid, seed_length: int, bandwidth: int, max_gap: int):
    """Fast-mode DP over sorted anchors: the CUDA kernel for CUDA tensors,
    the plain twin for CPU tensors.  Inputs int32 [B, A] (valid bool)."""
    if qb.device.type == "cpu":
        return chain_dp_plain(qb, tb, te, valid, seed_length, bandwidth, max_gap)
    B, A = qb.shape
    for name, t in (("qb", qb), ("tb", tb), ("te", te)):
        if t.dtype != torch.int32 or t.shape != (B, A):
            raise ValueError(f"chain_dp: {name} must be int32 [{B}, {A}]")
    if valid.dtype != torch.bool or valid.shape != (B, A):
        raise ValueError("chain_dp: valid must be bool [B, A]")
    kernels.require_cuda("chain_dp", qb, tb, te, valid)
    f = torch.empty((B, A), dtype=torch.int32, device=qb.device)
    pred = torch.empty((B, A), dtype=torch.int32, device=qb.device)
    cmax = torch.empty(B, dtype=torch.int32, device=qb.device)
    so = kernels.lib()
    kernels.LAUNCHES["chain_dp"] += 1
    kernels.check(
        so.vg_chain_dp(qb.data_ptr(), tb.data_ptr(), te.data_ptr(), valid.data_ptr(),
                       B, A, seed_length, bandwidth, max_gap, f.data_ptr(),
                       pred.data_ptr(), cmax.data_ptr(), kernels.stream_ptr(qb.device)),
        "chain_dp",
    )
    return f, pred, cmax


_DIV_ONCE_LIMIT = 2.0 ** 41  # |rr| bound under which one divide a row is exact
# (seed length, max_gap, device) -> (host table, device table)
_GAP_TABLES: dict = {}


def exact_divide_once(A: int, seed_length: int, gap_table: np.ndarray) -> bool:
    """Whether chain_dp_exact.cu may compare rr (the rounded milli-unit
    score before its divide by 1000) and divide only each row's winner:
    every |rr| stays below 2^41, so a -> fl(a / 1000) is strictly
    increasing on them (the kernel's header has the proof), and an
    anchor index fits the 21 bits the kernel packs it in.  With every
    gcost finite and >= 0, every f is at most k + A (k + 0.001) and every
    x at least k - max gcost; a negative gcost would let f grow by it on
    every row, so such a table divides every pair."""
    table = np.asarray(gap_table, dtype=np.float64)
    if A > 1 << 21 or not np.isfinite(table).all() or (table < 0).any():
        return False
    g_max = float(table.max()) if table.size else 0.0
    return 1000.0 * (A * (seed_length + 1) + 2 * seed_length + g_max) + 1 < _DIV_ONCE_LIMIT


def _device_gap_table(gap_table: np.ndarray, seed_length: int, device) -> torch.Tensor:
    """The f64 gap table on ``device``, uploaded once per (seed length,
    max_gap, device) and again only when its values change."""
    host = np.ascontiguousarray(gap_table, dtype=np.float64)
    key = (seed_length, len(host) - 1, str(device))
    hit = _GAP_TABLES.get(key)
    if hit is None or not np.array_equal(hit[0], host):
        hit = (host.copy(), torch.from_numpy(host.copy()).to(device))
        _GAP_TABLES[key] = hit
    return hit[1]


def chain_dp_exact(qb, tb, te, valid, seed_length: int, bandwidth: int,
                   gap_table: np.ndarray):
    """Exact-mode DP over sorted anchors: the CUDA kernel for CUDA
    tensors, the plain twin for CPU tensors.  qb int32, tb/te int64
    [B, A], valid bool.  On the card a row's winner is divided once where
    ``exact_divide_once`` holds, else every pair, as the twin does."""
    if qb.device.type == "cpu":
        return chain_dp_exact_plain(qb, tb, te, valid, seed_length, bandwidth, gap_table)
    B, A = qb.shape
    for name, t, dt in (("qb", qb, torch.int32), ("tb", tb, torch.int64),
                        ("te", te, torch.int64), ("valid", valid, torch.bool)):
        if t.dtype != dt or t.shape != (B, A):
            raise ValueError(f"chain_dp_exact: {name} must be {dt} [{B}, {A}]")
    if not 0 <= seed_length <= 255:
        raise ValueError("chain_dp_exact: needs a seed length up to 255")
    kernels.require_cuda("chain_dp_exact", qb, tb, te, valid)
    dev = qb.device
    table = _device_gap_table(gap_table, seed_length, dev)
    div_once = exact_divide_once(A, seed_length, gap_table)
    f = torch.empty((B, A), dtype=torch.float64, device=dev)
    pred = torch.empty((B, A), dtype=torch.int32, device=dev)
    cmax = torch.empty(B, dtype=torch.float64, device=dev)
    so = kernels.lib()
    kernels.LAUNCHES["chain_dp_exact"] += 1
    kernels.check(
        so.vg_chain_dp_exact(qb.data_ptr(), tb.data_ptr(), te.data_ptr(), valid.data_ptr(),
                             table.data_ptr(), B, A, seed_length, bandwidth,
                             len(gap_table) - 1, int(div_once), f.data_ptr(),
                             pred.data_ptr(), cmax.data_ptr(), kernels.stream_ptr(dev)),
        "chain_dp_exact",
    )
    return f, pred, cmax


def chain_dp_exact_occupancy(bandwidth: int, div_once: bool = True) -> dict:
    """chain_dp_exact.cu's reads a block (two warps each), blocks an SM
    keeps resident and dynamic shared memory a block in bytes at this
    band, from the CUDA occupancy calculator.  Needs the card."""
    out = (ctypes.c_int * 3)()
    kernels.check(kernels.lib().vg_chain_dp_exact_occupancy(bandwidth, int(div_once),
                                                            ctypes.addressof(out)),
                  "chain_dp_exact_occupancy")
    return {"reads_a_block": out[0], "blocks_an_sm": out[1], "smem": out[2]}


def chain_scores(qb, tb, te, valid, gap_table: np.ndarray, seed_length: int,
                 bandwidth: int = 50, precision: str = "exact") -> ChainScores:
    """Batched chaining DP over an anchor batch (generation order)."""
    order, qb_s, tb_s, te_s, valid_s = sort_anchors(qb, tb, te, valid)
    if precision == "fast":
        f, pred, cmax = chain_dp(qb_s, tb_s.to(torch.int32).contiguous(),
                                 te_s.to(torch.int32).contiguous(), valid_s.contiguous(),
                                 seed_length, bandwidth, len(gap_table) - 1)
    elif precision == "exact":
        f, pred, cmax = chain_dp_exact(qb_s, tb_s, te_s, valid_s.contiguous(), seed_length,
                                       bandwidth, gap_table)
    else:
        raise ValueError(f"unknown precision {precision!r}")
    return ChainScores(order=order, qb=qb_s, tb=tb_s, te=te_s, valid=valid_s,
                       f=f, pred=pred, curr_max=cmax)
