"""Batched POA on the device: plain twins, kernel wrappers, and the
dispatch/finish code around them.

Counterpart of ``vgaligner_tpu/ops/poa_device.py`` for both engines.

  * global (abPOA): problem arrays come from the native builder; each
    (V, L) bucket is cut into launches of real problems under a
    device-byte budget (``global_chunks``), each of which runs the POA DP
    and its traceback.  Rows of up to 256 columns (reads up to 255 bp)
    take ``poa_dp_tb``, one CUDA kernel for both, one warp a problem
    (kernels/csrc/poa_dp_tb.cu); rows of
    512-16,384 columns take ``poa_dp_tb_cluster``, one kernel for both,
    one thread-block cluster a problem (kernels/csrc/poa_dp_tb_cluster.cu);
    a row of another width is padded on the right to the next of those
    widths (``route_width``).  On the CPU every route runs the plain
    twins ``poa_dp_plain`` and ``poa_traceback_plain``.  Each launch's
    tape comes back sliced to its longest walk and the native runtime
    decodes it into cigar/cs/node paths.  ``poa_global_kernel`` runs the
    same DP under the lane-padded contract of the JAX package's
    Pallas kernel ``poa_dp_pallas``.  ``align_global_batch`` takes
    (nodes, edges, query) problems and runs them through the same
    builder, launches and kernels (the batch entry point that needs no
    native extractor).
  * local gapless (rspoa): ``align_local_batch`` builds problems with
    ``prepare_problem``, cuts each (V, L) bucket into launches of real
    problems under a device-byte budget (``local_chunks``), runs
    ``poa_local`` on each and decodes each tape through the port's
    ``ops/poa.py::_finish_result``.  Rows of up to 256 columns take
    ``poa_local_warp``, one warp a problem
    (kernels/csrc/poa_local_warp.cu); rows of 512-16,384 columns take
    ``poa_local_cluster``, one thread-block cluster a problem
    (kernels/csrc/poa_local_cluster.cu); other widths are padded on the
    right as the global route's are; on the CPU, ``poa_local_plain``.

Scores are integer-valued f32 with abPOA's defaults (match 2, mismatch
-4, gaps 4+2g and 24+g).  Decision bits per cell (int32):
  0-2 case at H (0 match, 1 E1, 2 E2, 3 F1, 4 F2); 3-6 match pred slot
  (15 = virtual source); 7 E1 opened; 8-11 E1 slot; 12 E2 opened;
  13-16 E2 slot; 17 F1 opened; 18 F2 opened.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from ..native import finish_tapes_native, require_native
from ..utils.timing import TRACER
from .poa import GAP_EXT1, GAP_EXT2, GAP_OPEN1, GAP_OPEN2, MATCH, MISMATCH, BaseGraph

NEGF = np.float32(-1.0e9)
P_MAX = 8  # predecessor slots per vertex (fan-in above this goes to the host)
OP_M, OP_I, OP_D, OP_END = 0, 1, 2, 3
_CASE_M, _CASE_E1, _CASE_E2, _CASE_F1, _CASE_F2 = 0, 1, 2, 3, 4
_VIRT_SLOT = 15
_END_FILL = OP_END | (1 << 2)


def _slice_preds(vpred: np.ndarray, n_real: int = -1) -> np.ndarray:
    """Slice the predecessor slot dim to the batch's max live fan-in
    (2/4/8), scanning only the real rows (padding rows are zero)."""
    if vpred.size == 0:
        return vpred
    live = vpred if n_real < 0 else vpred[:n_real]
    fan = int((live >= 0).sum(axis=-1).max()) if live.size else 1
    p_use = 2 if fan <= 2 else (4 if fan <= 4 else P_MAX)
    if p_use == vpred.shape[-1]:
        return vpred
    return np.ascontiguousarray(vpred[..., :p_use])


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p


def _l_pad_for(n: int) -> int:
    """Query-length pad ladder 127/255/511/...: W = l_pad + 1 is a
    multiple of 128."""
    p = 128
    while p - 1 < n:
        p <<= 1
    return p - 1


def _pad_queries(qs, l_pad: int):
    """Query codes padded to l_pad with code 4, and their lengths, for
    one launch."""
    q_pad = np.full((len(qs), l_pad), 4, dtype=np.int8)
    lens = [len(qc) for qc in qs]
    if qs and min(lens) == max(lens):
        q_pad[:, : lens[0]] = qs
    else:
        for i, qc in enumerate(qs):
            q_pad[i, : len(qc)] = qc
    return q_pad, np.asarray(lens, dtype=np.int32)


def make_init_row(l_pad: int) -> np.ndarray:
    """Leading-insertion cost row [l_pad + 1] f32: 0, -min(4+2j, 24+j)."""
    j = np.arange(1, l_pad + 1, dtype=np.int64)
    costs = np.minimum(GAP_OPEN1 + j * GAP_EXT1, GAP_OPEN2 + j * GAP_EXT2)
    return np.concatenate([[0.0], -costs]).astype(np.float32)


def unpack_tape(tape: np.ndarray):
    """(ops i8, vids i32) from packed tape entries op | (vid + 2) << 2."""
    t32 = tape.astype(np.int32)
    return (t32 & 3).astype(np.int8), (t32 >> 2) - 2


# ---------------------------------------------------------------------------
# POA DP

def poa_dp_plain(vcodes, vpred, is_sink, nv, q, nq, init_row):
    """Plain twin of the POA DP (``poa_dp_xla``).

    vcodes [B,V] int8, vpred [B,V,P] int32, is_sink [B,V] bool, nv [B]
    int32, q [B,L] int8, nq [B] int32, init_row [L+1] f32 ->
    (score [B] f32, best_sink [B] int32, tbits [B,V,L+1] int32).  The
    vertex loop runs to the batch's max nv; rows at or past a problem's
    own nv hold junk, as in the JAX version."""
    B, V = vcodes.shape
    L = q.shape[1]
    P = vpred.shape[-1]
    W = L + 1
    dev = vcodes.device
    f32 = torch.float32
    negf = torch.tensor(NEGF, dtype=f32, device=dev)
    oe1, oe2 = float(GAP_OPEN1 + GAP_EXT1), float(GAP_OPEN2 + GAP_EXT2)
    e1, e2 = float(GAP_EXT1), float(GAP_EXT2)
    S = torch.full((B, V + 1, 3 * W), float(NEGF), dtype=f32, device=dev)
    S[:, V, :W] = init_row.to(f32)
    tbits = torch.zeros((B, V, W), dtype=torch.int32, device=dev)
    jcol = torch.arange(W, dtype=f32, device=dev)
    e1j, e2j = jcol * e1, jcol * e2
    p_iota = torch.arange(P, dtype=torch.int32, device=dev)[None, :, None]
    bidx = torch.arange(B, device=dev)
    qi = q.to(torch.int32)
    nv_max = int(nv.max()) if B else 0

    def slot_min(cand, best):
        return torch.where(cand == best[:, None, :], p_iota, P).min(dim=1).values

    def at_slot(flags, slot):
        return torch.gather(flags, 1, slot[:, None, :].to(torch.int64))[:, 0, :]

    for v in range(nv_max):
        preds = vpred[:, v, :].to(torch.int64)  # [B, P]
        vcode = vcodes[:, v].to(torch.int32)  # [B]
        idx = torch.where(preds >= 0, preds, V)
        Sp = S[bidx[:, None], idx]  # [B, P, 3W]
        Hp, E1p, E2p = Sp[..., :W], Sp[..., W : 2 * W], Sp[..., 2 * W :]
        real = (preds >= 0)[:, :, None]
        E1p = torch.where(real, E1p, negf)
        E2p = torch.where(real, E2p, negf)
        has_any = preds[:, :1] >= 0
        live = ((preds >= 0) | ((p_iota[:, :, 0] == 0) & ~has_any))[:, :, None]
        Hp = torch.where(live, Hp, negf)
        E1p = torch.where(live, E1p, negf)
        E2p = torch.where(live, E2p, negf)

        open1 = Hp - oe1
        ext1 = E1p - e1
        cand1 = torch.maximum(open1, ext1)
        best1 = cand1.max(dim=1).values
        slot1 = slot_min(cand1, best1)
        opn1 = at_slot(open1 >= ext1, slot1)
        open2 = Hp - oe2
        ext2 = E2p - e2
        cand2 = torch.maximum(open2, ext2)
        best2 = cand2.max(dim=1).values
        slot2 = slot_min(cand2, best2)
        opn2 = at_slot(open2 >= ext2, slot2)

        sub = torch.where(qi == vcode[:, None], float(MATCH), float(MISMATCH))
        sub = torch.where((qi >= 4) | (vcode[:, None] >= 4), float(MISMATCH), sub).to(f32)
        m_cand = torch.full((B, P, W), float(NEGF), dtype=f32, device=dev)
        m_cand[:, :, 1:] = Hp[:, :, :-1] + sub[:, None, :]
        m_best = m_cand.max(dim=1).values
        m_slot = slot_min(m_cand, m_best)

        mx12 = torch.maximum(best1, best2)
        h_pre = torch.maximum(m_best, mx12)
        case_pre = torch.where(m_best >= mx12, _CASE_M,
                               torch.where(best1 >= best2, _CASE_E1, _CASE_E2))

        c1 = torch.cummax(h_pre + e1j, dim=1).values
        c2 = torch.cummax(h_pre + e2j, dim=1).values
        f1 = torch.full_like(h_pre, float(NEGF))
        f2 = torch.full_like(h_pre, float(NEGF))
        f1[:, 1:] = (c1[:, :-1] - float(GAP_OPEN1)) - e1j[1:]
        f2[:, 1:] = (c2[:, :-1] - float(GAP_OPEN2)) - e2j[1:]
        h_row = torch.maximum(h_pre, torch.maximum(f1, f2))
        case = torch.where(h_row <= h_pre, case_pre,
                           torch.where(h_row == f1, _CASE_F1, _CASE_F2))
        prev_h = torch.full_like(h_row, float(NEGF))
        prev_h[:, 1:] = h_row[:, :-1]
        f1_open = f1 == prev_h - oe1
        f2_open = f2 == prev_h - oe2

        pred_live = (preds >= 0)[:, :, None].expand(B, P, W)
        m_store = torch.where(at_slot(pred_live, m_slot), m_slot, _VIRT_SLOT)
        s1_store = torch.where(at_slot(pred_live, slot1), slot1, _VIRT_SLOT)
        s2_store = torch.where(at_slot(pred_live, slot2), slot2, _VIRT_SLOT)
        tbits[:, v] = (
            case.to(torch.int32)
            | (m_store.to(torch.int32) << 3)
            | (opn1.to(torch.int32) << 7)
            | (s1_store.to(torch.int32) << 8)
            | (opn2.to(torch.int32) << 12)
            | (s2_store.to(torch.int32) << 13)
            | (f1_open.to(torch.int32) << 17)
            | (f2_open.to(torch.int32) << 18)
        )
        S[:, v] = torch.cat([h_row, best1, best2], dim=1)

    v_ids = torch.arange(V, device=dev)
    col = nq.to(torch.int64)[:, None].expand(B, V)
    sink_h = torch.gather(S[:, :V, :W], 2, col[:, :, None])[:, :, 0]
    cand = is_sink.to(torch.bool) & (v_ids[None, :] < nv[:, None])
    sink_scores = torch.where(cand, sink_h, negf)
    # first vertex at the max (argmax's tie rule)
    best_score = sink_scores.max(dim=1).values
    best_sink = torch.where(sink_scores == best_score[:, None], v_ids[None, :], V)
    best_sink = best_sink.min(dim=1).values.to(torch.int32)
    return best_score, best_sink, tbits


def _check_dp_inputs(name, vcodes, vpred, is_sink, nv, q, nq, init_row):
    """The POA DP's CUDA inputs as its kernels take them -> (B, V, P, L)."""
    B, V = vcodes.shape
    L = q.shape[1]
    P = vpred.shape[-1]
    checks = (
        (vcodes, torch.int8, (B, V)), (vpred, torch.int32, (B, V, P)),
        (is_sink, torch.uint8, (B, V)), (nv, torch.int32, (B,)),
        (q, torch.int8, (B, L)), (nq, torch.int32, (B,)), (init_row, torch.float32, (L + 1,)),
    )
    for t, dt, shape in checks:
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dt} {shape}, got {t.dtype} {tuple(t.shape)}")
    if P not in (2, 4, 8):
        raise ValueError(f"{name}: unsupported P={P} (2/4/8)")
    kernels.require_cuda(name, vcodes, vpred, is_sink, nv, q, nq, init_row)
    return B, V, P, L


# ---------------------------------------------------------------------------
# traceback

def poa_traceback_plain(tbits, vpred, best_sink, nq):
    """Plain twin of ``traceback_batch``: the H/E/F walk per problem.

    tbits [B,V,C] int32, vpred [B,V,P] int32, best_sink [B], nq [B] ->
    (tape [B, T] int32 of op | (vid+2) << 2, tlen [B] int32), T = V+C+1;
    unwritten entries hold OP_END | 1 << 2.  Indices are normalised and
    clamped as JAX's gathers do."""
    B, V, C = tbits.shape
    P = vpred.shape[-1]
    T = V + C + 1
    dev = tbits.device
    tape = torch.full((B, T), _END_FILL, dtype=torch.int32, device=dev)
    b_iota = torch.arange(B, device=dev)
    v = best_sink.to(torch.int64)
    j = nq.to(torch.int64)
    st = torch.zeros(B, dtype=torch.int64, device=dev)
    for t in range(T):
        done = (v == -2) & (j == 0)
        if t % 64 == 0 and bool(done.all()):
            break
        vc = v.clamp(0, V - 1)
        jj = torch.where(j < 0, j + C, j).clamp(0, C - 1)
        bits = tbits[b_iota, vc, jj].to(torch.int64)
        case = bits & 7
        m_slot = (bits >> 3) & 15
        at_h = st == 0
        is_match = at_h & (case == _CASE_M)
        sw = torch.where(at_h & ~is_match, case, st)
        in_e = (sw == 1) | (sw == 2)
        e_opn = torch.where(sw == 1, (bits >> 7) & 1, (bits >> 12) & 1)
        e_slot = torch.where(sw == 1, (bits >> 8) & 15, (bits >> 13) & 15)
        go_slot = torch.where(in_e, e_slot, m_slot)
        go_nxt = torch.where(go_slot == _VIRT_SLOT, -2,
                             vpred[b_iota, vc, go_slot.clamp_max(P - 1)].to(torch.int64))
        in_f = (sw == 3) | (sw == 4)
        f_opn = torch.where(sw == 3, (bits >> 17) & 1, (bits >> 18) & 1)
        from_virtual = v == -2
        op = torch.where(from_virtual | in_f, OP_I, torch.where(in_e, OP_D, OP_M))
        vid = torch.where(from_virtual, -1, v)
        v2 = torch.where(from_virtual | in_f, v, go_nxt)
        j2 = torch.where(from_virtual | in_f | is_match, j - 1, j)
        st2 = torch.where(
            from_virtual | is_match, 0,
            torch.where(in_e, torch.where(e_opn == 1, 0, sw),
                        torch.where(in_f, torch.where(f_opn == 1, 0, sw), st)),
        )
        entry = (op | ((vid + 2) << 2)) & 0xFFFF
        tape[:, t] = torch.where(done, _END_FILL, entry).to(torch.int32)
        v = torch.where(done, v, v2)
        j = torch.where(done, j, j2)
        st = torch.where(done, st, st2)
    tlen = ((tape & 3) != OP_END).sum(dim=1).to(torch.int32)
    return tape, tlen


# ---------------------------------------------------------------------------
# POA DP and traceback in one kernel (rows up to 256 columns)

TB_WIDTHS = (32, 64, 128, 256)  # W = 32 C, C = 1/2/4/8 columns a lane
TB_RING, TB_PINS = 8, 4  # poa_dp_tb.cu's row ring and pinned far rows
LOCAL_RING, LOCAL_PINS = 8, 4  # poa_local_warp.cu's rows back in its ring, pinned far rows


def far_vertices_plain(vpred, nv, ring: int = TB_RING):
    """Distinct vertices per problem that some vertex v < nv reads from
    more than ``ring`` rows back.  vpred [B,V,P], nv [B] -> [B] int32."""
    B, V, _P = vpred.shape
    v_ids = torch.arange(V, device=vpred.device)[None, :, None]
    far = (vpred >= 0) & (vpred < v_ids - ring) & (v_ids < nv.to(torch.int64)[:, None, None])
    marks = torch.zeros((B, V + 1), dtype=torch.int32, device=vpred.device)
    marks.scatter_(1, torch.where(far, vpred.to(torch.int64), V).reshape(B, -1), 1)
    return marks[:, :V].sum(dim=1).to(torch.int32)


def backing_rows_plain(vpred, nv, ring: int = TB_RING, pins: int = TB_PINS):
    """Rows per problem that a row-ring kernel keeps in its global
    backing store: the far vertices (``far_vertices_plain`` at ``ring``)
    less the first ``pins`` of them, which get pinned shared-memory rows;
    ``poa_dp_tb``'s kernel at the defaults, ``poa_local_warp``'s at
    LOCAL_RING and LOCAL_PINS.  vpred [B,V,P], nv [B] -> [B] int32."""
    return (far_vertices_plain(vpred, nv, ring) - pins).clamp_min(0).to(torch.int32)


def _back_offsets(vpred, nv, back_rows, ring: int = LOCAL_RING,
                  pins: int = LOCAL_PINS) -> np.ndarray:
    """[B + 1] int32 first backing row of each problem (and the total)
    for a kernel that sizes its backing store by counted rows
    (``poa_dp_tb``, ``poa_dp_tb_cluster``, ``poa_local_warp``,
    ``poa_local_cluster``);
    ``back_rows`` is the host's count per problem, or None to count here
    at ``ring`` and ``pins`` (which waits for the device)."""
    if back_rows is None:
        back_rows = backing_rows_plain(vpred, nv, ring, pins).cpu().numpy()
    off = np.zeros(len(back_rows) + 1, dtype=np.int64)
    np.cumsum(np.asarray(back_rows, dtype=np.int64), out=off[1:])
    if off[-1] >= 1 << 31:
        raise ValueError("over 2^31 backing rows in one launch")
    return off.astype(np.int32)


def _pinned_offsets(off: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``_back_offsets``' array on ``dev``, copied from pinned memory
    without blocking: a copy from pageable memory would wait for the
    stream, so a launch given its counts would wait for the last one."""
    return torch.from_numpy(off).pin_memory().to(dev, non_blocking=True)


def _dp_tb_plain(vcodes, vpred, is_sink, nv, q, nq, init_row):
    """The fused kernels' CPU route: ``poa_dp_plain``, then
    ``poa_traceback_plain``, and the backing rows of their plan."""
    score, best_sink, tbits = poa_dp_plain(vcodes, vpred, is_sink, nv, q, nq, init_row)
    tape, tlen = poa_traceback_plain(tbits, vpred, best_sink, nq)
    return score, best_sink, tbits, tape, tlen, backing_rows_plain(vpred, nv)


def _dp_tb_buffers(vcodes, vpred, nv, W: int, back_rows):
    """The fused kernels' device buffers for a batch of rows of W columns:
    back_off [B + 1] (``_back_offsets`` at TB_RING, TB_PINS), the backing
    store [its rows, 3W] f32 (never zeroed: only the host-counted rows
    exist, and a row is read only after it is written), score, best_sink,
    tbits [B, V, W], tape [B, V + W + 1], tlen and n_backing."""
    B, V = vcodes.shape
    dev = vcodes.device
    off = _back_offsets(vpred, nv, back_rows, TB_RING, TB_PINS)
    i32 = torch.int32
    return (_pinned_offsets(off, dev),
            torch.empty((max(int(off[-1]), 1), 3 * W), dtype=torch.float32, device=dev),
            torch.empty(B, dtype=torch.float32, device=dev), torch.empty(B, dtype=i32, device=dev),
            torch.empty((B, V, W), dtype=i32, device=dev),
            torch.empty((B, V + W + 1), dtype=i32, device=dev),
            torch.empty(B, dtype=i32, device=dev), torch.empty(B, dtype=i32, device=dev))


def poa_dp_tb(vcodes, vpred, is_sink, nv, q, nq, init_row, back_rows=None):
    """POA DP and traceback: one CUDA kernel for CUDA tensors (rows of W
    = L + 1 in TB_WIDTHS), ``poa_dp_plain`` then ``poa_traceback_plain``
    for CPU tensors.  Same arguments as ``poa_dp_plain``, plus ``back_rows``
    (the host's ``backing_rows_plain`` per problem, which sizes the
    backing store; None counts them here) -> (score, best_sink, tbits,
    tape, tlen, n_backing): the first five as the two twins give them
    (tbits rows at or past nv unspecified), except tlen -1 for a problem
    that needs more backing rows than ``back_rows`` gave it, and
    n_backing [B] int32 the rows each problem kept in the kernel's
    backing store (``backing_rows_plain``)."""
    if vcodes.device.type == "cpu":
        return _dp_tb_plain(vcodes, vpred, is_sink, nv, q, nq, init_row)
    B, V, P, L = _check_dp_inputs("poa_dp_tb", vcodes, vpred, is_sink, nv, q, nq, init_row)
    W = L + 1
    if W not in TB_WIDTHS:
        raise ValueError(f"poa_dp_tb: unsupported row width W={W} {TB_WIDTHS}")
    bufs = _dp_tb_buffers(vcodes, vpred, nv, W, back_rows)
    so = kernels.lib()
    kernels.LAUNCHES["poa_dp_tb"] += 1
    kernels.check(
        so.vg_poa_dp_tb(vcodes.data_ptr(), vpred.data_ptr(), is_sink.data_ptr(), nv.data_ptr(),
                        q.data_ptr(), nq.data_ptr(), init_row.data_ptr(), B, V, P, L,
                        *(x.data_ptr() for x in bufs), kernels.stream_ptr(vcodes.device)),
        "poa_dp_tb",
    )
    return bufs[2:]


def poa_dp_tb_occupancy(P: int, W: int, V: int) -> Tuple[int, int, int]:
    """(problems a block holds, blocks an SM keeps resident, dynamic
    shared memory per block in bytes) of ``poa_dp_tb``'s kernel at this
    shape, from the CUDA occupancy calculator.  Needs the card."""
    out = (ctypes.c_int * 3)()
    kernels.check(kernels.lib().vg_poa_dp_tb_occupancy(P, W, V, ctypes.addressof(out)),
                  "poa_dp_tb_occupancy")
    return out[0], out[1], out[2]


# ---------------------------------------------------------------------------
# POA DP and traceback in one kernel, one thread-block cluster a problem
# (rows of 512-16,384 columns)

# poa_dp_tb_cluster.cu's columns a CTA by row width: 512 up to W 8,192
# (1-16 CTAs a cluster), 1,024 at W 16,384 (16 CTAs)
CLUSTER_SLICE = {512: 512, 1024: 512, 2048: 512, 4096: 512, 8192: 512, 16384: 1024}
# the row widths of both cluster kernels (poa_local_cluster.cu: 2,048
# columns a CTA at most, 1-8 CTAs a cluster)
CLUSTER_WIDTHS = tuple(CLUSTER_SLICE)


def poa_dp_tb_cluster(vcodes, vpred, is_sink, nv, q, nq, init_row, back_rows=None):
    """POA DP and traceback: one CUDA kernel, one thread-block cluster of
    W / CLUSTER_SLICE[W] CTAs a problem, for CUDA tensors (rows of W = L +
    1 in CLUSTER_WIDTHS), the plain pair for CPU tensors.  Same arguments
    and outputs as ``poa_dp_tb`` (``back_rows`` and n_backing at its ring
    and pins, tlen -1 for a problem short of backing rows).  Raises where
    the card cannot keep one cluster of this shape resident.

    Device memory at the widest shape: tbits is 0.54 GB a problem at V
    8,192 x W 16,384, and the backing store holds only the host-counted
    rows, 196,608 bytes each there (``global_problem_bytes``)."""
    if vcodes.device.type == "cpu":
        return _dp_tb_plain(vcodes, vpred, is_sink, nv, q, nq, init_row)
    B, V, P, L = _check_dp_inputs("poa_dp_tb_cluster", vcodes, vpred, is_sink, nv, q, nq,
                                  init_row)
    W = L + 1
    if W not in CLUSTER_SLICE:
        raise ValueError(f"poa_dp_tb_cluster: unsupported row width W={W} {CLUSTER_WIDTHS}")
    ctas, clusters, smem = poa_dp_tb_cluster_occupancy(P, W, V)
    if clusters <= 0:
        raise RuntimeError(f"poa_dp_tb_cluster: no cluster of {ctas} CTAs of "
                           f"{CLUSTER_SLICE[W]} columns with {smem} B of shared memory each "
                           f"can be resident (P={P}, W={W}, V={V})")
    bufs = _dp_tb_buffers(vcodes, vpred, nv, W, back_rows)
    so = kernels.lib()
    kernels.LAUNCHES["poa_dp_tb_cluster"] += 1
    kernels.check(
        so.vg_poa_dp_tb_cluster(vcodes.data_ptr(), vpred.data_ptr(), is_sink.data_ptr(),
                                nv.data_ptr(), q.data_ptr(), nq.data_ptr(), init_row.data_ptr(),
                                B, V, P, L, *(x.data_ptr() for x in bufs),
                                kernels.stream_ptr(vcodes.device)),
        "poa_dp_tb_cluster",
    )
    return bufs[2:]


@functools.lru_cache(maxsize=None)
def poa_dp_tb_cluster_occupancy(P: int, W: int, V: int) -> Tuple[int, int, int]:
    """(CTAs a cluster, clusters the card keeps resident at once, dynamic
    shared memory per CTA in bytes) of ``poa_dp_tb_cluster``'s kernel at
    this shape, from the CUDA occupancy calculator.  Needs the card."""
    out = (ctypes.c_int * 3)()
    kernels.check(kernels.lib().vg_poa_dp_tb_cluster_occupancy(P, W, V, ctypes.addressof(out)),
                  "poa_dp_tb_cluster_occupancy")
    return out[0], out[1], out[2]


ROUTE_WIDTHS = TB_WIDTHS + CLUSTER_WIDTHS  # the row widths the routes launch, 32-16,384


def route_width(W: int) -> int:
    """The row width a route runs a row of W columns at: the narrowest of
    ROUTE_WIDTHS that holds it.  ValueError above 16,384."""
    for w in ROUTE_WIDTHS:
        if w >= W:
            return w
    raise ValueError(f"row width W={W} exceeds {ROUTE_WIDTHS[-1]}")


def global_route(W: int) -> Tuple[str, int]:
    """(kernel, row width) ``dp_and_traceback`` launches for rows of W
    columns on the card: ``poa_dp_tb`` or ``poa_dp_tb_cluster`` at
    ``route_width(W)``."""
    w = route_width(W)
    return ("poa_dp_tb" if w in TB_WIDTHS else "poa_dp_tb_cluster"), w


def pad_row(q, init_row, W: int):
    """(q [B, W-1], init_row [W]): the query padded on the right with code
    4 and the virtual-source row with NEGF, to a row of W columns.

    Exact for both DPs: no cell reads a column to its right.  In the
    global DP, M at column j reads j - 1, E reads j, and F is a prefix
    over columns < j, so the first columns' H, E, F and decision bits,
    the best sink at column nq and the walk from it (which only moves
    left) are those of the narrower row.  In the local DP a padding cell
    is at most max(H[pred][j-1] - 4, 0) (code 4 mismatches), strictly
    below a cell scanned in an earlier row or 0, so it is never the
    first best; the best cell, its walk and qend do not change."""
    B, L = q.shape
    q_w = torch.full((B, W - 1), 4, dtype=q.dtype, device=q.device)
    q_w[:, :L] = q
    if init_row is None:
        return q_w, None
    init_w = torch.full((W,), float(NEGF), dtype=init_row.dtype, device=init_row.device)
    init_w[: L + 1] = init_row
    return q_w, init_w


# the program's counter of global launches, by the kernel the route picks
LAUNCH_COUNTER = {"poa_dp_tb": "aligner.launches.k6", "poa_dp_tb_cluster": "aligner.launches.k8"}


def dp_and_traceback(vcodes, vpred, is_sink, nv, q, nq, init_row, back_rows=None):
    """(score, tape [B, V+W+1], tlen) of one batch, W = L + 1: ``poa_dp_tb``
    for rows of W in TB_WIDTHS, ``poa_dp_tb_cluster`` for W in
    CLUSTER_WIDTHS, each given ``back_rows``; a row of another width up
    to 16,384 is padded on the right to the next of those widths
    (``pad_row``, exact) and its tape cut back to V + W + 1 entries (the
    walk takes at most V + nq + 1 steps).  Each call is one launch,
    counted under ``LAUNCH_COUNTER[kernel]`` (on the CPU too, where the
    kernel's plain twin runs it)."""
    V, W = vcodes.shape[1], q.shape[1] + 1
    kernel, w = global_route(W)
    TRACER.count(LAUNCH_COUNTER[kernel])
    if w != W:
        q, init_row = pad_row(q, init_row, w)
    fused = poa_dp_tb if kernel == "poa_dp_tb" else poa_dp_tb_cluster
    score, _sink, _tbits, tape, tlen, _nb = fused(vcodes, vpred, is_sink, nv, q, nq, init_row,
                                                  back_rows)
    return score, tape[:, : V + W + 1], tlen


def poa_global_kernel(vcodes, vpred, is_sink, nv, q, nq, init_row):
    """One batch of global POA problems, DP + traceback, under the
    contract of the JAX package's VMEM-resident Pallas DP (the
    ``use_pallas`` route of its ``poa_global_kernel``): the row is padded
    to l_w = ceil((L+1)/128)*128 columns, the query with code 4 and
    ``init_row`` with NEGF, and the traceback walks the l_w-wide bits.

    Same arguments as ``poa_dp_plain`` with q [B, L] and init_row [L+1] ->
    (score [B] f32, tape [B, V+l_w+1] int32, tlen [B] int32).  That DP is
    ``poa_dp_plain``'s at this width, so it takes the route ``dp_and_traceback``
    gives that width (an l_w off the power-of-two ladder, such as 384,
    runs padded to the next width a fused kernel takes)."""
    q_w, init_w = lane_pad(q, init_row)
    return dp_and_traceback(vcodes, vpred, is_sink, nv, q_w, nq, init_w)


def lane_pad(q, init_row):
    """(q [B, l_w-1] padded with code 4, init_row [l_w] padded with NEGF),
    l_w = ceil((L+1)/128)*128: the row width of ``poa_global_kernel``."""
    return pad_row(q, init_row, ((q.shape[1] + 1 + 127) // 128) * 128)


# ---------------------------------------------------------------------------
# the global route's launch plan, dispatch and finish

# per-launch device-memory budget of the global POA route
_HBM_BUDGET = 6 << 30


def global_problem_bytes(V: int, W: int, P: int, back_rows) -> np.ndarray:
    """Device bytes one global POA problem of a (V, W) batch takes on the
    route ``global_route(W)`` picks (row width w), per problem of
    ``back_rows`` (its host-counted backing rows): the inputs (codes, sink
    flags and P predecessor ids a vertex, the query, nv, nq and its
    backing offset), tbits V x w i32, the tape V + w + 1 i32, the scalars
    (score, best sink, tlen, n_backing), 3w f32 a backing row, and the
    query right-padded to w - 1 columns where w != W."""
    _kernel, w = global_route(W)
    fixed = V * (2 + 4 * P) + (W - 1) + 12 + 4 * V * w + 4 * (V + w + 1) + 16
    if w != W:
        fixed += w - 1
    return fixed + 12 * w * np.asarray(back_rows, dtype=np.int64)


def global_chunks(built, v_pad: int, l_pad: int, budget: int = None):
    """One (V, L) bucket of native-builder arrays (a row a problem) as
    launches of real problems only, in order, each under ``budget``
    device bytes (``_HBM_BUDGET``; a problem over it runs alone): yields
    (start, end, the arrays of problems [start, end), back_rows), vpred
    sliced to the bucket's fan-in and back_rows the host's backing-row
    count per problem (``backing_rows_plain`` at TB_RING, TB_PINS)."""
    budget = _HBM_BUDGET if budget is None else budget
    n = len(built[0])
    vpred = _slice_preds(built[1])
    back = backing_rows_plain(torch.from_numpy(vpred), torch.from_numpy(built[3]),
                              TB_RING, TB_PINS).numpy().astype(np.int64)
    cost = np.cumsum(global_problem_bytes(v_pad, l_pad + 1, vpred.shape[-1], back))
    s = 0
    while s < n:
        base = cost[s - 1] if s else 0
        e = max(s + 1, int(np.searchsorted(cost, base + budget, side="right")))
        yield s, e, tuple(a[s:e] for a in (built[0], vpred, *built[2:])), back[s:e]
        s = e


def kernel_dispatch(chunk, qs, v_pad: int, l_pad: int, device: torch.device, back_rows):
    """Launch DP + traceback (``dp_and_traceback``) on one launch of real
    problems, with the host's backing-row counts, without waiting for the
    device.  Returns the pending state for ``kernel_finish_all``."""
    vcodes, vpred, is_sink, nv, node_of, off_in = chunk
    q_pad, nq = _pad_queries(qs, l_pad)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    out = dp_and_traceback(
        t(vcodes.astype(np.int8, copy=False)), t(_slice_preds(vpred).astype(np.int32)),
        t(is_sink.astype(np.uint8, copy=False)), t(nv.astype(np.int32, copy=False)),
        t(q_pad), t(nq), t(make_init_row(l_pad)), back_rows=back_rows,
    )
    return out, vcodes, node_of, off_in, q_pad, v_pad, qs


def kernel_finish_all(pendings) -> List:
    """Drain dispatched launches (scores and lengths, then each tape
    sliced to its longest walk) and decode them into PoaResults, in
    order.  Raises on a tlen of -1 (a problem short of backing rows)."""
    out: List = []
    with TRACER.span("aligner.drain"):
        for p in pendings:
            score, tape, tlen = p[0]
            tlen_h = tlen.cpu().numpy()
            if (tlen_h < 0).any():
                raise RuntimeError("global POA: a problem needs more backing rows than the "
                                   "host counted")
            used = max(1, int(tlen_h.max()))
            out.extend(_decode_finished(
                p, (score.cpu().numpy(), tape[:, :used].cpu().numpy(), tlen_h)
            ))
    return out


def _decode_finished(pending, fetched):
    from .poa import PoaResult

    require_native()
    _d, vcodes, node_of, off_in, q_pad, v_pad, qs = pending
    n_real = len(qs)
    scores, tape, tlens = fetched
    ops, vids = unpack_tape(tape)
    bg_off = np.arange(n_real + 1, dtype=np.int64) * v_pad
    cigars, css, node_paths, path_vertices, scalars = finish_tapes_native(
        ops, vids, tlens.astype(np.int32), bg_off, vcodes.reshape(-1), node_of.reshape(-1),
        off_in.reshape(-1), q_pad,
    )
    return [
        PoaResult(
            cigar=cigars[i], cs=css[i], path_vertices=path_vertices[i],
            node_path=node_paths[i], aln_start_offset=int(scalars[i, 2]),
            aln_end_offset=int(scalars[i, 3]), n_aligned=int(scalars[i, 0]),
            best_score=int(scores[i]), query_start=0, query_end=len(qs[i]),
            path_start_offset=int(scalars[i, 4]), path_end_offset=int(scalars[i, 5]),
            residue_matches=int(scalars[i, 1]),
        )
        for i in range(n_real)
    ]


def dispatch_bucket(built, qs, v_pad: int, l_pad: int, device: torch.device) -> list:
    """Dispatch every launch of one (v_pad, l_pad) bucket (``global_chunks``)."""
    return [kernel_dispatch(chunk, qs[s:e], v_pad, l_pad, device, back)
            for s, e, chunk, back in global_chunks(built, v_pad, l_pad)]


def align_global_batch(problems: Sequence[Tuple[Sequence[str], Sequence[Tuple[int, int]], str]],
                       device=None) -> list:
    """Global POA (abPOA engine) of (nodes, edges, query) problems on
    ``device`` (the card when None; without one ``resolve_device`` raises
    RuntimeError): a list of PoaResults equal to ``align_global_host`` on
    each problem.  Problems are bucketed by (pow2 V >= 256, query ladder),
    built by the native builder and run launch by launch through
    ``dispatch_bucket`` (real problems under ``_HBM_BUDGET`` bytes a
    launch, ``global_chunks``); subgraphs above 8,192 base vertices go to the
    native host POA.  A bucket the builder refuses (a vertex fan-in above
    P_MAX) takes ``_align_bucket``, which raises ValueError there, as the
    JAX package's does.  Equal to the JAX package's ``align_global_batch``."""
    from ..device import resolve_device
    from ..native import poa_global_host_native
    from ..utils.dna import encode_seq
    from .poa import build_base_graph

    device = resolve_device("cuda" if device is None else device)
    qs_all = [encode_seq(q) for _, _, q in problems]
    vs = [sum(len(s) for s in nodes) for nodes, _, _ in problems]
    buckets: dict = {}
    out = [None] * len(problems)
    for i, (v, q) in enumerate(zip(vs, qs_all)):
        if v > 8192:
            out[i] = poa_global_host_native(*problems[i])
            continue
        buckets.setdefault((_next_pow2(max(v, 256)), _l_pad_for(len(q))), []).append(i)
    for (v_pad, l_pad), idxs in sorted(buckets.items()):
        qs = [qs_all[i] for i in idxs]
        res = _align_bucket_native([problems[i][:2] for i in idxs], qs, v_pad, l_pad, device)
        if res is None:
            res = _align_bucket([build_base_graph(*problems[i][:2]) for i in idxs], qs,
                                v_pad, l_pad, device)
        for i, r in zip(idxs, res):
            out[i] = r
    return out


def _align_bucket_native(node_edge_probs, qs, v_pad: int, l_pad: int, device: torch.device):
    """One bucket through the native builder and tape decoder around the
    kernels; None where a problem exceeds the pads (fan-in above P_MAX)."""
    from ..native import build_poa_batch_native

    built = build_poa_batch_native(node_edge_probs, v_pad, P_MAX)
    if built is None:
        return None
    return kernel_and_finish(built, qs, v_pad, l_pad, device)


def kernel_and_finish(built, qs, v_pad: int, l_pad: int, device: torch.device) -> list:
    """Run the POA kernels over prebuilt problem arrays and decode the
    tapes natively into PoaResults."""
    return kernel_finish_all(dispatch_bucket(built, qs, v_pad, l_pad, device))


def _align_bucket(bgs, qs, v_pad: int, l_pad: int, device: torch.device) -> list:
    """One bucket from Python base graphs: ``prepare_problem`` (ValueError
    on a fan-in above P_MAX), the batch padded to a power of two with
    copies, ``poa_global_kernel`` (the lane-padded contract), and the
    tapes decoded in Python."""
    from .poa import _finish_result

    probs = [prepare_problem(bg, q, v_pad, l_pad) for bg, q in zip(bgs, qs)]
    probs += [probs[0]] * (_next_pow2(max(len(probs), 4)) - len(probs))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    score, tape, tlen = poa_global_kernel(
        t(np.stack([p.vcodes for p in probs])),
        t(_slice_preds(np.stack([p.vpred for p in probs]))),
        t(np.stack([p.is_sink for p in probs]).astype(np.uint8)),
        t(np.asarray([p.nv for p in probs], dtype=np.int32)),
        t(np.stack([p.q for p in probs])),
        t(np.asarray([p.nq for p in probs], dtype=np.int32)),
        t(make_init_row(l_pad)),
    )
    scores, tlens = score.cpu().numpy(), tlen.cpu().numpy()
    ops, vids = unpack_tape(tape.cpu().numpy())
    results = []
    for i, (bg, q) in enumerate(zip(bgs, qs)):
        n = int(tlens[i])
        # (op, vertex, query position) triples in forward order
        triples = []
        qpos = 0
        for op, v in zip(ops[i][:n][::-1], vids[i][:n][::-1]):
            if op == OP_M:
                triples.append(("M" if v >= 0 and q[qpos] == bg.codes[v] else "X", int(v), qpos))
                qpos += 1
            elif op == OP_I:
                triples.append(("I", int(v), qpos))
                qpos += 1
            elif op == OP_D:
                triples.append(("D", int(v), qpos))
        results.append(_finish_result(bg, q, triples, int(scores[i]), 0, len(q)))
    return results


# ---------------------------------------------------------------------------
# local gapless POA (the rspoa engine)

class PoaProblem(NamedTuple):
    """One padded POA problem (host side)."""

    vcodes: np.ndarray  # int8 [V]
    vpred: np.ndarray  # int32 [V, P_MAX] predecessor vertex ids, -1 pad/virtual
    is_sink: np.ndarray  # bool [V]
    nv: int
    q: np.ndarray  # int8 [L]
    nq: int


def prepare_problem(bg: BaseGraph, qcodes: np.ndarray, v_pad: int, l_pad: int) -> PoaProblem:
    """One base graph and query padded to (v_pad, l_pad); a vertex with
    more than P_MAX predecessors raises ValueError, as in the JAX package
    (its rspoa route has no host fallback for it)."""
    V = len(bg.codes)
    if V > v_pad or len(qcodes) > l_pad:
        raise ValueError("problem exceeds pad")
    vcodes = np.full(v_pad, 4, dtype=np.int8)
    vcodes[:V] = bg.codes
    vpred = np.full((v_pad, P_MAX), -1, dtype=np.int32)
    for v, ps in enumerate(bg.preds):
        if len(ps) > P_MAX:
            raise ValueError(f"vertex fan-in {len(ps)} exceeds {P_MAX}")
        vpred[v, : len(ps)] = ps
    is_sink = np.zeros(v_pad, dtype=bool)
    is_sink[:V] = bg.is_sink
    q = np.full(l_pad, 4, dtype=np.int8)
    q[: len(qcodes)] = qcodes
    return PoaProblem(vcodes, vpred, is_sink, V, q, len(qcodes))


def poa_local_plain(vcodes, vpred, nv, q, nq):
    """Plain twin of the local gapless DP + traceback
    (``poa_local_kernel``), vectorised over problems.

    vcodes [B,V] int8, vpred [B,V,P] int32, nv [B] int32, q [B,L] int8,
    nq [B] (unused, as in the JAX version: padding code 4 always
    mismatches) -> (best [B] f32, tape [B, L+1] int32, tlen [B] int32,
    qend [B] int32).  The vertex loop runs to the batch max nv."""
    B, V = vcodes.shape
    L = q.shape[1]
    P = vpred.shape[-1]
    W = L + 1
    dev = vcodes.device
    f32 = torch.float32
    H = torch.zeros((B, V + 1, W), dtype=f32, device=dev)  # row V: virtual 0s
    cells = torch.zeros((B, V, W), dtype=torch.int32, device=dev)  # slot | pos << 4
    p_iota = torch.arange(P, dtype=torch.int32, device=dev)[None, :, None]
    j_iota = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    bidx = torch.arange(B, device=dev)
    qi = q.to(torch.int32)
    best = torch.zeros(B, dtype=f32, device=dev)
    bv = torch.zeros(B, dtype=torch.int32, device=dev)
    bj = torch.zeros(B, dtype=torch.int32, device=dev)
    nv_max = int(nv.max()) if B else 0
    for v in range(nv_max):
        preds = vpred[:, v, :].to(torch.int64)
        idx = torch.where(preds >= 0, preds, V)
        Hp = H[bidx[:, None], idx]  # [B, P, W]; dead slots read the virtual 0 row
        live = (preds >= 0)[:, :, None]
        cand = torch.zeros((B, P, W), dtype=f32, device=dev)
        cand[:, :, 1:] = Hp[:, :, :-1]
        cand = torch.where(live, cand, 0.0)
        m_best = cand.max(dim=1).values.clamp_min(0.0)
        # first live slot achieving the max, only when max > 0
        slot = torch.where((cand == m_best[:, None, :]) & live, p_iota, P).min(dim=1).values
        slot = torch.where(m_best > 0.0, slot, _VIRT_SLOT)
        slot = torch.where(slot >= P, _VIRT_SLOT, slot)
        vcode = vcodes[:, v].to(torch.int32)[:, None]
        sub = torch.where(qi == vcode, float(MATCH), float(MISMATCH))
        sub = torch.where((qi >= 4) | (vcode >= 4), float(MISMATCH), sub).to(f32)
        row = torch.zeros((B, W), dtype=f32, device=dev)
        row[:, 1:] = (m_best[:, 1:] + sub).clamp_min(0.0)
        cells[:, v] = slot.to(torch.int32) | ((row > 0.0).to(torch.int32) << 4)

        m = row.max(dim=1).values
        jstar = torch.where(row == m[:, None], j_iota, W).min(dim=1).values  # first max
        in_range = v < nv
        better = (m > best) & in_range
        best = torch.where(better, m, best)
        bv = torch.where(better, v, bv)
        bj = torch.where(better, jstar, bj)
        H[:, v] = torch.where(in_range[:, None], row, 0.0)

    # traceback: matches only, until the zero floor (or j == 0)
    tape = torch.full((B, W), _END_FILL, dtype=torch.int32, device=dev)
    v = bv.to(torch.int64)
    j = bj.to(torch.int64)
    for t in range(W):
        vc = v.clamp(0, V - 1)
        bits = cells[bidx, vc, j.clamp(0, W - 1)]
        alive = (v >= 0) & (j > 0) & ((bits >> 4) > 0)
        if not bool(alive.any()):
            break  # a walk that stopped stays stopped
        nxt = torch.where((bits & 15) == _VIRT_SLOT, -2,
                          vpred[bidx, vc, (bits & 15).clamp_max(P - 1)].to(torch.int64))
        tape[:, t] = torch.where(alive, OP_M | ((v + 2) << 2), _END_FILL).to(torch.int32)
        v = torch.where(alive, nxt, v)
        j = torch.where(alive, j - 1, j)
    tlen = ((tape & 3) != OP_END).sum(dim=1).to(torch.int32)
    return best, tape, tlen, bj


LOCAL_WARP_WIDTHS = TB_WIDTHS  # rows poa_local_warp.cu takes: W = 32 C, C = 1/2/4/8


def _check_local_inputs(name, vcodes, vpred, nv, q):
    """The local POA's CUDA inputs as its kernels take them -> (B, V, P, L)."""
    B, V = vcodes.shape
    L = q.shape[1]
    P = vpred.shape[-1]
    checks = ((vcodes, torch.int8, (B, V)), (vpred, torch.int32, (B, V, P)),
              (nv, torch.int32, (B,)), (q, torch.int8, (B, L)))
    for t, dt, shape in checks:
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dt} {shape}, got {t.dtype} {tuple(t.shape)}")
    if P not in (2, 4, 8):
        raise ValueError(f"{name}: unsupported P={P} (2/4/8)")
    kernels.require_cuda(name, vcodes, vpred, nv, q)
    return B, V, P, L


def local_route(W: int) -> Tuple[str, int]:
    """(kernel, row width) ``poa_local`` launches for rows of W columns on
    the card: ``poa_local_warp`` or ``poa_local_cluster`` at
    ``route_width(W)``."""
    w = route_width(W)
    return ("poa_local_warp" if w in LOCAL_WARP_WIDTHS else "poa_local_cluster"), w


def poa_local(vcodes, vpred, nv, q, nq, back_rows=None):
    """Local gapless DP + traceback, by row width W = L + 1:
    ``poa_local_warp`` for W in LOCAL_WARP_WIDTHS (up to 256 columns),
    ``poa_local_cluster`` for W in CLUSTER_WIDTHS (512-16,384); both take
    ``back_rows``.  A row of another width up to 16,384 is padded on the
    right to the next of those widths (``pad_row``, exact) and its tape
    cut back to W entries.  Each runs the plain twin for CPU tensors.
    Same arguments and outputs as ``poa_local_plain``, except tlen -1 for a problem that
    needs more backing rows than ``back_rows`` gave it."""
    W = q.shape[1] + 1
    kernel, w = local_route(W)
    if w != W:
        q = pad_row(q, None, w)[0]
    if kernel == "poa_local_warp":
        best, tape, tlen, qend = poa_local_warp(vcodes, vpred, nv, q, nq, back_rows)[:4]
    else:
        best, tape, tlen, qend = poa_local_cluster(vcodes, vpred, nv, q, nq, back_rows)[:4]
    return best, tape[:, :W], tlen, qend


def _local_buffers(vcodes, vpred, nv, W: int, back_rows):
    """The local POA kernels' device buffers for a batch of rows of W
    columns: back_off [B + 1] (``_back_offsets`` at LOCAL_RING,
    LOCAL_PINS), the backing store [its rows, W] int16, cells [B, V, W]
    u8 (neither zeroed: only the host-counted rows exist, and the kernels
    write every cell a walk can read), best, tape [B, W], tlen, qend and
    n_backing."""
    B, V = vcodes.shape
    dev = vcodes.device
    off = _back_offsets(vpred, nv, back_rows)
    i32 = torch.int32
    return (_pinned_offsets(off, dev),
            torch.empty((max(int(off[-1]), 1), W), dtype=torch.int16, device=dev),
            torch.empty((B, V, W), dtype=torch.uint8, device=dev),
            torch.empty(B, dtype=torch.float32, device=dev),
            torch.empty((B, W), dtype=i32, device=dev), torch.empty(B, dtype=i32, device=dev),
            torch.empty(B, dtype=i32, device=dev), torch.empty(B, dtype=i32, device=dev))


def poa_local_warp(vcodes, vpred, nv, q, nq, back_rows=None):
    """Local gapless DP + traceback, one warp a problem: the CUDA kernel
    (kernels/csrc/poa_local_warp.cu) for CUDA tensors with W = L + 1 in
    LOCAL_WARP_WIDTHS, ``poa_local_plain`` for CPU tensors.  Same
    arguments as ``poa_local``, plus ``back_rows`` (the host's
    ``backing_rows_plain`` at LOCAL_RING, LOCAL_PINS per problem, which
    sizes the backing store; None counts them here) -> (best, tape, tlen,
    qend, n_backing): the first four as ``poa_local_plain`` gives them,
    except tlen -1 for a problem that needs more backing rows than
    ``back_rows`` gave it, and n_backing [B] int32 the kernel's own count
    of backing rows."""
    if vcodes.device.type == "cpu":
        return (*poa_local_plain(vcodes, vpred, nv, q, nq),
                backing_rows_plain(vpred, nv, LOCAL_RING, LOCAL_PINS))
    B, V, P, L = _check_local_inputs("poa_local_warp", vcodes, vpred, nv, q)
    W = L + 1
    if W not in LOCAL_WARP_WIDTHS:
        raise ValueError(f"poa_local_warp: unsupported row width W={W} {LOCAL_WARP_WIDTHS}")
    bufs = _local_buffers(vcodes, vpred, nv, W, back_rows)
    so = kernels.lib()
    kernels.LAUNCHES["poa_local_warp"] += 1
    kernels.check(
        so.vg_poa_local_warp(vcodes.data_ptr(), vpred.data_ptr(), nv.data_ptr(), q.data_ptr(),
                             B, V, P, L, *(x.data_ptr() for x in bufs),
                             kernels.stream_ptr(vcodes.device)),
        "poa_local_warp",
    )
    return bufs[3:]


def poa_local_warp_occupancy(P: int, W: int, V: int) -> Tuple[int, int, int]:
    """(problems a block holds, blocks an SM keeps resident, dynamic
    shared memory per block in bytes) of ``poa_local_warp``'s kernel at
    this shape, from the CUDA occupancy calculator.  Needs the card."""
    out = (ctypes.c_int * 3)()
    kernels.check(kernels.lib().vg_poa_local_warp_occupancy(P, W, V, ctypes.addressof(out)),
                  "poa_local_warp_occupancy")
    return out[0], out[1], out[2]


def poa_local_cluster(vcodes, vpred, nv, q, nq, back_rows=None):
    """Local gapless DP + traceback, one thread-block cluster a problem:
    the CUDA kernel (kernels/csrc/poa_local_cluster.cu) for CUDA tensors
    with W = L + 1 in CLUSTER_WIDTHS, ``poa_local_plain`` for CPU tensors.
    Same arguments as ``poa_local``, plus ``back_rows`` (the host's
    ``backing_rows_plain`` at LOCAL_RING, LOCAL_PINS per problem, which
    sizes the backing store; None counts them here) -> (best, tape, tlen,
    qend, n_backing): the first four as ``poa_local_plain`` gives them,
    except tlen -1 for a problem that needs more backing rows than
    ``back_rows`` gave it, and n_backing [B] int32 the kernel's own count
    of backing rows.  Raises where the card cannot keep one cluster of
    this shape resident."""
    if vcodes.device.type == "cpu":
        return (*poa_local_plain(vcodes, vpred, nv, q, nq),
                backing_rows_plain(vpred, nv, LOCAL_RING, LOCAL_PINS))
    B, V, P, L = _check_local_inputs("poa_local_cluster", vcodes, vpred, nv, q)
    W = L + 1
    if W not in CLUSTER_WIDTHS:
        raise ValueError(f"poa_local_cluster: unsupported row width W={W} {CLUSTER_WIDTHS}")
    ctas, clusters, smem = poa_local_cluster_occupancy(P, W, V)
    if clusters <= 0:
        raise RuntimeError(f"poa_local_cluster: no cluster of {ctas} CTAs with {smem} B of "
                           f"shared memory each can be resident (P={P}, W={W}, V={V})")
    bufs = _local_buffers(vcodes, vpred, nv, W, back_rows)
    so = kernels.lib()
    kernels.LAUNCHES["poa_local_cluster"] += 1
    kernels.check(
        so.vg_poa_local_cluster(vcodes.data_ptr(), vpred.data_ptr(), nv.data_ptr(), q.data_ptr(),
                                B, V, P, L, *(x.data_ptr() for x in bufs),
                                kernels.stream_ptr(vcodes.device)),
        "poa_local_cluster",
    )
    return bufs[3:]


@functools.lru_cache(maxsize=None)
def poa_local_cluster_occupancy(P: int, W: int, V: int) -> Tuple[int, int, int]:
    """(CTAs a cluster, clusters the card keeps resident at once, dynamic
    shared memory per CTA in bytes) of ``poa_local_cluster``'s kernel at
    this shape, from the CUDA occupancy calculator.  Needs the card."""
    out = (ctypes.c_int * 3)()
    kernels.check(kernels.lib().vg_poa_local_cluster_occupancy(P, W, V, ctypes.addressof(out)),
                  "poa_local_cluster_occupancy")
    return out[0], out[1], out[2]


def align_local_batch(problems: Sequence[Tuple[Sequence[str], Sequence[Tuple[int, int]], str]],
                      device: torch.device) -> list:
    """Local gapless alignment (rspoa engine) of (nodes, edges, query)
    problems on ``device``: bucketed by (pow2 V >= 256, query ladder),
    one ``poa_local`` batch per bucket; subgraphs above 8,192 base
    vertices go to the shared host oracle.  Equal to the JAX package's
    ``align_local_batch``."""
    from .poa import align_local_no_gap_host, build_base_graph
    from ..utils.dna import encode_seq

    qs_all = [encode_seq(q) for _, _, q in problems]
    bgs_all = [build_base_graph(n, e) for n, e, _ in problems]
    buckets: dict = {}
    out = [None] * len(problems)
    for i, (bg, q) in enumerate(zip(bgs_all, qs_all)):
        if len(bg.codes) > 8192:
            out[i] = align_local_no_gap_host(*problems[i])
            continue
        key = (_next_pow2(max(len(bg.codes), 256)), _l_pad_for(len(q)))
        buckets.setdefault(key, []).append(i)
    # launch every chunk of every bucket, then drain them in order
    pend = []
    for (v_pad, l_pad), idxs in sorted(buckets.items()):
        bgs, qs = [bgs_all[i] for i in idxs], [qs_all[i] for i in idxs]
        for s, e, out_d in _dispatch_local_bucket(bgs, qs, v_pad, l_pad, device):
            pend.append((idxs[s:e], bgs[s:e], qs[s:e], out_d))
    for idxs, bgs, qs, out_d in pend:
        fetched = [x.cpu().numpy() for x in out_d]
        for i, res in zip(idxs, _decode_local_bucket(bgs, qs, fetched)):
            out[i] = res
    return out


# per-launch device-memory budget of the local POA route
_LOCAL_BUDGET = 6 << 30


def local_problem_bytes(V: int, W: int, P: int, back_rows: np.ndarray) -> np.ndarray:
    """Device bytes one local POA problem of a (V, W) batch takes on the
    route ``local_route(W)`` picks (row width w), per problem of
    ``back_rows`` (its host-counted backing rows): the inputs (codes and P
    predecessor ids a vertex, the query, nv, nq and its backing offset),
    the u8 cell plane V x w, the tape w i32, the scalars (best, tlen,
    qend, n_backing), 2w bytes a backing row (int16, on both routes:
    poa_local_warp.cu and poa_local_cluster.cu), and the query
    right-padded to w - 1 columns where w != W."""
    w = local_route(W)[1]
    fixed = V * (1 + 4 * P) + (W - 1) + 12 + V * w + 4 * w + 16
    if w != W:
        fixed += w - 1
    return fixed + 2 * w * np.asarray(back_rows, dtype=np.int64)


def local_chunks(bgs, qs, v_pad: int, l_pad: int, budget: int = None):
    """One (V, L) bucket as launches of real problems only, each under
    ``budget`` device bytes (``_LOCAL_BUDGET``; a problem over it runs
    alone): yields (start, end, (vcodes, vpred, nv, q, nq), back_rows),
    numpy arrays of problems [start, end), vpred sliced to the bucket's
    fan-in and back_rows the host's backing-row count per problem."""
    budget = _LOCAL_BUDGET if budget is None else budget
    probs = [prepare_problem(bg, q, v_pad, l_pad) for bg, q in zip(bgs, qs)]
    arrs = (np.stack([p.vcodes for p in probs]), _slice_preds(np.stack([p.vpred for p in probs])),
            np.asarray([p.nv for p in probs], dtype=np.int32), np.stack([p.q for p in probs]),
            np.asarray([p.nq for p in probs], dtype=np.int32))
    back = backing_rows_plain(torch.from_numpy(arrs[1]), torch.from_numpy(arrs[2]),
                              LOCAL_RING, LOCAL_PINS).numpy().astype(np.int64)
    cost = np.cumsum(local_problem_bytes(v_pad, l_pad + 1, arrs[1].shape[-1], back))
    s = 0
    while s < len(probs):
        base = cost[s - 1] if s else 0
        e = max(s + 1, int(np.searchsorted(cost, base + budget, side="right")))
        yield s, e, tuple(a[s:e] for a in arrs), back[s:e]
        s = e


def _dispatch_local_bucket(bgs, qs, v_pad: int, l_pad: int, device: torch.device):
    """Launch ``poa_local`` on each chunk of one bucket (``local_chunks``)
    -> [(start, end, outputs on the device)]."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return [(s, e, poa_local(*(t(a) for a in arrs), back_rows=back))
            for s, e, arrs, back in local_chunks(bgs, qs, v_pad, l_pad)]


def _decode_local_bucket(bgs, qs, fetched):
    """Tapes -> PoaResults: match or mismatch per step, query positions
    ending at qend.  Raises on a tlen of -1 (the local POA kernels' mark of
    a problem short of backing rows)."""
    from .poa import _finish_result

    best, tape, tlens, qends = fetched
    if (tlens < 0).any():
        raise RuntimeError("the local POA route: a problem needs more backing rows than the host "
                           "counted")
    ops, vids = unpack_tape(tape)
    results = []
    for i, (bg, q) in enumerate(zip(bgs, qs)):
        t = int(tlens[i])
        qe = int(qends[i])
        qs_ = qe - t
        triples = []
        qpos = qs_
        for v in vids[i][:t][::-1]:
            kind = "M" if v >= 0 and q[qpos] == bg.codes[v] else "X"
            triples.append((kind, int(v), qpos))
            qpos += 1
        results.append(_finish_result(bg, q, triples, int(best[i]), qs_, qe))
    return results
