"""Batched global POA on the device: plain twins, kernel wrappers, and
the dispatch/finish pair around them.

Counterpart of the slice of ``vgaligner_tpu/ops/poa_device.py`` that the
``map -p abpoa --also-align`` path runs.  Problem arrays come from the
native builder; each ladder-padded chunk runs the POA DP
(``poa_dp``: kernels/csrc/poa_dp.cu on CUDA, ``poa_dp_plain`` on the
CPU) and the traceback (``poa_traceback``: kernels/csrc/poa_traceback.cu
or ``poa_traceback_plain``); each chunk's tape comes back sliced to its
longest walk and the native runtime decodes it into cigar/cs/node paths.

Scores are integer-valued f32 with abPOA's defaults (match 2, mismatch
-4, gaps 4+2g and 24+g).  Decision bits per cell (int32):
  0-2 case at H (0 match, 1 E1, 2 E2, 3 F1, 4 F2); 3-6 match pred slot
  (15 = virtual source); 7 E1 opened; 8-11 E1 slot; 12 E2 opened;
  13-16 E2 slot; 17 F1 opened; 18 F2 opened.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import kernels
from .._shared import require_native
from .._shared.native import finish_tapes_native
from .._shared.ops.poa import GAP_EXT1, GAP_EXT2, GAP_OPEN1, GAP_OPEN2, MATCH, MISMATCH

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


# batch-dim pads: one of a few shapes per chunk
_B_LADDER = (8, 32, 128, 256, 512, 1024)
# per-chunk device-memory budget: tbits, the [V+1, 3W] f32 state and
# temporaries come to about 7 [V, W] planes of 4 bytes per problem
_HBM_BUDGET = 6 << 30


def _b_chunk_for(v_pad: int, l_pad: int) -> int:
    per_problem = v_pad * (l_pad + 1) * 4 * 7
    b = _HBM_BUDGET // max(per_problem, 1)
    if v_pad >= 2048:
        # the vertex loop runs to each chunk's max nv; smaller V-sorted
        # chunks keep that bound tight on widely spread big-V buckets
        b = min(b, 128)
    for cand in reversed(_B_LADDER):
        if cand <= b:
            return cand
    return _B_LADDER[0]


def _b_pad_for(n: int) -> int:
    for b in _B_LADDER:
        if n <= b:
            return b
    return _next_pow2(n)


def padded_rows(n: int, v_pad: int, l_pad: int) -> int:
    """Rows the problem builder allocates so every chunk (the last one
    ladder-padded) is a view; the extra rows are zeroed throwaways."""
    if n <= 0:
        return n
    b_chunk = _b_chunk_for(v_pad, l_pad)
    s_last = (n - 1) // b_chunk * b_chunk
    return s_last + _b_pad_for(n - s_last)


def _iter_chunks(built, qs, v_pad: int, l_pad: int):
    """Yield (chunk arrays, chunk queries) in ladder-sized chunks."""
    vcodes = built[0]
    n = len(qs)
    b_chunk = _b_chunk_for(v_pad, l_pad)
    for s in range(0, n, b_chunk):
        e = min(s + b_chunk, n)
        b_pad = _b_pad_for(e - s)
        if vcodes.shape[0] >= s + b_pad:
            chunk = tuple(a[s : s + b_pad] for a in built)
        else:
            def zpad(a):
                out = np.zeros((b_pad,) + a.shape[1:], dtype=a.dtype)
                out[: e - s] = a[s:e]
                return out

            chunk = tuple(zpad(a) for a in built)
        yield chunk, qs[s:e]


def _pad_queries(qs, b_pad: int, l_pad: int):
    """Ladder-padded query codes + lengths for one chunk."""
    n_real = len(qs)
    q_pad = np.full((b_pad, l_pad), 4, dtype=np.int8)
    nq = np.zeros(b_pad, dtype=np.int32)
    lens = [len(qc) for qc in qs]
    nq[:n_real] = lens
    if n_real and min(lens) == max(lens):
        q_pad[:n_real, : lens[0]] = qs
    else:
        for i, qc in enumerate(qs):
            q_pad[i, : len(qc)] = qc
    return q_pad, nq


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


def poa_dp(vcodes, vpred, is_sink, nv, q, nq, init_row):
    """POA DP: the CUDA kernel for CUDA tensors, the plain twin for CPU
    tensors.  Same arguments and outputs as ``poa_dp_plain`` (tbits rows
    at or past nv are unspecified)."""
    if vcodes.device.type == "cpu":
        return poa_dp_plain(vcodes, vpred, is_sink, nv, q, nq, init_row)
    B, V = vcodes.shape
    L = q.shape[1]
    P = vpred.shape[-1]
    W = L + 1
    checks = (
        (vcodes, torch.int8, (B, V)), (vpred, torch.int32, (B, V, P)),
        (is_sink, torch.uint8, (B, V)), (nv, torch.int32, (B,)),
        (q, torch.int8, (B, L)), (nq, torch.int32, (B,)), (init_row, torch.float32, (W,)),
    )
    for t, dt, shape in checks:
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"poa_dp: expected {dt} {shape}, got {t.dtype} {tuple(t.shape)}")
    if P not in (2, 4, 8) or W % 32 or W > 1024:
        raise ValueError(f"poa_dp: unsupported P={P} or W={W} (P in 2/4/8, W % 32 == 0, <= 1024)")
    kernels.require_cuda("poa_dp", vcodes, vpred, is_sink, nv, q, nq, init_row)
    dev = vcodes.device
    S = torch.empty((B, V + 1, 3 * W), dtype=torch.float32, device=dev)
    score = torch.empty(B, dtype=torch.float32, device=dev)
    best_sink = torch.empty(B, dtype=torch.int32, device=dev)
    tbits = torch.empty((B, V, W), dtype=torch.int32, device=dev)
    so = kernels.lib()
    kernels.LAUNCHES["poa_dp"] += 1
    kernels.check(
        so.vg_poa_dp(vcodes.data_ptr(), vpred.data_ptr(), is_sink.data_ptr(), nv.data_ptr(),
                     q.data_ptr(), nq.data_ptr(), init_row.data_ptr(), B, V, P, L,
                     S.data_ptr(), score.data_ptr(), best_sink.data_ptr(),
                     tbits.data_ptr(), kernels.stream_ptr(dev)),
        "poa_dp",
    )
    return score, best_sink, tbits


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


def poa_traceback(tbits, vpred, best_sink, nq):
    """Traceback: the CUDA kernel for CUDA tensors, the plain twin for
    CPU tensors.  Same arguments and outputs as ``poa_traceback_plain``."""
    if tbits.device.type == "cpu":
        return poa_traceback_plain(tbits, vpred, best_sink, nq)
    B, V, C = tbits.shape
    P = vpred.shape[-1]
    checks = ((tbits, torch.int32, (B, V, C)), (vpred, torch.int32, (B, V, P)),
              (best_sink, torch.int32, (B,)), (nq, torch.int32, (B,)))
    for t, dt, shape in checks:
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(
                f"poa_traceback: expected {dt} {shape}, got {t.dtype} {tuple(t.shape)}")
    kernels.require_cuda("poa_traceback", tbits, vpred, best_sink, nq)
    dev = tbits.device
    T = V + C + 1
    tape = torch.empty((B, T), dtype=torch.int32, device=dev)
    tlen = torch.empty(B, dtype=torch.int32, device=dev)
    so = kernels.lib()
    kernels.LAUNCHES["poa_traceback"] += 1
    kernels.check(
        so.vg_poa_traceback(tbits.data_ptr(), vpred.data_ptr(), best_sink.data_ptr(),
                            nq.data_ptr(), B, V, C, P, tape.data_ptr(), tlen.data_ptr(),
                            kernels.stream_ptr(dev)),
        "poa_traceback",
    )
    return tape, tlen


# ---------------------------------------------------------------------------
# dispatch / finish

def kernel_dispatch(chunk, qs, v_pad: int, l_pad: int, device: torch.device):
    """Launch DP + traceback on one ladder-padded chunk without waiting
    for the device.  Returns the pending state for ``kernel_finish_all``."""
    vcodes, vpred, is_sink, nv, node_of, off_in = chunk
    n_real = len(qs)
    b_pad = vcodes.shape[0]
    q_pad, nq = _pad_queries(qs, b_pad, l_pad)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    vpred_d = t(_slice_preds(vpred, n_real).astype(np.int32))
    nq_d = t(nq)
    score, best_sink, tbits = poa_dp(
        t(vcodes.astype(np.int8, copy=False)), vpred_d,
        t(is_sink.astype(np.uint8, copy=False)), t(nv.astype(np.int32, copy=False)),
        t(q_pad), nq_d, t(make_init_row(l_pad)),
    )
    tape, tlen = poa_traceback(tbits, vpred_d, best_sink, nq_d)
    return (score, tape, tlen), vcodes, node_of, off_in, q_pad, v_pad, n_real, qs


def kernel_finish_all(pendings) -> List:
    """Drain dispatched chunks (scores and lengths, then each tape sliced
    to its longest walk) and decode them into PoaResults, in order."""
    out: List = []
    for p in pendings:
        score, tape, tlen = p[0]
        n_real = p[6]
        tlen_h = tlen.cpu().numpy()
        used = max(1, int(tlen_h[:n_real].max()) if n_real else 1)
        out.extend(_decode_finished(
            p, (score.cpu().numpy(), tape[:, :used].cpu().numpy(), tlen_h)
        ))
    return out


def _decode_finished(pending, fetched):
    from .._shared.ops.poa import PoaResult

    require_native()
    _d, vcodes, node_of, off_in, q_pad, v_pad, n_real, qs = pending
    scores, tape, tlens = fetched
    ops, vids = unpack_tape(tape)
    bg_off = np.arange(n_real + 1, dtype=np.int64) * v_pad
    cigars, css, node_paths, path_vertices, scalars = finish_tapes_native(
        ops[:n_real], vids[:n_real], tlens[:n_real].astype(np.int32),
        bg_off, vcodes[:n_real].reshape(-1), node_of[:n_real].reshape(-1),
        off_in[:n_real].reshape(-1), q_pad[:n_real],
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
    """Dispatch every chunk of one (v_pad, l_pad) bucket."""
    return [kernel_dispatch(chunk, cqs, v_pad, l_pad, device)
            for chunk, cqs in _iter_chunks(built, qs, v_pad, l_pad)]
