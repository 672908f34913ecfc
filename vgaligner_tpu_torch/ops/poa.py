"""Partial-order alignment engines.

Behavioral reference: the two POA backends of rs-vgaligner src/align.rs —
  * abPOA (C FFI, align.rs:170-224): banded partial-order alignment of
    the query against the chain-implied subgraph, Global mode, with
    abPOA's default convex (two-piece affine) gap model
    (match 2, mismatch -4, gap_open1 4 / gap_ext1 2, gap_open2 24 /
    gap_ext2 1 — abPOA's documented defaults);
  * rspoa's align_local_no_gap (align.rs:160-164): local, gapless.

The subgraph ("abstraction nodes" + 0-based edges, align.rs:670-724) is
expanded to a base-level DAG whose vertices are single bases; the DP runs
over vertices in topological order.  This module provides the host
(numpy) implementations — the behavioral oracle and the --also-align
production path; the Pallas/JAX anti-diagonal wavefront kernel batches
the same recurrence on device (see poa_device.py).

Exact note: the reference's numbers come from a specific abPOA build; we
reproduce the algorithm and scoring defaults, not the C library bit for
bit (tie-break conventions documented inline).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.dna import encode_seq

NEG = -(10**9)

# abPOA default scoring (abpoa -M 2 -X 4 -O 4,24 -E 2,1)
MATCH = 2
MISMATCH = -4
GAP_OPEN1, GAP_EXT1 = 4, 2
GAP_OPEN2, GAP_EXT2 = 24, 1


def gap_cost(length: int) -> int:
    """Convex two-piece gap cost: min of the two affine pieces."""
    if length == 0:
        return 0
    return min(GAP_OPEN1 + length * GAP_EXT1, GAP_OPEN2 + length * GAP_EXT2)


@dataclass
class BaseGraph:
    """Base-level DAG in topological order."""

    codes: np.ndarray  # int8 [V] base codes
    node_of: np.ndarray  # int32 [V] abstraction-node index per vertex
    preds: List[List[int]]  # per-vertex predecessor vertex ids (topo ids)
    is_source: np.ndarray  # bool [V]
    is_sink: np.ndarray  # bool [V]
    offset_in_node: np.ndarray  # int32 [V]


def build_base_graph(nodes: Sequence[str], edges: Sequence[Tuple[int, int]]) -> BaseGraph:
    """Expand abstraction nodes/edges into a base-level DAG.

    Node-level topological order via Kahn's algorithm, stable in list
    order; if the edge set is cyclic (possible only for Both-orient
    ranges, where the reference skips loop removal, align.rs:717-721),
    remaining nodes are appended in list order with their unresolved
    in-edges dropped — a documented divergence from feeding abPOA a
    cyclic graph.
    """
    n = len(nodes)
    out_edges: List[List[int]] = [[] for _ in range(n)]
    indeg = [0] * n
    for a, b in edges:
        out_edges[a].append(b)
        indeg[b] += 1

    topo: List[int] = []
    ready = [i for i in range(n) if indeg[i] == 0]
    seen = [False] * n
    while ready:
        cur = ready.pop(0)
        topo.append(cur)
        seen[cur] = True
        for b in out_edges[cur]:
            indeg[b] -= 1
            if indeg[b] == 0:
                ready.append(b)
    if len(topo) < n:  # cycle fallback
        topo.extend(i for i in range(n) if not seen[i])

    node_first: dict = {}
    node_last: dict = {}
    codes: List[int] = []
    node_of: List[int] = []
    offset_in_node: List[int] = []
    vid = 0
    order_pos = {node: pos for pos, node in enumerate(topo)}
    for node in topo:
        seq = encode_seq(nodes[node])
        node_first[node] = vid
        for off, c in enumerate(seq):
            codes.append(int(c))
            node_of.append(node)
            offset_in_node.append(off)
            vid += 1
        node_last[node] = vid - 1

    preds: List[List[int]] = [[] for _ in range(vid)]
    has_pred_node = [False] * n
    has_succ_node = [False] * n
    for a, b in edges:
        if order_pos[a] < order_pos[b]:  # drop cycle-fallback back-edges
            preds[node_first[b]].append(node_last[a])
            has_pred_node[b] = True
            has_succ_node[a] = True
    for node in topo:
        first = node_first[node]
        for v in range(first + 1, node_last[node] + 1):
            preds[v].append(v - 1)

    V = vid
    is_source = np.zeros(V, dtype=bool)
    is_sink = np.zeros(V, dtype=bool)
    for node in topo:
        if not has_pred_node[node]:
            is_source[node_first[node]] = True
        if not has_succ_node[node]:
            is_sink[node_last[node]] = True
    # vertices with no predecessors are always alignment entry points
    for v in range(V):
        if not preds[v]:
            is_source[v] = True

    return BaseGraph(
        codes=np.asarray(codes, dtype=np.int8),
        node_of=np.asarray(node_of, dtype=np.int32),
        preds=preds,
        is_source=is_source,
        is_sink=is_sink,
        offset_in_node=np.asarray(offset_in_node, dtype=np.int32),
    )


@dataclass
class PoaResult:
    cigar: str
    cs: str
    path_vertices: List[int]  # aligned vertices (M/X/D), topo ids
    node_path: List[int]  # deduped abstraction-node indices along the path
    aln_start_offset: int  # topo id of first aligned vertex
    aln_end_offset: int  # topo id of last aligned vertex
    n_aligned: int  # matched + mismatched bases
    best_score: int
    query_start: int
    query_end: int
    path_start_offset: int = 0  # offset of first aligned base in its node
    path_end_offset: int = 0
    residue_matches: int = 0


# case codes for traceback
_M, _E1, _E2, _F1, _F2 = 0, 1, 2, 3, 4


def align_global_host(
    nodes: Sequence[str], edges: Sequence[Tuple[int, int]], query: str
) -> PoaResult:
    """Global POA with convex gaps (abPOA semantics, align.rs:190-202).

    Tie-breaks: match > E1 > E2 > F1 > F2 at equal score; among
    predecessors the first in pred-list order wins; the best sink is the
    first in topological order achieving the maximum final score.
    """
    bg = build_base_graph(nodes, edges)
    q = encode_seq(query)
    V, L = len(bg.codes), len(q)

    init = np.empty(L + 1, dtype=np.int64)  # virtual source row
    init[0] = 0
    for j in range(1, L + 1):
        init[j] = -gap_cost(j)

    H = np.full((V, L + 1), NEG, dtype=np.int64)
    E1 = np.full((V, L + 1), NEG, dtype=np.int64)
    E2 = np.full((V, L + 1), NEG, dtype=np.int64)
    case = np.zeros((V, L + 1), dtype=np.int8)
    mpred = np.full((V, L + 1), -2, dtype=np.int32)  # -2 = virtual source
    e1pred = np.full((V, L + 1), -2, dtype=np.int32)
    e1open = np.zeros((V, L + 1), dtype=bool)
    e2pred = np.full((V, L + 1), -2, dtype=np.int32)
    e2open = np.zeros((V, L + 1), dtype=bool)
    f1open = np.zeros((V, L + 1), dtype=bool)
    f2open = np.zeros((V, L + 1), dtype=bool)

    for v in range(V):
        sub = np.where(q == bg.codes[v], MATCH, MISMATCH).astype(np.int64)
        if bg.codes[v] >= 4:
            sub[:] = MISMATCH
        sub = np.where(q >= 4, MISMATCH, sub)

        pred_rows_H = [init if not bg.preds[v] else None]
        plist = bg.preds[v] if bg.preds[v] else [-2]

        # E states and match, vectorized over j per predecessor
        e1_best = np.full(L + 1, NEG, dtype=np.int64)
        e1_src = np.full(L + 1, -2, dtype=np.int32)
        e1_opn = np.zeros(L + 1, dtype=bool)
        e2_best = np.full(L + 1, NEG, dtype=np.int64)
        e2_src = np.full(L + 1, -2, dtype=np.int32)
        e2_opn = np.zeros(L + 1, dtype=bool)
        m_best = np.full(L + 1, NEG, dtype=np.int64)
        m_src = np.full(L + 1, -2, dtype=np.int32)

        for p in plist:
            Hp = init if p == -2 else H[p]
            E1p = np.full(L + 1, NEG, dtype=np.int64) if p == -2 else E1[p]
            E2p = np.full(L + 1, NEG, dtype=np.int64) if p == -2 else E2[p]

            open1 = Hp - (GAP_OPEN1 + GAP_EXT1)
            ext1 = E1p - GAP_EXT1
            cand1 = np.maximum(open1, ext1)
            upd = cand1 > e1_best
            e1_best[upd] = cand1[upd]
            e1_src[upd] = p
            e1_opn[upd] = open1[upd] >= ext1[upd]  # open preferred on tie

            open2 = Hp - (GAP_OPEN2 + GAP_EXT2)
            ext2 = E2p - GAP_EXT2
            cand2 = np.maximum(open2, ext2)
            upd = cand2 > e2_best
            e2_best[upd] = cand2[upd]
            e2_src[upd] = p
            e2_opn[upd] = open2[upd] >= ext2[upd]

            m_cand = np.empty(L + 1, dtype=np.int64)
            m_cand[0] = NEG
            m_cand[1:] = Hp[:-1] + sub
            upd = m_cand > m_best
            m_best[upd] = m_cand[upd]
            m_src[upd] = p

        E1[v] = e1_best
        E2[v] = e2_best
        e1pred[v] = e1_src
        e1open[v] = e1_opn
        e2pred[v] = e2_src
        e2open[v] = e2_opn
        mpred[v] = m_src

        # combine M/E then the in-row F scan (3-state)
        h_pre = np.maximum(m_best, np.maximum(e1_best, e2_best))
        case_pre = np.where(
            m_best >= np.maximum(e1_best, e2_best),
            _M,
            np.where(e1_best >= e2_best, _E1, _E2),
        ).astype(np.int8)

        h_row = np.empty(L + 1, dtype=np.int64)
        f1 = NEG
        f2 = NEG
        c_row = np.empty(L + 1, dtype=np.int8)
        f1o = np.zeros(L + 1, dtype=bool)
        f2o = np.zeros(L + 1, dtype=bool)
        for j in range(L + 1):
            if j > 0:
                o1 = h_row[j - 1] - (GAP_OPEN1 + GAP_EXT1)
                x1 = f1 - GAP_EXT1
                f1o[j] = o1 >= x1
                f1 = max(o1, x1)
                o2 = h_row[j - 1] - (GAP_OPEN2 + GAP_EXT2)
                x2 = f2 - GAP_EXT2
                f2o[j] = o2 >= x2
                f2 = max(o2, x2)
            h = h_pre[j]
            c = case_pre[j]
            if j > 0:
                if f1 > h:
                    h, c = f1, _F1
                if f2 > h:
                    h, c = f2, _F2
            h_row[j] = h
            c_row[j] = c
        H[v] = h_row
        case[v] = c_row
        f1open[v] = f1o
        f2open[v] = f2o

    # best sink: first in topo order achieving the max final score
    sinks = np.where(bg.is_sink)[0]
    if len(sinks) == 0:
        sinks = np.asarray([V - 1])
    best_sink = int(sinks[np.argmax(H[sinks, L])])
    best_score = int(H[best_sink, L])

    # traceback
    ops: List[Tuple[str, int, int]] = []  # (op, vertex, query_pos)
    v, j = best_sink, L
    state = "H"
    while not (v == -2 and j == 0):
        if v == -2:  # leading insertion against the virtual source
            ops.append(("I", -1, j - 1))
            j -= 1
            continue
        if state == "H":
            c = case[v, j]
            if c == _M:
                qc, vc = q[j - 1] if j > 0 else 5, bg.codes[v]
                ops.append(("M" if qc == vc else "X", v, j - 1))
                v, j = int(mpred[v, j]), j - 1
            elif c == _E1:
                state = "E1"
            elif c == _E2:
                state = "E2"
            elif c == _F1:
                state = "F1"
            else:
                state = "F2"
        elif state in ("E1", "E2"):
            opn = (e1open if state == "E1" else e2open)[v, j]
            src = int((e1pred if state == "E1" else e2pred)[v, j])
            ops.append(("D", v, j))
            v = src
            if opn:
                state = "H"
        else:  # F1 / F2
            opn = (f1open if state == "F1" else f2open)[v, j]
            ops.append(("I", v, j - 1))
            j -= 1
            if opn:
                state = "H"

    ops.reverse()
    return _finish_result(bg, q, ops, best_score, 0, L)


_BASE = "ACGTN"
_BASE_L = "acgtn"


def _finish_result(bg: BaseGraph, q: np.ndarray, ops, best_score, qs, qe) -> PoaResult:

    # CIGAR (M covers both = and X, like abPOA's default cigar)
    cig_parts: List[str] = []
    run_op, run_len = None, 0
    for op, v, j in ops:
        c = "M" if op in ("M", "X") else op
        if c == run_op:
            run_len += 1
        else:
            if run_op is not None:
                cig_parts.append(f"{run_len}{run_op}")
            run_op, run_len = c, 1
    if run_op is not None:
        cig_parts.append(f"{run_len}{run_op}")
    cigar = "".join(cig_parts)

    # cs string (cs:Z: difference string)
    cs_parts: List[str] = ["cs:Z:"]
    match_run = 0
    i = 0
    while i < len(ops):
        op, v, j = ops[i]
        if op == "M":
            match_run += 1
            i += 1
            continue
        if match_run:
            cs_parts.append(f":{match_run}")
            match_run = 0
        if op == "X":
            cs_parts.append(f"*{_BASE_L[bg.codes[v]]}{_BASE_L[q[j]]}")
            i += 1
        elif op == "I":
            run = []
            while i < len(ops) and ops[i][0] == "I":
                run.append(_BASE_L[q[ops[i][2]]])
                i += 1
            cs_parts.append("+" + "".join(run))
        else:  # D
            run = []
            while i < len(ops) and ops[i][0] == "D":
                run.append(_BASE_L[bg.codes[ops[i][1]]])
                i += 1
            cs_parts.append("-" + "".join(run))
    if match_run:
        cs_parts.append(f":{match_run}")
    cs = "".join(cs_parts)

    path_vertices = [v for op, v, j in ops if op in ("M", "X", "D") and v >= 0]
    node_path: List[int] = []
    for v in path_vertices:
        n = int(bg.node_of[v])
        if not node_path or node_path[-1] != n:
            node_path.append(n)
    n_aligned = sum(1 for op, _, _ in ops if op in ("M", "X"))
    residue = sum(1 for op, _, _ in ops if op == "M")
    first_v = path_vertices[0] if path_vertices else 0
    last_v = path_vertices[-1] if path_vertices else 0
    return PoaResult(
        cigar=cigar,
        cs=cs,
        path_vertices=path_vertices,
        node_path=node_path,
        aln_start_offset=int(first_v),
        aln_end_offset=int(last_v),
        n_aligned=n_aligned,
        best_score=best_score,
        query_start=qs,
        query_end=qe,
        path_start_offset=int(bg.offset_in_node[first_v]) if path_vertices else 0,
        path_end_offset=int(bg.offset_in_node[last_v]) if path_vertices else 0,
        residue_matches=residue,
    )


def align_local_no_gap_host(
    nodes: Sequence[str], edges: Sequence[Tuple[int, int]], query: str
) -> PoaResult:
    """Local gapless POA (rspoa align_local_no_gap semantics,
    align.rs:160-164): best match/mismatch-only path, Smith-Waterman
    style zero floor, no insertions or deletions."""
    bg = build_base_graph(nodes, edges)
    q = encode_seq(query)
    V, L = len(bg.codes), len(q)

    H = np.zeros((V, L + 1), dtype=np.int64)
    src = np.full((V, L + 1), -2, dtype=np.int32)
    best, bv, bj = 0, 0, 0
    for v in range(V):
        sub = np.where(q == bg.codes[v], MATCH, MISMATCH).astype(np.int64)
        sub = np.where((q >= 4) | (bg.codes[v] >= 4), MISMATCH, sub)
        m_best = np.zeros(L + 1, dtype=np.int64)
        m_src = np.full(L + 1, -2, dtype=np.int32)
        m_best[0] = 0
        for p in bg.preds[v] or []:
            cand = np.empty(L + 1, dtype=np.int64)
            cand[0] = 0
            cand[1:] = H[p][:-1]
            upd = cand > m_best
            m_best[upd] = cand[upd]
            m_src[upd] = p
        row = np.empty(L + 1, dtype=np.int64)
        row[0] = 0
        row[1:] = np.maximum(m_best[1:] + sub, 0)
        H[v] = row
        src[v] = m_src
        vmax = int(row.max())
        if vmax > best:
            best, bv, bj = vmax, v, int(row.argmax())

    # traceback matches only
    ops: List[Tuple[str, int, int]] = []
    v, j = bv, bj
    while v != -2 and j > 0 and H[v, j] > 0:
        ops.append(("M" if q[j - 1] == bg.codes[v] else "X", v, j - 1))
        v, j = int(src[v, j]), j - 1
    ops.reverse()
    qs = ops[0][2] if ops else 0
    qe = ops[-1][2] + 1 if ops else 0
    return _finish_result(bg, q, ops, best, qs, qe)
