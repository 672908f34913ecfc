"""Scalar host restatement of the reference mapping semantics.

Two roles:
  * test oracle — the device DP kernel (ops/chain.py) is property-tested
    for exact f64 equality against this implementation;
  * benchmark baseline proxy — the reference (rs-vgaligner) is a
    single-threaded CPU program (SURVEY.md §1: rayon compiled out), so a
    single-threaded host run of the same per-read loop stands in for it
    when the Rust toolchain is unavailable.

Mirrors chain_anchors/score_anchor (rs-vgaligner src/chain.rs:274-655)
as literally as possible: double loop, descending-j window, strict-
improvement predecessor updates, curr_max over all proposals, predecessor-
nulling backtrack.  Forward-only anchors (the production path, map.rs:62).
"""

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

NEG = -1.7976931348623157e308  # -f64::MAX


@dataclass
class HAnchor:
    id: int
    qb: int
    qe: int
    tb: int
    te: int
    f: float = 0.0
    pred: Optional[int] = None  # anchor id


def score_anchor(a: HAnchor, b: HAnchor, seed_length: int, max_gap: int) -> float:
    """score_anchor (chain.rs:274-368), forward-only orients."""
    if a.qe >= b.qe or a.te >= b.te:
        return NEG
    ql = min(b.qb - a.qb, b.qe - a.qe)
    tbd = abs(b.tb - a.tb)
    ted = abs(b.te - a.te)
    tl = min(tbd, ted)
    gap = abs(ql - tl)
    if gap > max_gap:
        return NEG
    gcost = 0.0 if gap == 0 else 0.01 * seed_length * gap + 0.5 * math.log2(gap)
    mlen = min(ql, tl, seed_length)
    y = (a.f + mlen - gcost) * 1000.0
    r = math.floor(y + 0.5) if y >= 0 else math.ceil(y - 0.5)
    return r / 1000.0


def chain_anchors_host(
    anchors: List[HAnchor],
    seed_length: int,
    bandwidth: int,
    max_gap: int,
    chain_min_n_anchors: int,
) -> Tuple[List[List[int]], float, List[HAnchor]]:
    """(chains as id lists ascending, curr_max, sorted anchors) —
    chain_anchors (chain.rs:370-655)."""
    anchors = sorted(anchors, key=lambda a: a.te)  # stable; orient uniform
    for a in anchors:
        a.f = float(seed_length)
        a.pred = None

    curr_max = 0.0
    for i in range(1, len(anchors)):
        min_j = 0 if bandwidth > i else i - bandwidth
        for j in range(i - 1, min_j - 1, -1):
            prop = score_anchor(anchors[j], anchors[i], seed_length, max_gap)
            if prop > anchors[i].f:
                anchors[i].f = prop
                anchors[i].pred = anchors[j].id
            if prop > curr_max:
                curr_max = prop

    chains: List[List[int]] = []
    if anchors:
        id_to_pos = {a.id: p for p, a in enumerate(anchors)}
        for i in range(len(anchors) - 1, -1, -1):
            cur = anchors[i]
            if cur.pred is not None and cur.f == curr_max:
                chain: List[int] = []
                while cur.pred is not None:
                    pred_id = cur.pred
                    cur.pred = None
                    chain.append(cur.id)
                    cur = anchors[id_to_pos[pred_id]]
                chain.append(cur.id)
                if len(chain) >= chain_min_n_anchors:
                    chain.reverse()
                    chains.append(chain)
    return chains, curr_max, anchors


def map_read_host(index, seq: str, bandwidth=50, max_gap=1000, chain_min_n_anchors=3):
    """Single-read host mapping (baseline proxy for the reference's
    per-read loop, map.rs:56-111)."""
    k = index.kmer_length
    anchors: List[HAnchor] = []
    aid = 0
    if len(seq) >= k:
        for i in range(len(seq) - k + 1):
            for so, sp, eo, ep in index.find_positions_for_query_kmer(seq[i : i + k]):
                if so == 0 and eo == 0:
                    anchors.append(HAnchor(id=aid, qb=i, qe=i + k, tb=sp, te=ep))
                    aid += 1
    return chain_anchors_host(anchors, k, bandwidth, max_gap, chain_min_n_anchors)
