"""A chain's subgraph: the corridor between its anchors.

Two walks that keep to forward handles, one forward from the node of
the densest anchor window's first anchor and one backward from its
last, each with a budget of the read's length + 128 bases; the nodes
both reach, the two ends, and the nodes that cover the read's
unanchored prefix and suffix; in topological order, smallest id first
on ties.  The end nodes' labels are cut to the budget around the
anchors.  Edges are those between members, forward in that order.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Tuple

import numpy as np

SLACK = 128


def _walk(graph, start: int, budget: int, incoming: bool) -> Dict[int, int]:
    best: Dict[int, int] = {}
    frontier = [(budget, start)]
    while frontier:
        nxt = []
        for rem, n in frontier:
            if best.get(n, -1) >= rem:
                continue
            best[n] = rem
            rem2 = rem - len(graph.labels[n - 1])
            if rem2 > 0:
                nbrs = graph.inc[n - 1] if incoming else graph.out[n - 1]
                nxt.extend((rem2, t) for t in nbrs)
        frontier = nxt
    return best


def _topo(graph, members: set) -> List[int]:
    indeg = {n: 0 for n in members}
    succ = {n: [] for n in members}
    for n in members:
        for t in graph.out[n - 1]:
            if t in indeg and t != n:
                succ[n].append(t)
                indeg[t] += 1
    ready = [n for n, d in indeg.items() if d == 0]
    heapq.heapify(ready)
    out = []
    while ready:
        n = heapq.heappop(ready)
        out.append(n)
        for t in succ[n]:
            indeg[t] -= 1
            if indeg[t] == 0:
                heapq.heappush(ready, t)
    if len(out) < len(members):
        done = set(out)
        out.extend(sorted(n for n in members if n not in done))
    return out


def corridor(graph, qlen: int, k: int, aqb, atb, ate):
    """(node ids in order, labels, 0-based edges, label trim start a node)."""
    na = len(atb)
    span_cap = qlen + 2 * SLACK
    bi, bj = 0, na - 1
    if na and int(ate[-1] - atb[0]) > span_cap:
        best_cnt, i = 0, 0
        for j in range(na):
            while int(ate[j] - atb[i]) > span_cap:
                i += 1
            if j - i + 1 > best_cnt:
                best_cnt, bi, bj = j - i + 1, i, j
    tb0, te1 = int(atb[bi]), int(ate[bj])
    (nb,), _ = graph.node_of(np.asarray([tb0]))
    (ne,), _ = graph.node_of(np.asarray([te1 - 1]))
    nb, ne = int(nb), int(ne)
    budget = qlen + SLACK
    start_off = tb0 - graph.start(nb)
    end_gap = graph.start(ne + 1) - te1
    fwd = _walk(graph, nb, start_off + budget, incoming=False)
    bwd = _walk(graph, ne, end_gap + budget, incoming=True)
    members = set(fwd) & set(bwd)
    members |= {nb, ne}
    prefix = max(0, int(aqb[bi]) - max(0, start_off))
    if prefix > 0:
        for n in graph.inc[nb - 1]:
            members |= set(_walk(graph, n, prefix, incoming=True))
    suffix = max(0, qlen - (int(aqb[bj]) + k) - max(0, end_gap))
    if suffix > 0:
        for n in graph.out[ne - 1]:
            members |= set(_walk(graph, n, suffix, incoming=False))
    nodes = _topo(graph, members)
    trims: Dict[int, Tuple[int, int]] = {}
    t_from = start_off - budget
    if t_from > 0:
        trims[nb] = (t_from, len(graph.labels[nb - 1]))
    t_to = te1 - graph.start(ne) + budget
    if t_to < len(graph.labels[ne - 1]):
        trims[ne] = (trims.get(ne, (0, 0))[0], t_to)
    pos = {n: i for i, n in enumerate(nodes)}
    labels = [graph.labels[n - 1] for n in nodes]
    for n, (a, b) in trims.items():
        labels[pos[n]] = labels[pos[n]][a:b]
    edges = [(pos[n], pos[t]) for n in nodes for t in graph.out[n - 1] if t in pos]
    edges = [e for e in edges if e[0] < e[1]]
    lbase = [trims.get(n, (0, 0))[0] for n in nodes]
    return nodes, labels, edges, lbase


def subgraph_gfa(graph, nodes: List[int], labels: List[str], edges) -> bytes:
    """The subgraph's GFA as rs-vgaligner exports it (validate.rs:160-205):
    a space-separated header, nodes renumbered 1.. in order, forward
    links, and every path of the graph cut to the subgraph's nodes, its
    ids rebased to the smallest id there."""
    members = set(nodes)
    lo = min(nodes)
    head = f"H VN:Z:1.0 NS:i:{len(nodes)} NL:i:{len(edges)} NP:i:0\n"
    s_lines = "".join(f"S\t{i + 1}\t{lab}\n" for i, lab in enumerate(labels))
    l_lines = "".join(f"L\t{a + 1}\t+\t{b + 1}\t+\t0M\n" for a, b in edges)
    p_lines = "".join(
        "P\t%d\t%s\t*\n" % (pid, ",".join(f"{n - lo + 1}+" for n in path if n in members))
        for pid, path in enumerate(graph.paths))
    return (head + s_lines + l_lines + p_lines).encode()
