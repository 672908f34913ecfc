"""Chain -> subgraph -> POA on the device -> alignments GAF.

Counterpart of ``vgaligner_tpu/models/poa_aligner.py`` (reference:
align.rs), both engines.  Subgraph extraction (corridor, ``--range-mode
id``, ``--bubble-closure``) runs in the native runtime for both; the
JAX package's rspoa route extracts in Python, and the two give the same
nodes, edges, handles and label trims in every mode (the port's rspoa
tests hold the GAFs equal).

  * abPOA (global): native problem arrays and tape decoding around the
    device DP and traceback (ops/poa_device.py), launched in
    ``begin_alignments`` and drained in ``finish_alignments``.  Outliers
    stay on the host as in the JAX package: subgraphs above 8,192 base
    vertices go to the native host POA, and vertices with fan-in above 8
    to the Python oracle.
  * rspoa (local gapless): ``align_local_batch`` runs eagerly inside
    ``begin_alignments``, as in the JAX package; subgraphs above 8,192
    base vertices go to the host oracle, and a fan-in above 8 raises
    ValueError (the reference route's behaviour).  It exports no subgraph
    GFAs, whatever ``export_subgraphs`` says, as the JAX route does not.

The Python subgraph route (``find_range_chain`` through
``find_nodes_edges``, ``PoaAligner._range_for_chain``) and the per-chain
API on the host oracles (``best_alignment_for_query``,
``obtain_base_level_alignment``) are the JAX package's, line for line:
the same ranges as the native extractor, defined independently of it.
"""

from __future__ import annotations

import heapq
import logging
from dataclasses import dataclass
from enum import Enum
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..graph.handlegraph import handle_id, handle_is_reverse, handle_pack
from ..index.build import Index
from ..io.gaf import GAFAlignment
from ..native import (
    build_poa_batch_arrays,
    extract_subgraphs_native,
    path_index,
    poa_global_host_native,
    require_native,
    subgraph_paths_native,
)
from ..utils.dna import encode_seq
from ..utils.timing import TRACER, ready_event
from ..ops.poa_device import P_MAX, _l_pad_for, _next_pow2, align_local_batch, \
    dispatch_bucket, kernel_finish_all
from ..parallel.mesh import Mesh, rank_device
from .mapper import Chain

log = logging.getLogger(__name__)

# subgraphs above this base-vertex count run on the native host POA
_V_DEVICE_CAP = 8192


_U64 = 1 << 64


class RangeOrient(Enum):
    FORWARD = 0
    REVERSE = 1
    BOTH = 2


@dataclass
class OrientedGraphRange:
    orient: RangeOrient
    handles: List[int]
    # corridor-mode flank-node label trims: handle -> (from, to) within
    # the node label (None = whole labels; see find_range_chain_corridor)
    label_trims: Optional[dict] = None

    @property
    def first_handle(self) -> int:
        return self.handles[0]

    @property
    def last_handle(self) -> int:
        return self.handles[-1]


def find_range_chain(index: Index, chain: Chain) -> OrientedGraphRange:
    """Min/max anchor-endpoint handle -> node-id range (align.rs:267-402)."""
    n = chain.n_anchors
    pos = np.concatenate([chain.atb, chain.ate - 1])
    if chain.aso is None:
        orients = np.zeros(2 * n, dtype=np.int8)
    else:
        orients = np.concatenate([chain.aso, chain.aeo])
    ids, _ = index.node_ids_from_seqpos_vec(orients, pos)
    handles = (ids.astype(np.int64) << 1) | (orients != 0)
    min_handle = int(handles.min())
    max_handle = int(handles.max())
    lo, hi = handle_id(min_handle), handle_id(max_handle)

    min_rev = handle_is_reverse(min_handle)
    max_rev = handle_is_reverse(max_handle)
    if not min_rev and not max_rev:
        handles = [handle_pack(i, False) for i in range(lo, hi + 1)]
        orient = RangeOrient.FORWARD
    elif min_rev and max_rev:
        handles = [handle_pack(i, True) for i in range(lo, hi + 1)]
        orient = RangeOrient.REVERSE
    else:
        fwd = [handle_pack(i, False) for i in range(lo, hi + 1)]
        rev = [handle_pack(i, True) for i in range(lo, hi + 1)]
        handles = sorted(fwd + rev)
        orient = RangeOrient.BOTH

    if not handles and min_handle == max_handle:
        handles.append(min_handle)
    return OrientedGraphRange(orient=orient, handles=handles)


def _bfs_extend(index: Index, seeds: List[Tuple[int, int]], incoming: bool) -> List[int]:
    """Walk left (incoming) or right (outgoing), collecting every visited
    handle until the remaining length is covered (align.rs:551-656).

    The frontier is deduped per level keeping the max remaining budget:
    a handle reached with budget r covers a superset of any smaller
    budget, and callers only consume the collected handle SET — the
    reference's naive walk is exponential in bubbly regions."""
    collected: List[int] = []
    frontier = seeds
    guard = 0
    while frontier:
        guard += 1
        if guard > 10_000:  # the reference has no cycle guard; we fail loud
            raise RuntimeError("range extension did not converge (cyclic region?)")
        best: dict = {}
        for remaining, handle in frontier:
            if best.get(handle, -1) < remaining:
                best[handle] = remaining
        nxt: List[Tuple[int, int]] = []
        for remaining, handle in frontier:
            collected.append(handle)
            if best.get(handle) != remaining:
                continue
            best[handle] = None  # expand each handle once per level
            seq_len = len(index.seq_from_handle(handle))
            if seq_len < remaining:
                rem = remaining - seq_len
                neighbors = (
                    index.incoming_edges_from_handle(handle)
                    if incoming
                    else index.outgoing_edges_from_handle(handle)
                )
                nxt.extend((rem, h) for h in neighbors)
        frontier = nxt
    return collected


def extend_range_chain(index: Index, chain: Chain, old_range: OrientedGraphRange) -> OrientedGraphRange:
    """Widen the range by the unaligned query prefix/suffix
    (extend_range_chain_2, align.rs:523-665).

    The per-node corrections use u64 arithmetic that can wrap in the
    reference (release build); the wrap is reproduced so the
    "already-enough-sequence-on-node" test behaves identically.
    """
    handles = list(old_range.handles)

    prefix_diff = int(chain.aqb[0])
    first_handle = old_range.first_handle
    start_prefix_on_node = (
        int(chain.atb[0]) - index.get_bv_select(handle_id(first_handle))
    ) % _U64
    if start_prefix_on_node < prefix_diff:
        prefix_diff -= start_prefix_on_node
    else:
        prefix_diff = 0

    if prefix_diff > 0:
        seeds = [
            (prefix_diff, h) for h in index.incoming_edges_from_handle(first_handle)
        ]
        handles.extend(_bfs_extend(index, seeds, incoming=True))

    suffix_diff = len(chain.query.seq) - (int(chain.aqb[-1]) + chain.k)
    last_handle = old_range.last_handle
    end_suffix_on_node = (
        index.get_bv_select(handle_id(last_handle) + 1) - 1 - (int(chain.ate[-1]) - 1)
    ) % _U64
    if end_suffix_on_node > suffix_diff:
        suffix_diff = 0
    else:
        suffix_diff -= end_suffix_on_node

    if suffix_diff > 0:
        seeds = [
            (suffix_diff, h) for h in index.outgoing_edges_from_handle(last_handle)
        ]
        handles.extend(_bfs_extend(index, seeds, incoming=False))

    handles = sorted(set(handles))
    return OrientedGraphRange(orient=old_range.orient, handles=handles)


def _bfs_budget(index: Index, start_handle: int, budget: int, incoming: bool) -> dict:
    """Budgeted orientation-preserving walk from start_handle; returns
    {handle: best remaining budget at entry}.  Budget is measured in
    sequence bases consumed; the frontier dedupes per handle keeping the
    max remaining (a larger budget reaches a superset)."""
    best: dict = {}
    orient_bit = start_handle & 1
    frontier = [(budget, start_handle)]
    while frontier:
        nxt = []
        for rem, h in frontier:
            if best.get(h, -1) >= rem:
                continue
            best[h] = rem
            rem2 = rem - len(index.seq_from_handle(h))
            if rem2 > 0:
                nbrs = (
                    index.incoming_edges_from_handle(h)
                    if incoming
                    else index.outgoing_edges_from_handle(h)
                )
                nxt.extend((rem2, t) for t in nbrs if (t & 1) == orient_bit)
        frontier = nxt
    return best


def _topo_order(index: Index, members: set) -> List[int]:
    """Kahn topological order of the subgraph induced by `members`
    (successors = same-orientation outgoing edges), smallest handle
    first on ties; any cyclic remainder is appended in id order with
    its unresolved in-edges implicitly dropped by the position filter
    (mirrors build_base_graph's cycle handling)."""
    indeg = {h: 0 for h in members}
    succs = {h: [] for h in members}
    for h in members:
        for t in index.outgoing_edges_from_handle(h):
            if t in indeg and t != h:
                succs[h].append(t)
                indeg[t] += 1
    ready = [h for h, d in indeg.items() if d == 0]
    heapq.heapify(ready)
    out: List[int] = []
    while ready:
        h = heapq.heappop(ready)
        out.append(h)
        for t in succs[h]:
            indeg[t] -= 1
            if indeg[t] == 0:
                heapq.heappush(ready, t)
    if len(out) < len(members):
        done = set(out)
        out.extend(sorted(h for h in members if h not in done))
    return out


def find_range_chain_corridor(
    index: Index, chain: Chain, slack: int = 128
) -> Optional[OrientedGraphRange]:
    """Topology-aware replacement for the contiguous-id range (accuracy
    extension beyond the reference; VGALIGNER_RANGE_MODE=id restores
    strict parity).

    The reference's find_range_chain (align.rs:267-402) takes the
    min/max anchor-endpoint node ID: on graphs whose bubble alt-alleles
    carry ids far from their flanks (vg construct appends them after
    the backbone) that range either omits un-anchored alts entirely or
    — when an anchor lands on a high-id alt — spans the whole backbone
    between, forcing the global POA through kilobases of unrelated
    sequence, and the id-order edge filter (align.rs:717-721) turns
    every high-id alt into a dead-end sink that truncates alignments
    (the allele/truncate failure class dominating 5-B3106 / 8-C3107 /
    9-G-3135).

    The corridor instead intersects two budgeted orientation-preserving
    walks — forward from the chain's FIRST anchor node, backward from
    its LAST (budget = query length + slack bases each) — so it contains
    every branch of every bubble between the anchors and nothing else,
    then orders it topologically so the position-order edge filter
    keeps all real DAG edges.  Forward-orient chains only (production
    anchors are forward-only, map.rs:62); reverse/mixed chains return
    None and keep the reference range."""
    if chain.aso is not None and (
        np.any(chain.aso != 0) or np.any(chain.aeo != 0)
    ):
        return None

    # A chain's anchors can ladder across tandem repeat copies far
    # beyond the read (measured: 90 anchors of a 100 bp read spanning
    # 2.8 kb of DRB1 — the gap cost bounds each LINK, not the total).
    # Aligning the read globally against such a stretch is hopeless and
    # blows the subgraph up; keep only the densest anchor window whose
    # target span fits the read (+ slack both sides) and build the
    # corridor between ITS first and last anchors.
    atb_all = np.asarray(chain.atb, dtype=np.int64)
    ate_all = np.asarray(chain.ate, dtype=np.int64)
    na = len(atb_all)
    span_cap = len(chain.query.seq) + 2 * slack
    bi, bj = 0, na - 1
    if na and int(ate_all[-1] - atb_all[0]) > span_cap:
        best_cnt, i = 0, 0
        for j in range(na):
            while int(ate_all[j] - atb_all[i]) > span_cap:
                i += 1
            if j - i + 1 > best_cnt:
                best_cnt, bi, bj = j - i + 1, i, j

    a_tb0 = int(atb_all[bi])
    a_te1 = int(ate_all[bj])
    a_qb0 = int(chain.aqb[bi])
    a_qb1 = int(chain.aqb[bj])
    ids_b, _ = index.node_ids_from_seqpos_vec(
        np.zeros(1, np.int8), np.asarray([a_tb0], dtype=np.int64)
    )
    ids_e, _ = index.node_ids_from_seqpos_vec(
        np.zeros(1, np.int8), np.asarray([a_te1 - 1], dtype=np.int64)
    )
    start_h = int(ids_b[0]) << 1
    end_h = int(ids_e[0]) << 1
    budget = len(chain.query.seq) + slack
    # walk budgets are anchored-offset-based: the remaining budget after
    # consuming the start node is qlen + slack minus the start node's
    # bases past the anchor, so anchors deep inside a huge node keep
    # the corridor inside it (mirrors host_kernels.cpp)
    start_off = a_tb0 - index.get_bv_select(int(ids_b[0]))
    end_gap = index.get_bv_select(int(ids_e[0]) + 1) - a_te1
    fwd = _bfs_budget(index, start_h, start_off + budget, incoming=False)
    bwd = _bfs_budget(index, end_h, end_gap + budget, incoming=True)
    members = set(fwd) & set(bwd)
    members.add(start_h)
    members.add(end_h)

    # unaligned query prefix/suffix beyond the anchored nodes
    # (extend_range_chain_2 analog, align.rs:523-665)
    prefix = a_qb0
    start_off = a_tb0 - index.get_bv_select(int(ids_b[0]))
    prefix = max(0, prefix - max(0, start_off))
    if prefix > 0:
        for h in index.incoming_edges_from_handle(start_h):
            if (h & 1) == 0:
                members |= set(_bfs_budget(index, h, prefix, incoming=True))
    suffix = len(chain.query.seq) - (a_qb1 + chain.k)
    end_tail = index.get_bv_select(int(ids_e[0]) + 1) - a_te1
    suffix = max(0, suffix - max(0, end_tail))
    if suffix > 0:
        for h in index.outgoing_edges_from_handle(end_h):
            if (h & 1) == 0:
                members |= set(_bfs_budget(index, h, suffix, incoming=False))

    handles = _topo_order(index, members)

    # flank-node label trimming (mirrors host_kernels.cpp): a huge
    # start/end node would otherwise force the global POA through
    # kilobases of deletions — trim its label to at most `budget` bases
    # around the anchored window.  Emitted GAF node offsets stay in
    # UNTRIMMED node coordinates: label_trims feeds the offset rebase
    # (_rebase_trimmed_offsets / the native lbase channel).
    trims: dict = {}
    s_len = len(index.seq_from_handle(start_h))
    t_from = a_tb0 - index.get_bv_select(int(ids_b[0])) - budget
    if t_from > 0:
        trims[start_h] = (t_from, s_len)
    e_len = len(index.seq_from_handle(end_h))
    t_to = a_te1 - index.get_bv_select(int(ids_e[0])) + budget
    if t_to < e_len:
        f0 = trims.get(end_h, (0, 0))[0]
        trims[end_h] = (f0, t_to)
    return OrientedGraphRange(
        orient=RangeOrient.FORWARD, handles=handles,
        label_trims=trims or None,
    )


def close_bubbles(index: Index, po_range: OrientedGraphRange) -> OrientedGraphRange:
    """Surgical bubble closure (accuracy extension beyond the reference).

    Two reference behaviors lose bubble alt-alleles on graphs whose
    alt-node ids sit far from their flanks: the contiguous node-id
    range omits un-anchored alt nodes entirely (align.rs:267-402), and
    the id-increasing edge filter (align.rs:717-721) drops the return
    edge of an in-range alt node whose id exceeds its successor's.
    Forward ranges only: a forward node x whose in-range predecessors P
    and successors S are both nonempty with max(P) < min(S) is a bubble
    alt between those flanks; if its id does not already sit between
    them (or it is out of range) it is (re)placed right after max(P).
    Everything else keeps id order — the id filter doubles as a
    linearity prior that prunes spurious long-range shortcuts, so a
    full topological reorder measurably hurts.  Mirrors the native
    runtime (host_kernels.cpp vg_extract_subgraphs)."""
    if po_range.orient != RangeOrient.FORWARD:
        return po_range
    handles = list(po_range.handles)
    inset = set(handles)
    cands = set()
    for h in handles:
        for t in index.outgoing_edges_from_handle(h):
            if not (t & 1) and t not in inset:
                cands.add(t)
    anchor: dict = {}
    children: dict = {}
    for x in sorted(cands) + handles:
        preds = [p for p in index.incoming_edges_from_handle(x) if p in inset]
        succs = [m for m in index.outgoing_edges_from_handle(x) if m in inset]
        if not preds or not succs:
            continue
        max_p, min_s = max(preds), min(succs)
        if max_p >= min_s:
            continue
        if x in inset and max_p < x < min_s:
            continue  # already correctly placed
        anchor[x] = max_p
        children.setdefault(max_p, []).append(x)
    if not anchor:
        return po_range
    merged: List[int] = []
    emitted = set()

    def emit(h0: int) -> None:
        stack = [h0]
        while stack:
            h = stack.pop()
            if h in emitted:
                continue
            emitted.add(h)
            merged.append(h)
            for c in sorted(children.get(h, ()), reverse=True):
                stack.append(c)

    for h in handles:
        if h not in anchor:
            emit(h)
    for h in sorted(x for x in anchor if x not in emitted):
        emit(h)
    return OrientedGraphRange(orient=po_range.orient, handles=merged)


def find_nodes_edges(index: Index, po_range: OrientedGraphRange) -> Tuple[List[str], List[Tuple[int, int]]]:
    """Node labels + 0-based edges within the range, loops removed by
    orientation (align.rs:670-724).  Corridor-mode flank trims apply."""
    handles = po_range.handles
    pos_of = {h: i for i, h in enumerate(handles)}
    seqs = [index.seq_from_handle(h) for h in handles]
    if po_range.label_trims:
        for h, (f, t) in po_range.label_trims.items():
            i = pos_of.get(h)
            if i is not None:
                seqs[i] = seqs[i][f:t]

    edges: List[Tuple[int, int]] = []
    for h in handles:
        for target in index.outgoing_edges_from_handle(h):
            if target in pos_of:
                edges.append((pos_of[h], pos_of[target]))

    if po_range.orient == RangeOrient.FORWARD:
        edges = [e for e in edges if e[0] < e[1]]
    elif po_range.orient == RangeOrient.REVERSE:
        edges = [e for e in edges if e[1] < e[0]]
    return seqs, edges


def get_subgraph_paths(graph, po_range: Union["OrientedGraphRange", List[int]]):
    """Paths restricted to the range (an ``OrientedGraphRange`` or its
    handle list), ids rebased to it (align.rs:1170-1189).  The per-chain
    route's; the batch route's export takes the same from
    ``native.subgraph_paths_native``."""
    handles = po_range.handles if isinstance(po_range, OrientedGraphRange) else po_range
    in_range = set(handles)
    min_in_range = min(handle_id(h) for h in handles)
    return {
        pid: [handle_id(h) - min_in_range + 1 for h in graph.get_path(pid).nodes
              if h in in_range]
        for pid in graph.paths_iter()
    }


def _rebase_trimmed_offsets(res, rng: "OrientedGraphRange") -> None:
    """Corridor flank trims cut the front of the start node's label;
    rebase the result's per-node path offsets to UNTRIMMED node
    coordinates so emitted GAF offsets mean the same thing in every
    range mode (mirrors the native path's lbase correction)."""
    if not rng.label_trims or not res.node_path:
        return

    def base(ni: int) -> int:
        return rng.label_trims.get(rng.handles[ni], (0, 0))[0]

    res.path_start_offset += base(res.node_path[0])
    res.path_end_offset += base(res.node_path[-1])


def _corridor_score_key(a) -> int:
    """Corridor-mode candidate order: the flank-trimmed POA score (lazy),
    else the raw score, else bottom (placeholders)."""
    t = getattr(a, "poa_score_trim", None)
    if t is not None:
        return t
    cs = getattr(a, "poa_cs", None)
    if cs is not None:
        t = PoaAligner.trimmed_poa_score(cs)
        a.poa_score_trim = t
        return t
    s = getattr(a, "poa_score", None)
    return -(1 << 60) if s is None else s


class PoaEngine(Enum):
    ABPOA = "abpoa"
    RSPOA = "rspoa"


class PoaAligner:
    """Base-level aligner over chain-implied subgraphs (align.rs:34-228)."""

    def __init__(self, index, device: Optional[torch.device] = None,
                 engine: PoaEngine = PoaEngine.ABPOA,
                 export_subgraphs: bool = False, graph=None,
                 bubble_closure: bool = False, range_mode: Optional[str] = None,
                 mesh: Optional[Mesh] = None):
        """With a ``mesh`` the aligner runs on the rank's device
        (``mesh.device``) and aligns the chains of the rank's own reads:
        results are per problem, so no collective is needed, and each
        subgraph GFA is written by the rank that owns its read."""
        import os

        require_native()
        self.index = index
        self.device = rank_device(mesh, device)
        self.engine = engine
        self.export_subgraphs = export_subgraphs
        self.graph = graph
        self._path_index = None  # the graph's P-lines by handle, built at the first export
        self.bubble_closure = bubble_closure
        explicit_mode = range_mode is not None
        if range_mode is None:
            range_mode = os.environ.get("VGALIGNER_RANGE_MODE", "corridor")
        if bubble_closure:
            if explicit_mode and range_mode == "corridor":
                log.warning("--bubble-closure operates on the contiguous-id range; "
                            "overriding the requested --range-mode corridor with 'id'")
            range_mode = "id"
        if range_mode not in ("corridor", "id"):
            raise ValueError(f"unknown range_mode {range_mode!r}")
        self.range_mode = range_mode
        self.tie_align_n = int(os.environ.get("VGALIGNER_TIE_ALIGN_N", "1"))

    def _chains_for_alignment(self, chains: List[Chain], n: int) -> List[Chain]:
        """The first align_best_n chains (align.rs:34-55); corridor mode
        orders tied chains by earliest target start first."""
        if self.range_mode == "corridor" and len(chains) > 1:
            order = sorted(
                range(len(chains)),
                key=lambda i: ((1 << 62) if chains[i].is_placeholder
                               else int(chains[i].atb[0]), i),
            )
            chains = [chains[i] for i in order]
            n = max(n, self.tie_align_n)
        return chains[: min(n, len(chains))]

    def _range_for_chain(self, chain: Chain) -> OrientedGraphRange:
        """Chain -> subgraph range under this aligner's range mode, in
        Python (the native extractor's modes, defined independently)."""
        if self.range_mode == "corridor":
            rng = find_range_chain_corridor(self.index, chain)
            if rng is not None:
                return rng
        rng = extend_range_chain(self.index, chain, find_range_chain(self.index, chain))
        if self.bubble_closure:
            rng = close_bubbles(self.index, rng)
        return rng

    def best_alignment_for_query(self, chains: List[Chain], align_best_n: int = 1) -> GAFAlignment:
        """One read's best alignment over its first align_best_n chains,
        each aligned on the host oracle (align.rs:34-55)."""
        alignments: List[GAFAlignment] = []
        for chain in self._chains_for_alignment(chains, align_best_n):
            if chain.is_placeholder:
                alignments.append(GAFAlignment.from_placeholder_chain(chain))
            else:
                alignments.append(self.obtain_base_level_alignment(chain))
        return self._select_best([chains], {0: alignments})[0]

    def obtain_base_level_alignment(self, chain: Chain) -> GAFAlignment:
        """One chain through the Python route and the host oracle of this
        aligner's engine (align.rs:58-145); exports its subgraph GFA when
        asked to, for either engine, as the JAX package does here."""
        from ..ops.poa import align_global_host, align_local_no_gap_host

        rng = self._range_for_chain(chain)
        nodes, edges = find_nodes_edges(self.index, rng)
        if self.export_subgraphs and self.graph is not None:
            from ..io.validate import create_subgraph_gfa, export_gfa

            export_gfa(create_subgraph_gfa(nodes, edges, get_subgraph_paths(self.graph, rng)),
                       f"{chain.query.name}-subgraph-{chain.n_anchors}.gfa")
        if self.engine == PoaEngine.RSPOA:
            res = align_local_no_gap_host(nodes, edges, chain.query.seq)
            _rebase_trimmed_offsets(res, rng)
            a = GAFAlignment.from_rspoa_result(res, chain, rng.handles)
            a.poa_score = res.best_score
            return a
        res = align_global_host(nodes, edges, chain.query.seq)
        _rebase_trimmed_offsets(res, rng)
        a = GAFAlignment.from_abpoa_result(res, chain, rng.handles)
        a.poa_score = res.best_score
        a.poa_cs = res.cs
        return a

    @staticmethod
    def trimmed_poa_score(cs: str) -> int:
        """Global score of the matched span of a cs string, leading and
        trailing deletion runs stripped."""
        from ..ops.poa import MATCH, MISMATCH, gap_cost

        runs = []
        i = 5 if cs.startswith("cs:Z:") else 0
        n = len(cs)
        while i < n:
            op = cs[i]
            i += 1
            if op == ":":
                j = i
                while j < n and cs[j].isdigit():
                    j += 1
                runs.append((op, int(cs[i:j])))
                i = j
            elif op == "*":
                runs.append((op, 1))
                i += 2
            elif op in "+-":
                j = i
                while j < n and cs[j] not in ":*+-":
                    j += 1
                runs.append((op, j - i))
                i = j
            else:
                break
        a, b = 0, len(runs)
        while a < b and runs[a][0] == "-":
            a += 1
        while b > a and runs[b - 1][0] == "-":
            b -= 1
        score = 0
        for op, ln in runs[a:b]:
            if op == ":":
                score += MATCH * ln
            elif op == "*":
                score += MISMATCH * ln
            else:
                score -= gap_cost(ln)
        return score

    def _select_best(self, per_read_chains, per_read: dict) -> List[GAFAlignment]:
        """Per read, the longest path_length (align.rs:52-54); in corridor
        mode the best POA score first."""
        out: List[GAFAlignment] = []
        corridor = self.range_mode == "corridor"
        for qi in range(len(per_read_chains)):
            alns = per_read.get(qi, [])
            if len(alns) == 1:
                out.append(alns[0])
                continue
            if corridor and any(getattr(a, "poa_score", None) is not None for a in alns):
                alns.sort(key=_corridor_score_key, reverse=True)
            else:
                alns.sort(key=lambda a: -1 if a.path_length is None else a.path_length,
                          reverse=True)
            out.append(alns[0])
        return out

    def best_alignments_for_queries(self, per_read_chains: List[List[Chain]],
                                    align_best_n: int = 1) -> List[GAFAlignment]:
        return self.finish_alignments(self.begin_alignments(per_read_chains, align_best_n))

    def begin_alignments(self, per_read_chains: List[List[Chain]], align_best_n: int = 1):
        """Extract, build and launch a batch's POA work without waiting
        for the device; ``finish_alignments`` drains it.  The rspoa engine
        aligns eagerly here, and finish only returns its result."""
        if self.engine != PoaEngine.ABPOA:
            return ("eager", self._best_alignments_rspoa(per_read_chains, align_best_n))
        selected: List[Tuple[int, Chain]] = []
        placeholders: dict = {}
        for qi, chains in enumerate(per_read_chains):
            for chain in self._chains_for_alignment(chains, align_best_n):
                if chain.is_placeholder:
                    placeholders.setdefault(qi, GAFAlignment.from_placeholder_chain(chain))
                    continue
                selected.append((qi, chain))
        pending = self._dispatch_chains([c for _, c in selected]) if selected else None
        return ("abpoa", per_read_chains, selected, placeholders, pending)

    def finish_alignments(self, state) -> List[GAFAlignment]:
        if state[0] == "eager":
            return state[1]
        _tag, per_read_chains, selected, placeholders, pending = state
        per_read: dict = {qi: [a] for qi, a in placeholders.items()}
        finished = self._finish_chains(pending) if pending is not None else []
        with TRACER.span("aligner.select"):
            for (qi, chain), (res, handles) in zip(selected, finished):
                a = GAFAlignment.from_abpoa_result(res, chain, handles)
                a.poa_score = res.best_score
                a.poa_cs = res.cs
                per_read.setdefault(qi, []).append(a)
            return self._select_best(per_read_chains, per_read)

    def _best_alignments_rspoa(self, per_read_chains: List[List[Chain]],
                               align_best_n: int) -> List[GAFAlignment]:
        """rspoa engine: local gapless alignment of every selected chain's
        subgraph in one ``align_local_batch`` (candidates per read in the
        JAX route's order: placeholders first, then aligned chains)."""
        selected: List[Tuple[int, Chain]] = []
        per_read: dict = {}
        for qi, chains in enumerate(per_read_chains):
            for chain in self._chains_for_alignment(chains, align_best_n):
                if chain.is_placeholder:
                    per_read.setdefault(qi, []).append(GAFAlignment.from_placeholder_chain(chain))
                    continue
                selected.append((qi, chain))
        results = []
        if selected:
            with TRACER.span("aligner.extract"):
                sub = self._extract([c for _, c in selected])
            with TRACER.span("aligner.build"):
                problems = [(sub.nodes(i), sub.edges(i), chain.query.seq)
                            for i, (_qi, chain) in enumerate(selected)]
            with TRACER.span("aligner.launch"):
                results = align_local_batch(problems, self.device)
        with TRACER.span("aligner.select"):
            for i, ((qi, chain), res) in enumerate(zip(selected, results)):
                sub.rebase(i, res)
                a = GAFAlignment.from_rspoa_result(res, chain, sub.handles(i))
                a.poa_score = res.best_score
                per_read.setdefault(qi, []).append(a)
            return self._select_best(per_read_chains, per_read)

    def _extract(self, chains: List[Chain]) -> "_Subgraphs":
        """Every chain's subgraph under this aligner's range mode, natively."""
        n_anchors = np.asarray([c.n_anchors for c in chains], dtype=np.int64)
        anchor_off = np.concatenate([[0], np.cumsum(n_anchors)])
        aqb = np.concatenate([c.aqb for c in chains])
        atb = np.concatenate([c.atb for c in chains])
        ate = np.concatenate([c.ate for c in chains])
        aso = aeo = None
        if any(c.aso is not None for c in chains):
            zeros = lambda c: np.zeros(c.n_anchors, np.int8)  # noqa: E731
            aso = np.concatenate([zeros(c) if c.aso is None else c.aso for c in chains])
            aeo = np.concatenate([zeros(c) if c.aeo is None else c.aeo for c in chains])
        qlen = np.asarray([len(c.query.seq) for c in chains], dtype=np.int64)
        out = extract_subgraphs_native(
            self.index, anchor_off, aqb, atb, ate, aso, aeo, qlen, chains[0].k,
            bubble_closure=self.bubble_closure, range_mode=self.range_mode,
        )
        if out[-1].any():
            raise RuntimeError("range extension did not converge (cyclic region?)")
        return _Subgraphs(*out[:-1])

    def _dispatch_chains(self, chains: List[Chain]):
        """Native extraction + problem arrays around the device POA,
        launched per (V, L) bucket as real problems under the route's byte
        budget (``global_chunks``); host outliers complete here."""
        n = len(chains)
        with TRACER.span("aligner.extract"):
            sub = self._extract(chains)
        if self.export_subgraphs and self.graph is not None:
            self._export(chains, sub)

        with TRACER.span("aligner.build"):
            qs = [encode_seq(c.query.seq) for c in chains]
            v_per = sub.label_off[sub.handle_off[1:]] - sub.label_off[sub.handle_off[:-1]]
            buckets: dict = {}
            on_host = []
            for i in range(n):
                if int(v_per[i]) > _V_DEVICE_CAP:
                    on_host.append(i)
                    continue
                key = (_next_pow2(max(int(v_per[i]), 256)), _l_pad_for(len(qs[i])))
                buckets.setdefault(key, []).append(i)
            edges_flat = np.ascontiguousarray(sub.edges_arr.reshape(-1), dtype=np.int64)
        out = [None] * n
        if on_host:
            with TRACER.span("aligner.host_poa"):
                for i in on_host:
                    out[i] = poa_global_host_native(sub.nodes(i), sub.edges(i),
                                                    chains[i].query.seq)
        n_host = len(on_host)
        pending = []
        for (v_pad, l_pad), idxs in sorted(buckets.items()):
            with TRACER.span("aligner.build"):
                # ascending V: a launch's problems of like size share blocks
                idxs.sort(key=lambda i: int(v_per[i]))
                built = build_poa_batch_arrays(
                    sub.labels, sub.label_off, sub.handle_off.astype(np.int64),
                    sub.edge_off.astype(np.int64), edges_flat, np.asarray(idxs, dtype=np.int64),
                    v_pad, P_MAX,
                )
            if built is None:
                # fan-in above P_MAX: the host oracle (rare)
                from ..ops.poa import align_global_host

                with TRACER.span("aligner.host_poa"):
                    for i in idxs:
                        out[i] = align_global_host(sub.nodes(i), sub.edges(i),
                                                   chains[i].query.seq)
                n_host += len(idxs)
                continue
            with TRACER.span("aligner.launch"):
                ps = dispatch_bucket(built, [qs[i] for i in idxs], v_pad, l_pad, self.device)
                pending.append((idxs, ps, ready_event(self.device)))
        TRACER.count("aligner.host_problems", n_host)
        TRACER.count("aligner.device_problems", n - n_host)
        return (n, out, pending, sub)

    def _export(self, chains: List[Chain], sub: "_Subgraphs") -> None:
        """Every chain's subgraph GFA, as the reference does (map.rs:164),
        in two spans inside one: the paths in every chain's range, in one
        native pass over the batch (``get_subgraph_paths``'s result), then
        each chain's GFA text and its file, in chain order."""
        from ..io.validate import create_subgraph_gfa, export_gfa

        with TRACER.span("aligner.export"):
            with TRACER.span("aligner.export.paths"):
                if self._path_index is None:
                    self._path_index = path_index(self.graph)
                paths = subgraph_paths_native(self._path_index, sub.handle_off, sub.handles_arr)
            with TRACER.span("aligner.export.write"):
                for i, chain in enumerate(chains):
                    export_gfa(create_subgraph_gfa(sub.nodes(i), sub.edges(i), paths[i]),
                               f"{chain.query.name}-subgraph-{chain.n_anchors}.gfa")
        TRACER.count("aligner.export.native_paths", len(paths))
        TRACER.count("aligner.export_files", len(chains))

    def _finish_chains(self, state):
        """Drain the device chunks, each bucket once its launches are done,
        and pair each result with its range handles, offsets rebased to
        untrimmed node coordinates."""
        n, out, pending, sub = state
        for idxs, ps, done in pending:
            TRACER.wait("aligner.device_wait", done)
            for i, res in zip(idxs, kernel_finish_all(ps)):
                out[i] = res
        with TRACER.span("aligner.select"):
            for i in range(n):
                sub.rebase(i, out[i])
            return [(out[i], sub.handles(i)) for i in range(n)]


class _Subgraphs:
    """The native extractor's flat output for a list of chains: chain i
    owns handles [handle_off[i], handle_off[i+1]), their labels (corridor
    flank trims applied, trim starts in ``lbase``) and its 0-based edges."""

    def __init__(self, handle_off, handles, label_off, lbase, labels, edge_off, edges):
        self.handle_off, self.handles_arr, self.label_off = handle_off, handles, label_off
        self.lbase, self.labels, self.edge_off, self.edges_arr = lbase, labels, edge_off, edges

    def nodes(self, i: int) -> List[str]:
        lo = self.label_off
        return [self.labels[lo[j] : lo[j + 1]].decode("ascii")
                for j in range(self.handle_off[i], self.handle_off[i + 1])]

    def edges(self, i: int) -> List[Tuple[int, int]]:
        return [(int(a), int(b)) for a, b in self.edges_arr[self.edge_off[i] : self.edge_off[i + 1]]]

    def handles(self, i: int) -> List[int]:
        return self.handles_arr[self.handle_off[i] : self.handle_off[i + 1]].tolist()

    def rebase(self, i: int, res) -> None:
        """Node offsets of a result to untrimmed node coordinates: a
        corridor flank trim cuts the front of its node's label."""
        lb = self.lbase[self.handle_off[i] : self.handle_off[i + 1]]
        if res.node_path and lb.any():
            res.path_start_offset += int(lb[res.node_path[0]])
            res.path_end_offset += int(lb[res.node_path[-1]])
