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
"""

from __future__ import annotations

import logging
from enum import Enum
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..graph.handlegraph import handle_id
from ..io.gaf import GAFAlignment
from ..native import (
    build_poa_batch_arrays,
    extract_subgraphs_native,
    poa_global_host_native,
    require_native,
)
from ..utils.dna import encode_seq
from ..ops.poa_device import P_MAX, _l_pad_for, _next_pow2, align_local_batch, \
    dispatch_bucket, kernel_finish_all, padded_rows
from ..parallel.mesh import Mesh, rank_device
from .mapper import Chain

log = logging.getLogger(__name__)

# subgraphs above this base-vertex count run on the native host POA
_V_DEVICE_CAP = 8192


def get_subgraph_paths(graph, handles: List[int]):
    """Paths restricted to the range's handles, ids rebased to it
    (align.rs:1170-1189)."""
    in_range = set(handles)
    min_in_range = min(handle_id(h) for h in handles)
    return {
        pid: [handle_id(h) - min_in_range + 1 for h in graph.get_path(pid).nodes
              if h in in_range]
        for pid in graph.paths_iter()
    }


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
        if pending is not None:
            for (qi, chain), (res, handles) in zip(selected, self._finish_chains(pending)):
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
        if selected:
            sub = self._extract([c for _, c in selected])
            problems = [(sub.nodes(i), sub.edges(i), chain.query.seq)
                        for i, (_qi, chain) in enumerate(selected)]
            for i, ((qi, chain), res) in enumerate(
                    zip(selected, align_local_batch(problems, self.device))):
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
        launched per (V, L) bucket and chunk; host outliers complete here."""
        n = len(chains)
        sub = self._extract(chains)
        if self.export_subgraphs and self.graph is not None:
            # every chain's subgraph, as the reference does (map.rs:164)
            from ..io.validate import create_subgraph_gfa, export_gfa

            for i, chain in enumerate(chains):
                export_gfa(
                    create_subgraph_gfa(sub.nodes(i), sub.edges(i),
                                        get_subgraph_paths(self.graph, sub.handles(i))),
                    f"{chain.query.name}-subgraph-{chain.n_anchors}.gfa",
                )

        qs = [encode_seq(c.query.seq) for c in chains]
        v_per = sub.label_off[sub.handle_off[1:]] - sub.label_off[sub.handle_off[:-1]]
        buckets: dict = {}
        out = [None] * n
        for i in range(n):
            if int(v_per[i]) > _V_DEVICE_CAP:
                out[i] = poa_global_host_native(sub.nodes(i), sub.edges(i),
                                                chains[i].query.seq)
                continue
            key = (_next_pow2(max(int(v_per[i]), 256)), _l_pad_for(len(qs[i])))
            buckets.setdefault(key, []).append(i)
        edges_flat = np.ascontiguousarray(sub.edges_arr.reshape(-1), dtype=np.int64)
        pending = []
        for (v_pad, l_pad), idxs in sorted(buckets.items()):
            # ascending V keeps each chunk's vertex loop bound tight
            idxs.sort(key=lambda i: int(v_per[i]))
            built = build_poa_batch_arrays(
                sub.labels, sub.label_off, sub.handle_off.astype(np.int64),
                sub.edge_off.astype(np.int64), edges_flat, np.asarray(idxs, dtype=np.int64),
                v_pad, P_MAX, rows=padded_rows(len(idxs), v_pad, l_pad),
            )
            if built is None:
                # fan-in above P_MAX: the host oracle (rare)
                from ..ops.poa import align_global_host

                for i in idxs:
                    out[i] = align_global_host(sub.nodes(i), sub.edges(i), chains[i].query.seq)
                continue
            pending.append((idxs, dispatch_bucket(built, [qs[i] for i in idxs], v_pad,
                                                  l_pad, self.device)))
        return (n, out, pending, sub)

    def _finish_chains(self, state):
        """Drain the device chunks and pair each result with its range
        handles, offsets rebased to untrimmed node coordinates."""
        n, out, pending, sub = state
        for idxs, ps in pending:
            for i, res in zip(idxs, kernel_finish_all(ps)):
                out[i] = res
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
