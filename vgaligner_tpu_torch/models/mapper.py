"""The mapping pipeline: reads -> anchors -> chains -> GAF.

Counterpart of ``vgaligner_tpu/models/mapper.py`` (reference: map_reads,
map.rs:27-216, and the backtrack of chain_anchors, chain.rs:452-655).

  * on the device (``_map_core``): window k-mer codes, index lookup,
    anchor materialisation and the chaining DP; the host receives one
    uint8 per anchor, (pred delta | is_start << 7), plus per-read counts;
  * on the host, in the native runtime: anchor counting for the
    capacity buckets, the backtrack over the delta plane, the
    coordinates of chain members, and the chains GAF text.

Reads are bucketed by exact anchor count on the {64, 128, 256, big}
ladder; no read is truncated, so the bucket never changes the output.
Reads with more than ``max_anchors_cap`` anchors are chained on the host
by the native unbounded chainer.  ``anchors_for_query_host`` is the
host anchor path (chain.rs:134-173, either orient), which the tests and
the per-chain API (``Chain.from_anchor_list``) use.

With a ``mesh`` (``parallel/mesh.py``) each rank maps its own slice of
the batch.  One all-reduce (max) a batch makes the ranks agree on the
buckets: every rank launches the same buckets in the same order, each
with the most rows any rank has in it (the rest empty reads), the
longest read's padding and the single-device run's big a_max, so every
read gets the single-device shapes and its bytes.  With
``shard_index`` the position table is split by row over the ranks and
each launch gathers anchor positions with one all-gather and one
reduce-scatter; a rank with no read still joins every collective.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..index.kmer_gen import FORWARD
from ..io.fastx import QuerySequence
from ..io.gaf import GAFAlignment
from ..native import (
    anchor_coords_native,
    backtrack_delta_native,
    chains_gaf_blob_native,
    count_anchors_native,
    map_read_chains_native,
    require_native,
)
from ..utils.timing import TRACER, ready_event
from ..index.device_index import device_index
from ..ops.chain import chain_scores, make_gap_cost_table
from ..ops.encode import encode_reads_host, window_kmer_codes
from ..ops.lookup import lookup_and_materialize_anchors
from ..parallel.mesh import Mesh, place_index, rank_device

log = logging.getLogger(__name__)

F64_MIN = -np.finfo(np.float64).max  # mapping_quality sentinel (f64::MIN)
SECONDARY_CHAIN_THRESHOLD = 0.5  # map_main.rs:100-117 (hard-coded)
MAX_MAPQ = 60.0


def assign_mapq(chains, secondary_chain_threshold: float = SECONDARY_CHAIN_THRESHOLD,
                max_mapq: float = MAX_MAPQ) -> None:
    """Opt-in --mapq extension: a chain whose query interval overlaps
    another chain of the read is ambiguous (mapq 0) and an overlapped
    chain covered beyond the threshold is flagged secondary; an
    unambiguous chain gets max_mapq (the intent of chain.rs:582-640)."""
    real = [c for c in chains if not c.is_placeholder and c.n_anchors]
    spans = [(int(c.aqb[0]), int(c.aqb[-1]) + c.k) for c in real]
    for i, c in enumerate(real):
        qb, qe = spans[i]
        if qb >= qe:
            continue
        ambiguous = False
        for j, (ob, oe) in enumerate(spans):
            if j == i or ob >= oe:
                continue
            ovlp = min(qe, oe) - max(qb, ob)
            if ovlp <= 0:
                continue
            ambiguous = True
            if ovlp > (oe - ob) * secondary_chain_threshold:
                real[j].is_secondary = True
        c.mapping_quality = 0.0 if ambiguous else max_mapq
    for c in real:
        if c.is_secondary and c.mapping_quality == max_mapq:
            c.mapping_quality = 0.0


class ChainAnchor(NamedTuple):
    """An anchor inside a chain (chain.rs:29-75); the production path is
    forward-only, so both orients default to Forward."""

    id: int
    qb: int
    qe: int
    tb: int
    te: int
    so: int = FORWARD
    eo: int = FORWARD


@dataclass
class Chain:
    """chain.rs:177-272; anchor data as ascending arrays, with
    ``ChainAnchor`` views on demand (``anchors``).  The reference's
    Chain::score is never assigned (always 0), so it is not kept."""

    query: QuerySequence
    aqb: Optional[np.ndarray] = None  # int64 [n] query begins
    atb: Optional[np.ndarray] = None  # int64 [n] target begins
    ate: Optional[np.ndarray] = None  # int64 [n] target ends
    aso: Optional[np.ndarray] = None  # int8 [n] start orients (None = fwd)
    aeo: Optional[np.ndarray] = None  # int8 [n] end orients (None = fwd)
    k: int = 0
    mapping_quality: float = F64_MIN
    is_secondary: bool = False
    is_placeholder: bool = False
    strand: str = "+"  # "-": the chain maps the read's reverse complement

    @classmethod
    def from_anchor_list(cls, query, anchors: List[ChainAnchor]) -> "Chain":
        return cls(
            query=query,
            aqb=np.asarray([a.qb for a in anchors], dtype=np.int64),
            atb=np.asarray([a.tb for a in anchors], dtype=np.int64),
            ate=np.asarray([a.te for a in anchors], dtype=np.int64),
            aso=np.asarray([a.so for a in anchors], dtype=np.int8),
            aeo=np.asarray([a.eo for a in anchors], dtype=np.int8),
            k=(anchors[0].qe - anchors[0].qb) if anchors else 0,
        )

    @property
    def n_anchors(self) -> int:
        return 0 if self.aqb is None else len(self.aqb)

    @property
    def anchors(self) -> List[ChainAnchor]:
        if self.aqb is None:
            return []
        return [
            ChainAnchor(id=i, qb=int(self.aqb[i]), qe=int(self.aqb[i]) + self.k,
                        tb=int(self.atb[i]), te=int(self.ate[i]),
                        so=FORWARD if self.aso is None else int(self.aso[i]),
                        eo=FORWARD if self.aeo is None else int(self.aeo[i]))
            for i in range(len(self.aqb))
        ]


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p


def chain_dp_score(chain: Chain, max_gap: int) -> float:
    """A chain's final f64 DP score re-applied link by link over its
    anchors (the reference's score_anchor); for the first, untruncated
    chain of a read it equals that read's curr_max."""
    if chain.is_placeholder or chain.n_anchors == 0:
        return -np.inf
    from .host_pipeline import HAnchor, score_anchor

    k = chain.k
    f = float(k)
    for i in range(1, chain.n_anchors):
        a = HAnchor(id=0, qb=int(chain.aqb[i - 1]), qe=int(chain.aqb[i - 1]) + k,
                    tb=int(chain.atb[i - 1]), te=int(chain.ate[i - 1]), f=f)
        b = HAnchor(id=1, qb=int(chain.aqb[i]), qe=int(chain.aqb[i]) + k,
                    tb=int(chain.atb[i]), te=int(chain.ate[i]))
        f = score_anchor(a, b, k, max_gap)
    return f


def anchors_for_query_host(index, query: QuerySequence,
                           only_forward: bool = True) -> List[ChainAnchor]:
    """Anchors of a query on the host, in query k-mer order
    (chain.rs:134-173): every position of each k-mer, forward-only unless
    ``only_forward`` is False.  The device lookup (ops/lookup.py) is its
    vectorised forward-only equivalent."""
    k = index.kmer_length
    anchors: List[ChainAnchor] = []
    for i, kmer in enumerate(query.split_into_kmers(k)):
        for so, sp, eo, ep in index.find_positions_for_query_kmer(kmer):
            if not only_forward or (so == FORWARD and eo == FORWARD):
                anchors.append(ChainAnchor(id=len(anchors), qb=i, qe=i + k, tb=sp, te=ep,
                                           so=so, eo=eo))
    return anchors


class Mapper:
    """Batched read mapper over a built index, on an explicit device."""

    def __init__(self, index, device: Optional[torch.device] = None, bandwidth: int = 50,
                 max_gap: int = 1000, chain_min_n_anchors: int = 3,
                 max_anchors_cap: int = 65536, precision: str = "exact",
                 mapq: bool = False, both_strands: bool = False,
                 mesh: Optional[Mesh] = None, shard_index: bool = False) -> None:
        """With a ``mesh`` the mapper runs on the rank's device
        (``mesh.device``); ``shard_index`` offset-shards the position
        table over the mesh, and is a no-op without one."""
        if precision not in ("exact", "fast"):
            raise ValueError(f"unknown precision {precision!r}")
        if bandwidth >= 127:
            raise ValueError("bandwidth must be < 127 (the u8 delta plane)")
        require_native()
        self.index = index
        self.device = rank_device(mesh, device)
        self.mesh = mesh
        self.shard_index = shard_index and mesh is not None
        self.bandwidth = bandwidth
        self.max_gap = max_gap
        self.chain_min_n_anchors = chain_min_n_anchors
        self.max_anchors_cap = max_anchors_cap
        self.precision = precision
        self.mapq = mapq
        self.both_strands = both_strands
        if mesh is None:
            self.dindex = device_index(index, self.device)
        else:
            self.dindex = place_index(mesh, device_index(index, torch.device("cpu")),
                                      shard_positions=self.shard_index)
        self._gap_table = make_gap_cost_table(index.kmer_length, max_gap)
        self.timer = TRACER  # the process's spans (utils/timing.py)

    # ---- device step ---------------------------------------------------

    def _map_core(self, codes: torch.Tensor, lens: torch.Tensor, a_max: int):
        """codes [B, L] int8, lens [B] int32 on the device ->
        (packed [B, a_max] uint8, counts [B, 2] int32 = (n_valid,
        n_anchors)).  packed = (slot - pred, 0 for none) | is_start << 7,
        is_start = valid & pred != -1 & f == curr_max (chain.rs:469)."""
        k = self.index.kmer_length
        wcodes, wvalid = window_kmer_codes(codes, lens, k)
        anchors = lookup_and_materialize_anchors(
            self.dindex, wcodes, wvalid, a_max,
            position_gather=self._sharded_gather if self.shard_index else None)
        scores = chain_scores(anchors.qb, anchors.tb, anchors.te, anchors.valid,
                              self._gap_table, seed_length=k, bandwidth=self.bandwidth,
                              precision=self.precision)
        is_start = scores.valid & (scores.pred != -1) & (scores.f == scores.curr_max[:, None])
        slot = torch.arange(a_max, dtype=torch.int32, device=codes.device)[None, :]
        delta = torch.where(scores.pred >= 0, slot - scores.pred, 0)
        packed = (delta | (is_start.to(torch.int32) << 7)).to(torch.uint8)
        counts = torch.stack(
            [scores.valid.sum(dim=1).to(torch.int32), anchors.n_anchors.to(torch.int32)],
            dim=1,
        )
        return packed, counts

    def _sharded_gather(self, table_row: torch.Tensor, valid: torch.Tensor):
        """The position gather over the offset-sharded table: all-gather
        every rank's rows, answer those this rank's shard owns (0 for the
        rest), and reduce-scatter the sums, so each rank gets its own
        reads' (tb, te) (vgaligner_tpu/models/mapper.py:533-557).  The
        ranks' batches have one shape (the bucket agreement).  ``valid``
        is deliberately unused: a padding slot reads row 0 exactly as the
        replicated gather does (its table_row is already 0 there)."""
        del valid
        mesh, fo_start, fo_end = self.mesh, self.dindex.fo_start, self.dindex.fo_end
        shard = fo_start.shape[0]
        local = mesh.all_gather(table_row) - mesh.rank * shard
        owned = (local >= 0) & (local < shard)
        local = local.clamp(0, shard - 1)
        both = torch.stack([torch.where(owned, fo_start[local], 0),
                            torch.where(owned, fo_end[local], 0)], dim=-1)
        tb, te = mesh.reduce_scatter_sum(both).unbind(-1)
        return tb.contiguous(), te.contiguous()

    # ---- public API ----------------------------------------------------

    def map_reads(self, queries: Sequence[QuerySequence]) -> List[List[Chain]]:
        """Chains per query, in input order (map.rs:56-111)."""
        return self.finish_map(self.begin_map(queries))

    def begin_map(self, queries: Sequence[QuerySequence]):
        """Host prep + device launches for a batch, without waiting for
        the device; ``finish_map`` drains it."""
        if not self.both_strands:
            return (queries, None, self._begin_oriented(queries))
        from ..utils.dna import reverse_complement

        rc = [QuerySequence(name=q.name, seq=reverse_complement(q.seq)) for q in queries]
        return (queries, len(queries), self._begin_oriented(list(queries) + rc))

    def finish_map(self, state) -> List[List[Chain]]:
        queries, n, ostate = state
        both = self._finish_oriented(ostate)
        if n is None:
            out = both
        else:
            # --both-strands: the strand whose best (untruncated) chain
            # scores higher wins; ties and no reverse chain keep forward
            out = []
            for i in range(n):
                fwd, rev = both[i], both[n + i]
                f_real = not fwd[0].is_placeholder
                r_real = not rev[0].is_placeholder
                take_rev = r_real and (
                    not f_real
                    or chain_dp_score(rev[0], self.max_gap)
                    > chain_dp_score(fwd[0], self.max_gap)
                )
                if take_rev:
                    for c in rev:
                        c.strand = "-"
                    out.append(rev)
                else:
                    out.append(fwd)
        if self.mapq:
            for chains in out:
                assign_mapq(chains)
        return out

    def _begin_oriented(self, queries: Sequence[QuerySequence]):
        log.info("Found %d reads!", len(queries))
        k = self.index.kmer_length
        out: List[List[Chain]] = [None] * len(queries)  # type: ignore
        mappable = [i for i, q in enumerate(queries) if len(q.seq) >= k]
        for i, q in enumerate(queries):
            if len(q.seq) < k:
                out[i] = [Chain(query=q, is_placeholder=True)]
        totals = np.zeros(0, dtype=np.int64)
        if mappable:
            with TRACER.span("mapper.count"):
                totals = count_anchors_native(
                    [queries[i].seq for i in mappable], self.index.kmer_codes,
                    self.index.fo_counts, k, lut=self.index.host_lut(),
                )
            over = totals > self.max_anchors_cap
            if over.any():
                log.info("%d reads exceed the %d-anchor device cap; mapping them "
                         "host-side (exact, unbounded)", int(over.sum()), self.max_anchors_cap)
                for local in np.nonzero(over)[0]:
                    qi = mappable[int(local)]
                    out[qi] = self._map_read_overflow(queries[qi])
                mappable = [qi for local, qi in enumerate(mappable) if not over[local]]
                totals = totals[~over]

        # bucket classes by exact anchor count: a_max 64, 128, 256, big
        classes: List[List[int]] = [[], [], [], []]
        for local, qi in enumerate(mappable):
            t = int(totals[local])
            classes[0 if t <= 64 else (1 if t <= 128 else (2 if t <= 256 else 3))].append(qi)
        rows = [len(c) for c in classes]
        l_max = [max((len(queries[i].seq) for i in c), default=0) for c in classes]
        big = int(totals.max()) if len(totals) else 0
        if self.mesh is not None:
            agreed = self.mesh.all_reduce_max(
                torch.tensor([*rows, *l_max, big], dtype=torch.int64)).tolist()
            rows, l_max, big = agreed[:4], agreed[4:8], agreed[8]
        big_a_max = min(max(_next_pow2(max(big, 1)), 256), self.max_anchors_cap)
        dispatched = [self._dispatch_bucket(queries, classes[c], a_max, rows[c], l_max[c])
                      for c, a_max in enumerate((64, 128, 256, big_a_max)) if rows[c]]
        return (queries, out, dispatched)

    def _dispatch_bucket(self, queries, qidx: List[int], a_max: int, rows: int, l_max: int):
        """One launch of ``rows`` reads padded to the pow2 of ``l_max``:
        the bucket's reads, then empty reads (lens 0) up to ``rows``."""
        k = self.index.kmer_length
        seqs = [queries[i].seq for i in qidx] + [""] * (rows - len(qidx))
        l_pad = _next_pow2(max(l_max, k))
        with TRACER.span("mapper.encode"):
            codes, lens = encode_reads_host(seqs, l_pad)
        with TRACER.span("mapper.launch"):
            packed, counts = self._map_core(
                torch.from_numpy(codes).to(self.device),
                torch.from_numpy(lens).to(self.device), a_max,
            )
            done = ready_event(self.device)
        return qidx, a_max, packed, counts, done

    def _finish_oriented(self, state) -> List[List[Chain]]:
        queries, out, dispatched = state
        pending = []
        for qidx, a_max, packed, counts, done in dispatched:
            if not qidx:
                continue  # a launch of empty reads only: this rank's share of the agreement
            TRACER.wait("mapper.device_wait", done)
            with TRACER.span("mapper.gather"):
                plane = packed[: len(qidx)].cpu().numpy()
                cnt = counts[: len(qidx)].cpu().numpy()
            with TRACER.span("mapper.backtrack"):
                read_off, chain_off, positions = backtrack_delta_native(
                    plane, cnt[:, 0], self.chain_min_n_anchors
                )
            per_read = [
                [positions[chain_off[c] : chain_off[c + 1]].tolist()
                 for c in range(read_off[b], read_off[b + 1])]
                for b in range(len(qidx))
            ]
            pending.append((qidx, a_max, per_read))
        self._finalize_chains(queries, pending, out)
        return out

    def _map_read_overflow(self, query: QuerySequence) -> List[Chain]:
        """Exact unbounded host chaining for a read over the device cap."""
        triples = map_read_chains_native(
            self.index, query.seq, self.bandwidth, self.max_gap, self.chain_min_n_anchors
        )
        chains = [Chain(query=query, aqb=qb, atb=tb, ate=te, k=self.index.kmer_length)
                  for qb, tb, te in triples]
        return chains or [Chain(query=query, is_placeholder=True)]

    def _finalize_chains(self, queries, pending, out) -> None:
        """Chain-member coordinates re-derived natively from the index,
        then Chain objects (placeholder rows for reads without chains)."""
        k = self.index.kmer_length
        with TRACER.span("mapper.coords"):
            read_ids, read_amax, mem_counts, slot_parts = [], [], [], []
            for qidx, a_max, per_read in pending:
                for b, read_chains in enumerate(per_read):
                    n_mem = sum(len(c) for c in read_chains)
                    if n_mem:
                        read_ids.append(qidx[b])
                        read_amax.append(a_max)
                        mem_counts.append(n_mem)
                        slot_parts.append(np.concatenate(
                            [np.asarray(c, dtype=np.int32) for c in read_chains]))
            qb = tb = te = np.zeros(0, dtype=np.int64)
            if read_ids:
                mem_off = np.zeros(len(read_ids) + 1, dtype=np.int64)
                np.cumsum(mem_counts, out=mem_off[1:])
                qb, tb, te = anchor_coords_native(
                    [queries[i].seq for i in read_ids], self.index,
                    np.asarray(read_amax, dtype=np.int64), mem_off,
                    np.concatenate(slot_parts),
                )
        with TRACER.span("mapper.emit"):
            flat = 0
            for qidx, _a_max, per_read in pending:
                for b, qi in enumerate(qidx):
                    chains: List[Chain] = []
                    for chain in per_read[b]:
                        n = len(chain)
                        chains.append(Chain(query=queries[qi], aqb=qb[flat : flat + n],
                                            atb=tb[flat : flat + n],
                                            ate=te[flat : flat + n], k=k))
                        flat += n
                    out[qi] = chains or [Chain(query=queries[qi], is_placeholder=True)]

    def chains_to_gaf(self, per_read_chains: List[List[Chain]]) -> List[GAFAlignment]:
        """map.rs:123-133."""
        records: List[GAFAlignment] = []
        for chains in per_read_chains:
            for c in chains:
                if c.is_placeholder:
                    records.append(GAFAlignment.from_placeholder_chain(c))
                else:
                    records.append(GAFAlignment.from_chain(c, self.index))
        return records

    def chains_gaf_text(self, per_read_chains: List[List[Chain]]) -> bytes:
        """The chains-GAF rows as one blob, assembled natively."""
        with TRACER.span("mapper.gaf"):
            blob = chains_gaf_blob_native(per_read_chains, self.index)
        if blob is None:
            raise RuntimeError("native chains-GAF assembly failed")
        return blob
