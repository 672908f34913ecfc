"""GAF (Graph Alignment Format) records and writers.

Behavioral reference: rs-vgaligner src/align.rs:726-1028
(GAFAlignment).  Column layout, `*` conventions, the chain path-matching
tuple format `(>node:offset,>node:offset),`, mapq saturation, and the
placeholder (unmapped) row are reproduced byte for byte.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..index.kmer_gen import FORWARD, REVERSE


@dataclass
class GAFAlignment:
    query_name: Optional[str] = None
    query_length: Optional[int] = None
    query_start: Optional[int] = None
    query_end: Optional[int] = None
    strand: Optional[str] = None
    path_matching: Optional[str] = None
    path_length: Optional[int] = None
    path_start: Optional[int] = None
    path_end: Optional[int] = None
    residue: Optional[int] = None
    alignment_block_length: Optional[int] = None
    mapping_quality: Optional[int] = None
    notes: Optional[str] = None

    def to_string(self) -> str:
        """align.rs:971-1027 — 13 tab-separated columns, '*' for missing,
        trailing newline."""
        fields = [
            self.query_name,
            self.query_length,
            self.query_start,
            self.query_end,
            self.strand,
            self.path_matching,
            self.path_length,
            self.path_start,
            self.path_end,
            self.residue,
            self.alignment_block_length,
            self.mapping_quality,
            self.notes,
        ]
        return "\t".join("*" if f is None else str(f) for f in fields) + "\n"

    # ---- constructors --------------------------------------------------

    _INT_COLS = frozenset(
        {"query_length", "query_start", "query_end", "path_length",
         "path_start", "path_end", "residue", "alignment_block_length",
         "mapping_quality"}
    )

    @classmethod
    def from_string(cls, line: str) -> "GAFAlignment":
        """Inverse of to_string: parse one GAF row back into a record
        ('*' -> None; round-trips byte-exactly).  Used by the multi-host
        merge, which gathers rows as strings over DCN."""
        cols = line.rstrip("\n").split("\t")
        names = [
            "query_name", "query_length", "query_start", "query_end",
            "strand", "path_matching", "path_length", "path_start",
            "path_end", "residue", "alignment_block_length",
            "mapping_quality", "notes",
        ]
        if len(cols) != len(names):
            raise ValueError(f"expected 13 GAF columns, got {len(cols)}")
        kw = {}
        for name, val in zip(names, cols):
            if val == "*":
                kw[name] = None
            elif name in cls._INT_COLS:
                kw[name] = int(val)
            else:
                kw[name] = val
        return cls(**kw)

    @classmethod
    def from_chain(cls, chain, index) -> "GAFAlignment":
        """align.rs:762-911 — chains GAF row.

        chain.anchors is the ascending (front..back) anchor list; each
        anchor contributes "(S,E)," where S/E are ">node:offset" or
        "<node:offset" derived from AnchorPosOnGraph (chain.rs:89-128).
        The chain's mapping_quality is the f64::MIN sentinel which the
        reference saturating-casts to 0 (align.rs:904).

        Reverse-strand chains (the both-strands extension — the
        reference never produces them, map.rs:62) report the ORIGINAL
        read: strand "-", query interval flipped back from revcomp
        coordinates, and the anchor tuples emitted back-to-front with
        each position re-expressed on the opposite node orientation
        (sign flipped, offset mirrored within the node).
        """
        assert not chain.is_placeholder
        import numpy as np

        n = chain.n_anchors
        pos = np.concatenate([chain.atb, chain.ate - 1])  # ends inclusive
        if chain.aso is None:
            orients = np.zeros(2 * n, dtype=np.int8)
        else:
            orients = np.concatenate([chain.aso, chain.aeo])
        ids, offs = _graph_pos_vectorized(index, orients, pos)
        rev = getattr(chain, "strand", "+") == "-"
        if rev:
            # mirror every anchor position onto the opposite orientation
            node_len = (
                index.node_starts[ids] - index.node_starts[ids - 1]
            )
            offs = node_len - 1 - offs
            orients = np.where(orients == FORWARD, REVERSE, FORWARD).astype(
                np.int8
            )
        signs = [">" if o == FORWARD else "<" for o in orients]
        parts: List[str] = []
        for i in range(n):
            if rev:
                # traverse back-to-front, each anchor end-first
                j = n - 1 - i
                parts.append(
                    f"({signs[n + j]}{ids[n + j]}:{offs[n + j]},"
                    f"{signs[j]}{ids[j]}:{offs[j]}),"
                )
            else:
                parts.append(
                    f"({signs[i]}{ids[i]}:{offs[i]},"
                    f"{signs[n + i]}{ids[n + i]}:{offs[n + i]}),"
                )
        qlen = len(chain.query.seq)
        qs, qe = int(chain.aqb[0]), int(chain.aqb[-1]) + chain.k
        if rev:
            qs, qe = qlen - qe, qlen - qs
        return cls(
            query_name=chain.query.name,
            query_length=qlen,
            query_start=qs,
            query_end=qe,
            strand="-" if rev else "+",
            path_matching="".join(parts),
            path_length=0,
            path_start=0,
            path_end=0,
            residue=0,
            alignment_block_length=0,
            # min(mapq as u64, 254), align.rs:904 — the f64::MIN sentinel
            # saturates to 0; the opt-in --mapq extension sets 0/60
            mapping_quality=min(int(max(chain.mapping_quality, 0.0)), 254),
            notes=f"ta:Z:chain,n_anchors: {n}",
        )

    @classmethod
    def from_abpoa_result(cls, res, chain, range_handles) -> "GAFAlignment":
        """align.rs:1096-1168 (generate_alignment) — base-level GAF from
        the global POA result.  The subgraph node path is mapped back to
        original handles via the range handle list; notes carry
        'as:i:-30 <cs>,cg:Z:<cigar>' and mapq is 255.

        For a reverse-strand chain (both-strands extension) the POA ran
        on the read's revcomp; the row reports the original read:
        strand "-", the node path reversed with orientations flipped,
        path offsets mirrored within the path, cigar run order
        reversed.  The cs string stays as computed on the revcomp
        (documented in ARCHITECTURE.md)."""
        rev = getattr(chain, "strand", "+") == "-"
        path_len = len(res.path_vertices)
        qs, qe = res.query_start, res.query_end
        ps, pe = res.aln_start_offset, res.aln_end_offset
        if rev:
            qlen = len(chain.query.seq)
            qs, qe = qlen - res.query_end, qlen - res.query_start
            ps, pe = path_len - res.aln_end_offset, path_len - res.aln_start_offset
        return cls(
            query_name=chain.query.name,
            query_length=res.query_end - res.query_start,
            query_start=qs,
            query_end=qe,
            strand="-" if rev else "+",
            path_matching=_path_str(res.node_path, range_handles, rev),
            path_length=path_len,
            path_start=ps,
            path_end=pe,
            residue=0,
            alignment_block_length=res.n_aligned,
            mapping_quality=255,
            notes="as:i:-30 " + res.cs + ",cg:Z:"
            + (_rev_cigar(res.cigar) if rev else res.cigar),
        )

    @classmethod
    def from_rspoa_result(cls, res, chain, range_handles) -> "GAFAlignment":
        """align.rs:932-969 (from_rspoa_alignment) — local no-gap GAF.
        Reverse-strand chains are flipped as in from_abpoa_result."""
        rev = getattr(chain, "strand", "+") == "-"
        qlen = len(chain.query.seq)
        qs, qe = res.query_start, res.query_end
        path_len = len(res.path_vertices)
        ps, pe = res.path_start_offset, res.path_end_offset
        if rev:
            qs, qe = qlen - res.query_end, qlen - res.query_start
            ps, pe = path_len - res.path_end_offset, path_len - res.path_start_offset
        return cls(
            query_name=chain.query.name,
            query_length=qlen,
            query_start=qs,
            query_end=qe,
            strand="-" if rev else "+",
            path_matching=_path_str(res.node_path, range_handles, rev),
            path_length=path_len,
            path_start=ps,
            path_end=pe,
            residue=res.residue_matches,
            alignment_block_length=0,
            mapping_quality=255,
            notes=res.cs + ",cg:Z:"
            + (_rev_cigar(res.cigar) if rev else res.cigar),
        )

    @classmethod
    def from_placeholder_chain(cls, chain) -> "GAFAlignment":
        """align.rs:913-930 — the unmapped-read row."""
        assert chain.is_placeholder
        return cls(
            query_name=chain.query.name,
            query_length=len(chain.query.seq),
            mapping_quality=0,
        )


def _graph_pos_vectorized(index, orients, pos):
    """Vectorized AnchorPosOnGraph::new (chain.rs:89-128)."""
    return index.node_ids_from_seqpos_vec(orients, pos)


def _path_str(node_path, range_handles, rev: bool = False) -> str:
    """GAF path column from a POA node path (align.rs:1145-1167); with
    rev, the traversal is reported in the opposite direction (reversed
    order, each step's orientation flipped)."""
    from ..graph.handlegraph import handle_id, handle_is_reverse

    parts = []
    for node_idx in node_path:
        h = range_handles[node_idx]
        fwd = handle_is_reverse(h) == rev  # flipped when rev
        parts.append(f"{'>' if fwd else '<'}{handle_id(h)}")
    if rev:
        parts.reverse()
    return "".join(parts)


def _rev_cigar(cigar: str) -> str:
    """Reverse a CIGAR's run order (op lengths unchanged) — the cigar of
    the same alignment read in the opposite direction."""
    import re

    return "".join(re.findall(r"\d+[A-Z=]", cigar)[::-1])


def write_gaf_to_file(alignments: List[GAFAlignment], file_name: str) -> None:
    """map.rs:219-226."""
    with open(file_name, "w") as fh:
        fh.write("".join(a.to_string() for a in alignments))
