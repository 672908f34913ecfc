"""The plain reference: GAF rows of reads worked out from the GFA text.

NumPy and plain Python; it imports nothing of the program.  For each
read it gives the rows the chains GAF holds for it and, when asked to
align, its one alignments GAF row, as bytes:

  * the index: every forward k-mer walk of the graph (``graph.py``);
  * chaining: the banded DP and its backtrack (``chain.py``), in the
    configuration's arithmetic;
  * the chains row of each chain, or the unmapped row;
  * alignment: of the read's chain with the smallest first target
    position, the corridor subgraph (``subgraph.py``) and the engine's
    POA (``poa.py``), as an abPOA or rspoa row; an unmapped read's row
    is its unmapped row;
  * on abPOA, the subgraph GFA file that chain's subgraph is exported
    to, ``<read>-subgraph-<anchors>.gfa`` (map.rs:164), and its bytes.

Rows follow rs-vgaligner's GAFAlignment (align.rs:726-1028).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from . import chain as _chain
from . import poa as _poa
from .graph import Graph, KmerIndex, parse_gfa
from .subgraph import corridor, subgraph_gfa


def _row(fields) -> bytes:
    return ("\t".join("*" if f is None else str(f) for f in fields) + "\n").encode()


def unmapped_row(name: str, qlen: int) -> bytes:
    return _row([name, qlen] + [None] * 9 + [0, None])


def chain_row(pos_text, name: str, qlen: int, k: int, qb, tb, te) -> bytes:
    """``pos_text[p]`` is ``>node:offset`` of linear position p."""
    n = len(qb)
    parts = np.empty(2 * n, dtype=object)
    parts[0::2] = pos_text[0][tb]
    parts[1::2] = pos_text[1][te - 1]
    return (f"{name}\t{qlen}\t{int(qb[0])}\t{int(qb[-1]) + k}\t+\t".encode()
            + b"".join(parts.tolist())
            + f"\t0\t0\t0\t0\t0\t0\tta:Z:chain,n_anchors: {n}\n".encode())


def export_name(name: str, chain) -> str:
    return f"{name}-subgraph-{len(chain[0])}.gfa"


def alignment_row(graph: Graph, name: str, seq: str, sub, engine: str) -> bytes:
    """``sub`` is the chain's corridor subgraph."""
    nodes, labels, edges, lbase = sub
    path = lambda res: "".join(f">{nodes[i]}" for i in res.node_path)  # noqa: E731
    if engine == "abpoa":
        res = _poa.align_global(labels, edges, seq)
        return _row([name, res.query_end - res.query_start, res.query_start, res.query_end,
                     "+", path(res), len(res.path_vertices), res.aln_start_offset,
                     res.aln_end_offset, 0, res.n_aligned, 255,
                     "as:i:-30 " + res.cs + ",cg:Z:" + res.cigar])
    res = _poa.align_local(labels, edges, seq)
    ps, pe = res.path_start_offset, res.path_end_offset
    if res.node_path:
        ps += lbase[res.node_path[0]]
        pe += lbase[res.node_path[-1]]
    return _row([name, len(seq), res.query_start, res.query_end, "+", path(res),
                 len(res.path_vertices), ps, pe, res.residue_matches, 0, 255,
                 res.cs + ",cg:Z:" + res.cigar])


class Reference:
    """The graph and index of one configuration, built from its GFA."""

    def __init__(self, gfa_path: str, k: int = 11, bandwidth: int = 50, max_gap: int = 1000,
                 min_anchors: int = 3):
        self.graph = parse_gfa(gfa_path)
        self.index = KmerIndex(self.graph, k)
        self.k, self.bandwidth, self.max_gap = k, bandwidth, max_gap
        self.min_anchors = min_anchors
        g = self.graph
        ids, offs = g.node_of(np.arange(int(g.node_starts[-1])))
        text = [f">{i}:{o}" for i, o in zip(ids.tolist(), offs.tolist())]
        self.pos_text = (np.asarray([f"({t},".encode() for t in text], dtype=object),
                         np.asarray([f"{t}),".encode() for t in text], dtype=object))

    def rows(self, reads: Sequence[Tuple[str, str]], precision: str, engine: Optional[str],
             aligned: Optional[Set[str]] = None) -> Dict[str, tuple]:
        """name -> (its chains GAF rows, its alignments GAF row, its
        exported subgraph files as {file name: bytes}).  The alignment row
        and the files' bytes are worked out for the reads in ``aligned``
        only (every read when None), None elsewhere; without ``engine``
        the row is None, and without abPOA there are no files."""
        per_read = _chain.map_reads(self.index, [s for _, s in reads], self.bandwidth,
                                    self.max_gap, self.min_anchors, precision)
        out = {}
        for (name, seq), chains in zip(reads, per_read):
            align = engine is not None and (aligned is None or name in aligned)
            if not chains:
                rows = unmapped_row(name, len(seq))
                out[name] = (rows, rows if align else None, {})
                continue
            rows = b"".join(chain_row(self.pos_text, name, len(seq), self.k, *c)
                            for c in chains)
            first = chains[min(range(len(chains)), key=lambda i: (int(chains[i][1][0]), i))]
            aln, files = None, {}
            if align:
                sub = corridor(self.graph, len(seq), self.k, *first)
                aln = alignment_row(self.graph, name, seq, sub, engine)
            if engine == "abpoa":
                files[export_name(name, first)] = (
                    subgraph_gfa(self.graph, *sub[:3]) if align else None)
            out[name] = (rows, aln, files)
        return out

    def n_anchors(self, seqs: List[str]) -> np.ndarray:
        return self.index.n_anchors(seqs)
