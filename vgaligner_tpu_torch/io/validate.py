"""Alignment validation records and subgraph GFA export.

Behavioral reference: rs-vgaligner src/validate.rs.  Node ids are
parsed back out of the GAF path with the same (>|<)(digits) pattern
(validate.rs:105-111); records are the same 5-line blocks with
Rust-debug-style list formatting; the subgraph GFA exporter reproduces
the header/S/L/P layout of create_subgraph_GFA (validate.rs:160-205)
including its space-separated header and 1-based renumbering.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List

from ..graph.handlegraph import handle_pack

_NODE_RE = re.compile(r"(>|<)([0-9]+)")


def parse_nodes_from_path_matching(path_matching: str) -> List[int]:
    """validate.rs:105-111."""
    return [int(m.group(2)) for m in _NODE_RE.finditer(path_matching)]


def _rust_debug_u64_list(xs: List[int]) -> str:
    return "[" + ", ".join(str(x) for x in xs) + "]"


def _rust_debug_str_list(xs: List[str]) -> str:
    return "[" + ", ".join('"' + x + '"' for x in xs) + "]"


@dataclass
class ValidationRecord:
    """validate.rs:18-103."""

    read_name: str = ""
    cigar: str = ""
    read_seq: str = ""
    nodes_id: List[int] = field(default_factory=list)
    nodes_seq: List[str] = field(default_factory=list)

    @classmethod
    def from_graph_and_alignment(cls, graph, alignment, read) -> "ValidationRecord":
        if alignment.path_matching is not None:
            nodes_ids = parse_nodes_from_path_matching(alignment.path_matching)
            is_rev = bool(
                len(nodes_ids) >= 2 and nodes_ids[-1] < nodes_ids[0]
            )
            notes = alignment.notes or ""
            return cls(
                read_name=alignment.query_name,
                cigar=notes.split(",")[-1] if notes else "",
                read_seq=read.seq,
                nodes_id=nodes_ids,
                nodes_seq=[
                    graph.sequence(handle_pack(i, is_rev)) for i in nodes_ids
                ],
            )
        return cls(
            read_name=alignment.query_name,
            cigar="NOT ALIGNED",
            read_seq=read.seq,
        )

    def to_string(self) -> str:
        return (
            f"{self.read_name}\n{self.cigar}\n{self.read_seq}\n"
            f"{_rust_debug_u64_list(self.nodes_id)}\n"
            f"{_rust_debug_str_list(self.nodes_seq)}\n\n"
        )


def create_validation_records(graph, alignments, reads) -> List[ValidationRecord]:
    """validate.rs:127-143."""
    by_name = {}
    for r in reads:
        by_name.setdefault(r.name, r)
    return [
        ValidationRecord.from_graph_and_alignment(graph, a, by_name[a.query_name])
        for a in alignments
    ]


def write_validation_to_file(records: List[ValidationRecord], file_name: str) -> None:
    with open(file_name, "w") as fh:
        fh.write("".join(r.to_string() for r in records))


def create_subgraph_gfa(nodes: List[str], edges, paths: Dict[int, List[int]]) -> str:
    """validate.rs:160-205 — 1-based renumbered subgraph GFA."""
    header = f"H VN:Z:1.0 NS:i:{len(nodes)} NL:i:{len(edges)} NP:i:0\n"
    s_lines = "".join(f"S\t{i + 1}\t{seq}\n" for i, seq in enumerate(nodes))
    l_lines = "".join(f"L\t{s + 1}\t+\t{e + 1}\t+\t0M\n" for s, e in edges)
    p_lines = "".join(
        f"P\t{pid}\t{','.join(str(v) + '+' for v in vs)}\t*\n"
        for pid, vs in sorted(paths.items())
    )
    return header + s_lines + l_lines + p_lines


def export_gfa(content: str, file_name: str, out_dir: str = "./subgraphs") -> None:
    """validate.rs:207-220."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, file_name), "w") as fh:
        fh.write(content)
