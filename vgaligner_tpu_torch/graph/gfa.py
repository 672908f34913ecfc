"""GFA1 parsing into the host graph model.

Behavioral reference: the `gfa` 0.8 crate + HashGraph::from_gfa as used by
rs-vgaligner src/subcommands/index_main.rs:72-74. We parse S (segments),
L (links) and P (paths) lines; segments become nodes, links become oriented
edges in file order (edge-list order matters for parity, see
handlegraph.py), paths keep their oriented step lists.
"""

from __future__ import annotations

from typing import List, Tuple

from .handlegraph import HashGraph, handle_pack


def _parse_orient(tok: str) -> bool:
    if tok == "+":
        return False
    if tok == "-":
        return True
    raise ValueError(f"invalid orientation: {tok!r}")


def parse_gfa(path: str) -> Tuple[
    List[Tuple[int, str]],
    List[Tuple[int, bool, int, bool]],
    List[Tuple[str, List[Tuple[int, bool]]]],
]:
    """Parse a GFA1 file into (segments, links, paths) in file order."""
    segments: List[Tuple[int, str]] = []
    links: List[Tuple[int, bool, int, bool]] = []
    paths: List[Tuple[str, List[Tuple[int, bool]]]] = []

    with open(path, "r") as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            fields = line.split("\t")
            tag = fields[0]
            if tag == "S":
                segments.append((int(fields[1]), fields[2]))
            elif tag == "L":
                links.append(
                    (
                        int(fields[1]),
                        _parse_orient(fields[2]),
                        int(fields[3]),
                        _parse_orient(fields[4]),
                    )
                )
            elif tag == "P":
                steps = []
                for step in fields[2].split(","):
                    if not step:
                        continue
                    steps.append((int(step[:-1]), _parse_orient(step[-1])))
                paths.append((fields[1], steps))
            # H and other lines ignored
    return segments, links, paths


def graph_from_gfa(path: str) -> HashGraph:
    """Build a HashGraph from a GFA1 file (S, L, P lines; file order)."""
    segments, links, paths = parse_gfa(path)
    graph = HashGraph()
    for node_id, seq in segments:
        graph.create_handle(seq, node_id)
    for from_id, from_rev, to_id, to_rev in links:
        graph.create_edge(handle_pack(from_id, from_rev), handle_pack(to_id, to_rev))
    for name, steps in paths:
        pid = graph.create_path(name)
        for node_id, rev in steps:
            graph.append_step(pid, handle_pack(node_id, rev))
    return graph
