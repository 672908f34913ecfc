"""A deterministic, minimal handle-graph model (host side).

Behavioral reference: the `handlegraph` 0.5 crate as used by
rs-vgaligner (HashGraph, Handle). A Handle packs `node_id * 2 +
is_reverse` into one integer (see index.rs:419-421); we keep handles as
plain Python ints with helper functions, which is also exactly the
encoding stored in the device-side edge arrays.

Determinism: the Rust HashGraph stores per-node `left_edges` /
`right_edges` vectors in edge-insertion order (GFA link-line order), and
every consumer in the reference sorts `handles_iter()` output. We store
nodes in an ordered dict and edge lists in insertion order so that the
linearization (utils.rs:81-146), the flat edge vector, and the k-mer DFS
(kmer.rs:347-505) traverse neighbors in the same order as the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

Handle = int  # packed node_id * 2 + is_reverse


def handle_pack(node_id: int, is_reverse: bool) -> Handle:
    return (node_id << 1) | int(is_reverse)


def handle_id(handle: Handle) -> int:
    return handle >> 1


def handle_is_reverse(handle: Handle) -> bool:
    return bool(handle & 1)


def handle_flip(handle: Handle) -> Handle:
    return handle ^ 1


def handle_str(handle: Handle) -> str:
    return f"{handle_id(handle)}{'-' if handle_is_reverse(handle) else '+'}"


@dataclass
class _Node:
    sequence: str
    left_edges: List[Handle] = field(default_factory=list)
    right_edges: List[Handle] = field(default_factory=list)


@dataclass
class _Path:
    path_id: int
    name: str
    is_circular: bool
    nodes: List[Handle] = field(default_factory=list)


class HashGraph:
    """Mutable sequence graph with oriented edges and (optional) paths."""

    def __init__(self) -> None:
        self._nodes: Dict[int, _Node] = {}
        self.min_id: int = 1 << 62
        self.max_id: int = 0
        self.paths: Dict[int, _Path] = {}
        self._path_ids: Dict[str, int] = {}

    # ---- construction -------------------------------------------------

    def create_handle(self, sequence: str, node_id: int) -> Handle:
        if node_id in self._nodes:
            raise ValueError(f"node {node_id} already exists")
        if node_id <= 0:
            raise ValueError("node ids must be positive")
        self._nodes[node_id] = _Node(sequence)
        self.min_id = min(self.min_id, node_id)
        self.max_id = max(self.max_id, node_id)
        return handle_pack(node_id, False)

    def append_handle(self, sequence: str) -> Handle:
        return self.create_handle(sequence, self.max_id + 1 if self._nodes else 1)

    def create_edge(self, left: Handle, right: Handle) -> None:
        """Insert an oriented edge, mirroring HashGraph::create_edge.

        The neighbor is recorded on each endpoint relative to its forward
        orientation; a handle traversed in reverse stores the flipped
        neighbor on its opposite side.
        """
        left_node = self._nodes[handle_id(left)]
        if handle_is_reverse(left):
            left_node.left_edges.append(handle_flip(right))
        else:
            left_node.right_edges.append(right)
        if left != handle_flip(right):
            right_node = self._nodes[handle_id(right)]
            if handle_is_reverse(right):
                right_node.right_edges.append(handle_flip(left))
            else:
                right_node.left_edges.append(left)

    def create_path(self, name: str, is_circular: bool = False) -> int:
        path_id = len(self.paths)
        self.paths[path_id] = _Path(path_id, name, is_circular)
        self._path_ids[name] = path_id
        return path_id

    def append_step(self, path_id: int, handle: Handle) -> None:
        self.paths[path_id].nodes.append(handle)

    # ---- accessors ----------------------------------------------------

    def __len__(self) -> int:
        return len(self._nodes)

    @property
    def n_nodes(self) -> int:
        return len(self._nodes)

    def has_node(self, node_id: int) -> bool:
        return node_id in self._nodes

    def node_ids(self) -> List[int]:
        return sorted(self._nodes.keys())

    def handles(self) -> List[Handle]:
        """Sorted forward handles (callers of handles_iter always sort)."""
        return [handle_pack(i, False) for i in self.node_ids()]

    def sequence(self, handle: Handle) -> str:
        """Node label in handle orientation (revcomp for reverse handles)."""
        seq = self._nodes[handle_id(handle)].sequence
        if handle_is_reverse(handle):
            from ..utils.dna import reverse_complement

            return reverse_complement(seq)
        return seq

    def edges_iter(self, handle: Handle, right: bool) -> List[Handle]:
        """Neighbors of `handle` on its right (or left) side.

        Mirrors handle_edges_iter: a reverse handle reads the opposite
        stored list with each neighbor flipped, so traversal is
        orientation-consistent.
        """
        node = self._nodes[handle_id(handle)]
        rev = handle_is_reverse(handle)
        stored = (node.right_edges if right != rev else node.left_edges)
        if rev:
            return [handle_flip(h) for h in stored]
        return list(stored)

    def right_neighbors(self, handle: Handle) -> List[Handle]:
        return self.edges_iter(handle, right=True)

    def left_neighbors(self, handle: Handle) -> List[Handle]:
        return self.edges_iter(handle, right=False)

    def paths_iter(self) -> Iterable[int]:
        return self.paths.keys()

    def get_path(self, path_id: int) -> _Path:
        return self.paths[path_id]

    def edge_count(self) -> int:
        return sum(len(n.right_edges) + len(n.left_edges) for n in self._nodes.values()) // 2

    def edges(self) -> List[Tuple[Handle, Handle]]:
        out = []
        for nid in self.node_ids():
            h = handle_pack(nid, False)
            for nb in self._nodes[nid].right_edges:
                out.append((h, nb))
        return out
