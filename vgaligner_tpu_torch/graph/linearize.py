"""Graph linearization: forward sequence, node-start array, flat edge table.

Behavioral reference: rs-vgaligner src/utils.rs:25-146
(find_graph_seq_length, find_forward_sequence, NodeRef). The reference
walks sorted forward handles, concatenating labels into the forward
string, marking node starts in a bitvector, and recording per node a
NodeRef {seq_idx, edge_idx, edges_to_node} plus a flat edge vector
(left edges then right edges per node).

TPU-native re-design: the node-start bitvector becomes `node_starts`, a
sorted int64 prefix array with the end marker appended — rank is a
searchsorted and select is a direct lookup, replacing the O(seq_len)
loops at index.rs:427-480. The edge vector stores packed handles as
int64, CSR-indexed by `edge_idx`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .handlegraph import HashGraph, handle_id


def find_graph_seq_length(graph: HashGraph) -> int:
    """Total label length over all nodes (utils.rs:25-31)."""
    return sum(len(graph.sequence(h)) for h in graph.handles())


@dataclass
class Linearization:
    """Arrays produced by linearizing a (partially ordered) graph.

    node_starts[i]  — start of the i-th node (sorted-handle order) in the
                      forward string; node_starts[n_nodes] == seq_len is
                      the end marker (the trailing bitvector 1 in the
                      reference, utils.rs:135).
    edge_idx[i]     — start of node i's slice in `edges`; edge_idx[n] is
                      the end marker (utils.rs:138-143).
    edges_to_node[i]— number of incoming (left) edges, which also splits
                      node i's edge slice into [left | right]
                      (index.rs:559-606).
    edges           — packed handles (id*2+orient), left edges then right
                      edges per node, neighbor order preserved.
    """

    seq_fwd: str
    node_starts: np.ndarray  # int64 [n_nodes + 1]
    edge_idx: np.ndarray  # int64 [n_nodes + 1]
    edges_to_node: np.ndarray  # int64 [n_nodes]
    edges: np.ndarray  # int64 [n_edge_entries]
    node_ids: np.ndarray  # int64 [n_nodes], sorted original ids

    @property
    def n_nodes(self) -> int:
        return len(self.node_ids)

    @property
    def seq_len(self) -> int:
        return int(self.node_starts[-1])


def find_forward_sequence_bfs(graph: HashGraph):
    """Queue-based BFS linearization (utils.rs:38-76, unused in the
    reference's main path but part of its public surface).

    Starts at min_id, follows right edges of forward handles, visits in
    FIFO order.  Reference quirks reproduced: the start node is never
    added to the visited list (a cycle back to it would re-enqueue it),
    and nodes unreachable from min_id are silently absent.  Returns
    (forward_str, node_starts, visit_order_ids).
    """
    from .handlegraph import handle_pack

    parts: list[str] = []
    node_starts: list[int] = []
    order: list[int] = []
    bv_pos = 0
    q = [graph.min_id]
    visited: set[int] = set()
    while q:
        nid = q.pop(0)
        seq = graph.sequence(handle_pack(nid, False))
        parts.append(seq)
        node_starts.append(bv_pos)
        order.append(nid)
        bv_pos += len(seq)
        for nb in graph.right_neighbors(handle_pack(nid, False)):
            nb_id = handle_id(nb)
            if nb_id not in visited:
                visited.add(nb_id)
                q.append(nb_id)
    node_starts.append(bv_pos)
    return (
        "".join(parts),
        np.asarray(node_starts, dtype=np.int64),
        np.asarray(order, dtype=np.int64),
    )


def find_forward_sequence(graph: HashGraph) -> Linearization:
    """Linearize the graph following sorted handle order (utils.rs:81-146)."""
    handles = graph.handles()
    n = len(handles)

    parts = []
    node_starts = np.zeros(n + 1, dtype=np.int64)
    edge_idx = np.zeros(n + 1, dtype=np.int64)
    edges_to_node = np.zeros(n, dtype=np.int64)
    edges: list[int] = []

    bv_pos = 0
    for i, handle in enumerate(handles):
        seq = graph.sequence(handle)
        parts.append(seq)

        left = graph.left_neighbors(handle)
        node_starts[i] = bv_pos
        edge_idx[i] = len(edges)
        edges_to_node[i] = len(left)
        edges.extend(left)
        edges.extend(graph.right_neighbors(handle))

        bv_pos += len(seq)

    node_starts[n] = bv_pos
    edge_idx[n] = len(edges)

    return Linearization(
        seq_fwd="".join(parts),
        node_starts=node_starts,
        edge_idx=edge_idx,
        edges_to_node=edges_to_node,
        edges=np.asarray(edges, dtype=np.int64),
        node_ids=np.asarray([handle_id(h) for h in handles], dtype=np.int64),
    )
