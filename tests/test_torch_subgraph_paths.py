"""abPOA's subgraph export over a batch: the graph's P-lines cut to every
chain's range in one native pass (``native.subgraph_paths_native`` over
``native.path_index``), against the per-chain route's Python
``get_subgraph_paths``, tolerance 0.

  * the native paths of every range of a batch equal the Python's: the
    extractor's ranges in corridor, id and ``--bubble-closure`` mode, the
    ranges of reverse-strand reads mapped with ``--both-strands``, and
    hand-made graphs where a path revisits a handle, walks a range node
    the other way, misses the range, or where there is no P-line;
  * the batch route (``begin_alignments``, which exports through the
    native pass) writes the same files, byte for byte, as the per-chain
    route (``obtain_base_level_alignment``, which keeps the Python), with
    three chains a read and two of them sharing an anchor count, so the
    later chain's file overwrites the earlier one's in both.
"""

import os

import numpy as np
import pytest
import torch

from tests.test_torch_range import _MODES, _alts_last, _oriented_chains
from vgaligner_tpu_torch.graph import graph_from_gfa
from vgaligner_tpu_torch.graph.handlegraph import HashGraph, handle_pack
from vgaligner_tpu_torch.index import Index
from vgaligner_tpu_torch.io.fastx import QuerySequence
from vgaligner_tpu_torch.models import poa_aligner as PA
from vgaligner_tpu_torch.models.mapper import Chain, Mapper, anchors_for_query_host
from vgaligner_tpu_torch.native import path_index, subgraph_paths_native
from vgaligner_tpu_torch.testing import one_torch_thread, sample_reads, write_synthetic_gfa
from vgaligner_tpu_torch.utils.dna import reverse_complement

K = 11
CPU = torch.device("cpu")
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A synthetic graph with alt alleles numbered last (bubble closure
    changes ranges), forward reads mapped on it, and reverse-complement
    reads mapped with both strands."""
    root = tmp_path_factory.mktemp("subgraph_paths")
    gfa = str(root / "graph.gfa")
    write_synthetic_gfa(str(root / "topo.gfa"), seed=6, backbone_len=2000, mean_spacing=12,
                        n_haplotypes=6)
    _alts_last(str(root / "topo.gfa"), gfa, 0.5, seed=6)
    graph = graph_from_gfa(gfa)
    index = Index.build(graph, K, 100, 100)
    reads = sample_reads(graph, 20, 100, seed=31, sub_rate=0.02)
    queries = [QuerySequence.from_name_and_string(f"r{i}", s) for i, s in enumerate(reads)]
    rev = [QuerySequence.from_name_and_string(f"v{i}", reverse_complement(s))
           for i, s in enumerate(reads)]
    return dict(graph=graph, index=index, reads=reads, queries=queries,
                per_read=Mapper(index, CPU, precision="exact").map_reads(queries),
                rev_per_read=Mapper(index, CPU, precision="exact",
                                    both_strands=True).map_reads(rev))


def _hand_made(steps, n_nodes=8):
    """A graph of one-base nodes 1..n_nodes with the given P-lines, each
    a list of (node id, reverse)."""
    g = HashGraph()
    for i in range(1, n_nodes + 1):
        g.create_handle("ACGT"[i % 4], i)
    for name, path in steps.items():
        pid = g.create_path(name)
        for node, rev in path:
            g.append_step(pid, handle_pack(node, rev))
    return g


F, R = False, True
_HAND_MADE = {
    # (paths, ranges as (node id, reverse) lists, the Python's answer per range)
    "revisit": ({"a": [(1, F), (2, F), (3, F), (2, F), (4, F)], "b": [(3, F), (3, F)]},
                [[(2, F), (3, F)], [(4, F), (2, F)]],
                [{0: [1, 2, 1], 1: [2, 2]}, {0: [1, 1, 3], 1: []}]),
    "opposite_orientation": ({"a": [(1, F), (2, R), (3, F)], "b": [(3, R), (2, F), (1, R)]},
                             [[(2, F), (3, F)], [(2, R)], [(1, R), (2, R)]],
                             [{0: [2], 1: [1]}, {0: [1], 1: []}, {0: [2], 1: [1]}]),
    "untouched": ({"a": [(1, F), (2, F), (3, F)], "b": [(2, F), (4, F)]},
                  [[(6, F), (7, F), (8, F)], [(5, F), (5, R)]],
                  [{0: [], 1: []}, {0: [], 1: []}]),
    "no_paths": ({}, [[(1, F), (2, F)], [(5, F)]], [{}, {}]),
}


def _world_ranges(world, case):
    """The native extractor's ranges of the world's chains (``_extract``'s
    flat layout): three chains a read at most, in the case's mode."""
    if case == "both_strands":
        aligner = PA.PoaAligner(world["index"], CPU, range_mode="corridor")
        chains = [c for cs in world["rev_per_read"] for c in cs if not c.is_placeholder]
        assert sum(c.strand == "-" for c in chains) >= 15
        chains += _oriented_chains(world["index"], world["reads"][:8])
    else:
        aligner = PA.PoaAligner(world["index"], CPU, **_MODES[case])
        chains = [c for cs in world["per_read"] for c in aligner._chains_for_alignment(cs, 3)
                  if not c.is_placeholder]
    sub = aligner._extract(chains)
    return sub.handle_off, sub.handles_arr


@pytest.mark.parametrize("case", ["corridor", "id", "bubble", "both_strands",
                                  *_HAND_MADE])
def test_native_paths_equal_the_python(world, case):
    if case in _HAND_MADE:
        steps, ranges, answer = _HAND_MADE[case]
        graph = _hand_made(steps)
        handles = [[handle_pack(n, r) for n, r in rng] for rng in ranges]
        off = np.cumsum([0] + [len(h) for h in handles])
        flat = np.asarray([h for hs in handles for h in hs], dtype=np.int64)
    else:
        graph, answer = world["graph"], None
        off, flat = _world_ranges(world, case)
    want = [PA.get_subgraph_paths(graph, flat[off[i]:off[i + 1]].tolist())
            for i in range(len(off) - 1)]
    got = subgraph_paths_native(path_index(graph), off, flat)
    assert got == want
    assert all(list(d) == sorted(graph.paths_iter()) for d in got)
    if answer is not None:
        assert want == answer
    else:
        assert sum(len(v) for d in got for v in d.values()) >= 1000


def test_native_paths_refuse_an_empty_range_and_bad_offsets(world):
    index = path_index(world["graph"])
    with pytest.raises(ValueError, match="range 1"):
        subgraph_paths_native(index, np.asarray([0, 2, 2]), np.asarray([4, 6]))
    with pytest.raises(ValueError):
        PA.get_subgraph_paths(world["graph"], [])
    for off in ([0, 3], [1, 2], [0, 2, 1, 2], []):
        with pytest.raises(ValueError, match="partition"):
            subgraph_paths_native(index, np.asarray(off, np.int64), np.asarray([4, 6]))
    assert subgraph_paths_native(index, np.zeros(1, np.int64), np.zeros(0, np.int64)) == []


def _twin_chains(world):
    """Each read's mapped chain and two more of its host anchors, the
    first and the last ``n`` of them: same name and anchor count, so the
    second's file replaces the first's, and mostly other ranges."""
    out = []
    for q, cs in zip(world["queries"], world["per_read"]):
        anchors = anchors_for_query_host(world["index"], q)
        n = min(3, len(anchors) // 2)
        if n == 0:
            out.append(cs)
            continue
        out.append(list(cs) + [Chain.from_anchor_list(q, anchors[:n]),
                               Chain.from_anchor_list(q, anchors[-n:])])
    return out


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_batch_export_equals_the_per_chain_route(world, mode, tmp_path, monkeypatch):
    per_read = _twin_chains(world)
    aligner = PA.PoaAligner(world["index"], CPU, graph=world["graph"], export_subgraphs=True,
                            **_MODES[mode])
    twins = [c for cs in per_read for c in aligner._chains_for_alignment(cs, 3)
             if not c.is_placeholder]
    ranges = {}
    for c in twins:
        ranges.setdefault((c.query.name, c.n_anchors), set()).add(
            tuple(aligner._range_for_chain(c).handles))
    assert sum(len(r) > 1 for r in ranges.values()) >= 10  # overwrites that change a file
    for side in ("batch", "per_chain"):
        os.makedirs(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        if side == "batch":
            aligner.finish_alignments(aligner.begin_alignments(per_read, 3))
        else:
            for cs in per_read:
                aligner.best_alignment_for_query(cs, 3)
    names = sorted(os.listdir(tmp_path / "batch" / "subgraphs"))
    assert names == sorted(os.listdir(tmp_path / "per_chain" / "subgraphs"))
    assert len(names) == len(ranges) < len(twins)
    for name in names:
        assert ((tmp_path / "batch" / "subgraphs" / name).read_bytes()
                == (tmp_path / "per_chain" / "subgraphs" / name).read_bytes()), name
