"""Port vs JAX package: host anchors (``anchors_for_query_host``), the
``ChainAnchor`` view and ``Chain.from_anchor_list``, tolerance 0.

The cases of tests/test_anchors.py (the reference's chain.rs:741-918),
each on graphs built with the port's ``HashGraph`` and with the JAX
package's, held to the counts and orients those tests state and to the
JAX function's anchor list; then the device lookup against the host
anchors, and chains rebuilt from their anchor lists.
"""

import numpy as np
import pytest
import torch

from vgaligner_tpu.graph.handlegraph import HashGraph as JaxGraph
from vgaligner_tpu.index import Index as JaxIndex
from vgaligner_tpu.io.fastx import QuerySequence as JaxQuery
from vgaligner_tpu.models.mapper import Chain as JaxChain
from vgaligner_tpu.models.mapper import anchors_for_query_host as jax_anchors

from vgaligner_tpu_torch.graph.handlegraph import HashGraph
from vgaligner_tpu_torch.index import Index
from vgaligner_tpu_torch.index.device_index import device_index
from vgaligner_tpu_torch.index.kmer_gen import FORWARD, REVERSE
from vgaligner_tpu_torch.io.fastx import QuerySequence
from vgaligner_tpu_torch.models.mapper import Chain, ChainAnchor, anchors_for_query_host
from vgaligner_tpu_torch.ops.encode import encode_reads_host, window_kmer_codes
from vgaligner_tpu_torch.ops.lookup import lookup_and_materialize_anchors

CPU = torch.device("cpu")


def _diamond(cls):
    """The diamond debug graph (index.rs:646-678): 1 A -> {2 CT, 3 GA} -> 4 GCA."""
    g = cls()
    h = [g.create_handle(s, i) for i, s in enumerate(("A", "CT", "GA", "GCA"), start=1)]
    for a, b in ((0, 1), (0, 2), (1, 3), (2, 3)):
        g.create_edge(h[a], h[b])
    for name, steps in (("P1", (0, 1, 3)), ("P2", (0, 2, 3))):
        p = g.create_path(name)
        for i in steps:
            g.append_step(p, h[i])
    return g


def _bubble(cls, labels):
    """1 -> {2, 3} -> 4 with the given labels."""
    g = cls()
    h = [g.create_handle(s, i) for i, s in enumerate(labels, start=1)]
    for a, b in ((0, 1), (0, 2), (1, 3), (2, 3)):
        g.create_edge(h[a], h[b])
    return g


def _single(cls):
    g = cls()
    g.create_handle("ACT", 1)
    return g


_LONG = ("AAAAAAAAAAA", "C", "G", "TTTTTTTTTTTT")
_AAA = ("AAA", "CCC", "GGG", "AAA")
# (graph, k, query, only_forward, anchors expected): chain.rs:741-918
_CASES = {
    "found": (_diamond, 3, "ACTGCA", True, 4),
    "found_overlapping": (_diamond, 3, "AGAGC", True, 3),
    "found_2": (lambda c: _bubble(c, _LONG), 11, "AAAAACTTTTTT", True, 2),
    "simple": (_single, 3, "ACT", False, 1),
    "simple_reverse": (lambda c: _bubble(c, _AAA), 3, "TTT", False, 2),
    "simple_reverse_2": (lambda c: _bubble(c, _AAA), 9, "TTTCCCTTT", False, 1),
    "none": (_diamond, 3, "AAATTT", False, 0),
    "empty": (_diamond, 3, "", False, 0),
    "reverse_only_forward": (lambda c: _bubble(c, _AAA), 3, "TTT", True, 0),
}


def _both(case):
    make, k, query, only_forward, _n = _CASES[case]
    index = Index.build(make(HashGraph), k, 100, 100)
    got = anchors_for_query_host(index, QuerySequence.from_string(query), only_forward)
    jindex = JaxIndex.build(make(JaxGraph), k, 100, 100)
    want = jax_anchors(jindex, JaxQuery.from_string(query), only_forward)
    return index, got, want


@pytest.mark.parametrize("case", sorted(_CASES))
def test_host_anchors_equal_jax(case):
    _index, got, want = _both(case)
    assert len(got) == _CASES[case][4]
    assert [tuple(a) for a in got] == [tuple(a) for a in want]
    assert all(type(a) is ChainAnchor for a in got)
    if want:
        assert ChainAnchor._fields == type(want[0])._fields


def test_simple_anchor_fields():
    _index, got, _want = _both("simple")
    a = got[0]
    assert (a.qb, a.qe, a.so, a.tb, a.eo, a.te) == (0, 3, FORWARD, 0, FORWARD, 3)


@pytest.mark.parametrize("case,nodes", [("simple_reverse", [(4, 4), (1, 1)]),
                                        ("simple_reverse_2", [(4, 1)])])
def test_reverse_anchors_land_on_their_nodes(case, nodes):
    index, got, _want = _both(case)
    for a, (first, last) in zip(got, nodes):
        assert (a.so, a.eo) == (REVERSE, REVERSE)
        assert index.node_id_from_seqpos(a.so, a.tb) == first
        assert index.node_id_from_seqpos(a.eo, a.te - 1) == last


def test_device_anchors_match_host():
    """The lookup path's forward-only anchors equal the host anchors, in
    the same order (tests/test_anchors.py's device check)."""
    index = Index.build(_diamond(HashGraph), 3, 100, 100)
    q = QuerySequence.from_string("ACTGCA")
    host = anchors_for_query_host(index, q, True)
    codes, lens = encode_reads_host([q.seq], 8)
    wcodes, wvalid = window_kmer_codes(torch.from_numpy(codes), torch.from_numpy(lens), 3)
    batch = lookup_and_materialize_anchors(device_index(index, CPU), wcodes, wvalid, 16)
    n = int(batch.n_anchors[0])
    assert n == len(host) == 4
    got = [tuple(int(x[0][i]) for x in (batch.qb, batch.tb, batch.te)) for i in range(n)]
    assert got == [(a.qb, a.tb, a.te) for a in host]


@pytest.mark.parametrize("case", ["found", "simple_reverse", "empty"])
def test_chain_from_anchor_list_equals_jax(case):
    _index, got, want = _both(case)
    query = _CASES[case][2]
    c = Chain.from_anchor_list(QuerySequence.from_string(query), got)
    jc = JaxChain.from_anchor_list(JaxQuery.from_string(query), want)
    for name in ("aqb", "atb", "ate", "aso", "aeo"):
        g, w = getattr(c, name), getattr(jc, name)
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert (c.k, c.n_anchors) == (jc.k, jc.n_anchors)
    assert c.anchors == got
    assert [tuple(a) for a in c.anchors] == [tuple(a) for a in jc.anchors]


def test_anchors_view_defaults_to_forward():
    c = Chain(query=QuerySequence.from_string("ACGT"), aqb=np.array([0, 2]),
              atb=np.array([5, 9]), ate=np.array([8, 12]), k=3)
    assert c.anchors == [ChainAnchor(0, 0, 3, 5, 8), ChainAnchor(1, 2, 5, 9, 12)]
    assert c.anchors[0].so == c.anchors[0].eo == FORWARD
    assert Chain(query=c.query).anchors == []
