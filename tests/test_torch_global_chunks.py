"""The global POA route's launch plan on the CPU: ``global_problem_bytes``
against counts made by hand, ``global_chunks`` (real problems only, in
order, each launch under the byte budget, a problem over it alone), and
the route under a small budget against the same route in one launch a
bucket, the host oracle and the JAX package, tolerance 0.  The fused
kernels' twins keep reporting ``backing_rows_plain``; the kernels
themselves are held in tests/test_torch_cuda_kernels.py."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from vgaligner_tpu.ops import poa_device as JPD

from vgaligner_tpu_torch.ops import poa_device as PD
from vgaligner_tpu_torch.ops.poa import align_global_host
from vgaligner_tpu_torch.testing import one_torch_thread, random_poa_batch

CPU = torch.device("cpu")
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


def _built(seed, B, V, P, L, far_frac=0.2):
    """A bucket in the native builder's layout: (vcodes, vpred, is_sink,
    nv, node_of, off_in), predecessor slots padded to P_MAX."""
    vc, vp, sk, nv, _q, _nq = random_poa_batch(seed, B, V, P, L, far_frac=far_frac)
    vpred = np.full((B, V, PD.P_MAX), -1, dtype=np.int32)
    vpred[..., :P] = vp
    zeros = np.zeros((B, V), dtype=np.int32)
    return vc, vpred, sk, nv, zeros, zeros.copy()


def _mixed(seed, B_far, B_near, V, P, L):
    """Problems with far predecessors past the pins, then problems within
    the row ring (no backing rows)."""
    far, near = _built(seed, B_far, V, P, L, 0.3), _built(seed + 1, B_near, V, P, L, 0.0)
    return tuple(np.concatenate(x) for x in zip(far, near))


def _back(built):
    return PD.backing_rows_plain(torch.from_numpy(built[1]), torch.from_numpy(built[3])).numpy()


@pytest.mark.parametrize("V,W,P,w", [(256, 128, 2, 128), (2048, 2048, 4, 2048),
                                     (512, 384, 8, 512)])
def test_problem_bytes_match_a_hand_count(V, W, P, w):
    """Inputs, tbits, tape, scalars, backing rows at the route's width w,
    and the query padded to w - 1 columns where w != W (384 runs at 512)."""
    assert PD.global_route(W)[1] == w
    back = np.array([0, 1, 7])
    inputs = V + V + 4 * V * P + (W - 1) + 4 + 4 + 4  # codes, sinks, preds, q, nv, nq, offset
    tbits = 4 * V * w
    tape = 4 * (V + w + 1)
    scalars = 4 * 4  # score, best sink, tlen, n_backing
    padded_q = (w - 1) if w != W else 0
    want = [inputs + tbits + tape + scalars + padded_q + 3 * w * 4 * r for r in back]
    assert PD.global_problem_bytes(V, W, P, back).tolist() == want


@pytest.mark.parametrize("budget_in_problems", [0.5, 1.0, 2.5, 7.0, 100.0])
def test_chunks_are_real_problems_in_order_under_the_budget(budget_in_problems):
    built = _mixed(3, 11, 12, 256, 2, 127)
    back = _back(built)
    assert (back > 0).any() and (back == 0).any()
    per = PD.global_problem_bytes(256, 128, 2, back)
    budget = int(budget_in_problems * per.min())
    chunks = list(PD.global_chunks(built, 256, 127, budget))
    starts = [s for s, _e, _a, _b in chunks]
    ends = [e for _s, e, _a, _b in chunks]
    assert starts == [0] + ends[:-1] and ends[-1] == 23
    for s, e, arrs, rows in chunks:
        assert all(a.shape[0] == e - s for a in arrs)  # real problems only
        for i, (a, full) in enumerate(zip(arrs, built)):
            want = full[s:e, :, :2] if i == 1 else full[s:e]  # vpred at the bucket's fan-in
            np.testing.assert_array_equal(a, want)
        np.testing.assert_array_equal(rows, back[s:e])
        if e - s > 1:
            assert per[s:e].sum() <= budget
        else:
            assert e == 23 or per[s : e + 1].sum() > budget
        if e < 23:  # greedy: the next problem would not have fitted
            assert per[s : e + 1].sum() > budget
    if budget_in_problems < 1:
        assert all(e - s == 1 for s, e, _a, _b in chunks)  # each over the budget, alone
    if budget_in_problems == 100.0:
        assert len(chunks) == 1


def test_a_problem_over_the_budget_runs_alone():
    """A problem whose backing rows take it past the budget gets a launch
    of its own; its neighbours still share theirs."""
    built = _built(4, 13, 256, 2, 127, far_frac=0.0)
    # problem 6: every vertex also reads the one 10 rows back, so nearly
    # all of its vertices take a backing row
    built[3][6] = 256
    built[1][6, 10:, 1] = np.arange(246)
    back = _back(built)
    assert back[6] > 200 and (np.delete(back, 6) == 0).all()
    per = PD.global_problem_bytes(256, 128, 2, back)
    budget = int(3 * per.max(where=back == 0, initial=0))
    assert per[6] > budget
    chunks = [(s, e) for s, e, _a, _b in PD.global_chunks(built, 256, 127, budget)]
    assert chunks == [(0, 3), (3, 6), (6, 7), (7, 10), (10, 13)]


def test_the_twins_report_the_backing_rows_of_their_plan():
    """On the CPU, both fused wrappers run the plain pair and return
    n_backing = backing_rows_plain (far vertices past the 4 pins), which
    a count by hand confirms, and ignore ``back_rows``."""
    for W in (128, 512):
        arrs = random_poa_batch(W, 6, 128, 4, W - 1, far_frac=0.3)
        t = [torch.from_numpy(a) for a in arrs]
        init = torch.from_numpy(PD.make_init_row(W - 1))
        fused = PD.poa_dp_tb if W == 128 else PD.poa_dp_tb_cluster
        vpred, nv = arrs[1], arrs[3]
        by_hand = [max(0, len({int(p) for v in range(int(nv[b])) for p in vpred[b, v]
                               if 0 <= p < v - PD.TB_RING}) - PD.TB_PINS) for b in range(6)]
        assert max(by_hand) > 0
        nb = fused(*t, init)[5]
        assert nb.tolist() == by_hand == PD.backing_rows_plain(t[1], t[3]).tolist()
        short = fused(*t, init, np.zeros(6, dtype=np.int64))
        for g, w in zip(short, fused(*t, init)):
            assert torch.equal(g, w)


def test_a_short_problem_raises_on_the_route():
    """tlen -1 (the kernels' mark of a problem given too few backing rows)
    makes the drain raise, with no fallback."""
    tlen = torch.tensor([3, -1], dtype=torch.int32)
    pending = ((torch.zeros(2), torch.zeros((2, 8), dtype=torch.int32), tlen),
               None, None, None, None, 256, [np.zeros(3, np.int8)] * 2)
    with pytest.raises(RuntimeError, match="backing rows"):
        PD.kernel_finish_all([pending])


def _problem(rng, n_nodes, max_label, q_len, mutate=0.08):
    """A random DAG (chain edges plus skips, some far back) and a query
    read off one of its walks, mutated, cut or repeated to ``q_len``."""
    nodes = ["".join("ACGT"[c] for c in rng.integers(0, 4, int(rng.integers(1, max_label + 1))))
             for _ in range(n_nodes)]
    edges = [(b - 1, b) for b in range(1, n_nodes)]
    edges += [(int(rng.integers(0, b - 1)), b) for b in range(2, n_nodes) if rng.random() < 0.3]
    succ = {}
    for a, b in edges:
        succ.setdefault(a, []).append(b)
    walk, cur = [nodes[0]], 0
    while cur in succ:
        cur = succ[cur][int(rng.integers(len(succ[cur])))]
        walk.append(nodes[cur])
    seq = "".join(walk)
    seq = (seq * (q_len // max(len(seq), 1) + 1))[:q_len]
    q = "".join(c if rng.random() > mutate else "ACGT"[int(rng.integers(4))] for c in seq)
    return nodes, edges, q


@pytest.fixture(scope="module")
def problems():
    rng = np.random.default_rng(12)
    probs = [_problem(rng, 40, 5, 100) for _ in range(7)]  # V 256, W 128 (K6)
    probs += [_problem(rng, 120, 6, 200) for _ in range(3)]  # V 512, W 256 (K6)
    probs += [_problem(rng, 90, 6, 300) for _ in range(3)]  # W 512 (K8)
    return probs


def _launches(monkeypatch, fn, *args):
    """fn(*args) with every ``kernel_dispatch`` recorded: (result, the
    number of problems of each launch)."""
    sizes = []
    real = PD.kernel_dispatch

    def spy(chunk, qs, *rest):
        sizes.append(len(qs))
        assert chunk[0].shape[0] == len(qs)
        return real(chunk, qs, *rest)

    monkeypatch.setattr(PD, "kernel_dispatch", spy)
    out = fn(*args)
    monkeypatch.setattr(PD, "kernel_dispatch", real)
    return out, sizes


def test_align_global_batch_chunked_equals_one_launch_host_and_jax(monkeypatch, problems):
    whole, one = _launches(monkeypatch, PD.align_global_batch, problems, CPU)
    assert one == [7, 3, 3]  # one launch a (V, L) bucket under the 6 GiB budget
    monkeypatch.setattr(PD, "_HBM_BUDGET", 2 * int(PD.global_problem_bytes(256, 128, 8, [2])[0]))
    chunked, sizes = _launches(monkeypatch, PD.align_global_batch, problems, CPU)
    assert len(sizes) > 3 and sum(sizes) == len(problems) and max(sizes) <= 2
    want = JPD.align_global_batch(problems)
    for i, (c, w1, prob, j) in enumerate(zip(chunked, whole, problems, want)):
        assert c == w1 == align_global_host(*prob), i
        assert dataclasses.astuple(c) == dataclasses.astuple(j), i


def test_cli_route_chunked_equals_one_launch_and_the_host_oracle(monkeypatch, tmp_path):
    """``PoaAligner._dispatch_chains`` (the CLI's abPOA route) under a
    budget of a few problems a launch: every PoaResult and node path
    equal to the route in one launch a bucket and to the host oracle on
    the extracted subgraph."""
    from vgaligner_tpu_torch.graph import graph_from_gfa
    from vgaligner_tpu_torch.index import Index
    from vgaligner_tpu_torch.io.fastx import QuerySequence
    from vgaligner_tpu_torch.models.mapper import Mapper
    from vgaligner_tpu_torch.models.poa_aligner import PoaAligner
    from vgaligner_tpu_torch.testing import sample_reads, write_synthetic_gfa

    gfa = os.path.join(tmp_path, "g.gfa")
    write_synthetic_gfa(gfa, seed=2, backbone_len=1500, n_haplotypes=4)
    graph = graph_from_gfa(gfa)
    index = Index.build(graph, 11, 100, 100)
    reads = sample_reads(graph, 40, 100, seed=8, sub_rate=0.02)
    per_read = Mapper(index, CPU, precision="fast").map_reads(
        [QuerySequence(f"r{i}", r) for i, r in enumerate(reads)])
    aligner = PoaAligner(index, CPU)
    chains = [c for cs in per_read for c in aligner._chains_for_alignment(cs, 1)
              if not c.is_placeholder]
    assert len(chains) >= 30

    def run():
        state = aligner._dispatch_chains(chains)
        return state[3], aligner._finish_chains(state)

    (_sub, whole), one = _launches(monkeypatch, run)
    monkeypatch.setattr(PD, "_HBM_BUDGET", 3 * int(PD.global_problem_bytes(256, 128, 8, [0])[0]))
    (sub, chunked), sizes = _launches(monkeypatch, run)
    assert len(one) < len(sizes) and max(sizes) <= 3 and sum(sizes) == sum(one) == len(chains)
    for i, ((c, ch), (w, wh)) in enumerate(zip(chunked, whole)):
        assert c == w and ch == wh, i
        want = align_global_host(sub.nodes(i), sub.edges(i), chains[i].query.seq)
        sub.rebase(i, want)
        assert c == want, i
