"""Port vs JAX package: the local gapless POA as the one-warp kernel
(kernels/csrc/poa_local_warp.cu) must reproduce it, tolerance 0.

  * ``poa_local``'s CPU route (the plain twin the kernel is held to on
    the card) against JAX ``poa_local_kernel`` on batches with far
    predecessors (``far_frac`` 0.3), more far vertices than the kernel
    pins, a predecessor at and one past its vertex, nv far below V and
    nv = 0, at P 2/4/8 x W 32/128/256;
  * the far-vertex plan (``far_vertices_plain``, ``backing_rows_plain``)
    against counts made by hand on those batches;
  * a problem's outputs do not depend on the rows from its own nv to the
    batch's largest, which the kernel never computes;
  * the kernel source's ring and pin sizes are the ones the plan uses,
    and its backing store holds the host-counted rows (``back_off``), not
    a plane indexed by vertex;
  * the warp route's launch plan: ``local_problem_bytes`` against a hand
    count with counted rows, ``local_chunks`` (real problems in order
    under the budget, the host's backing rows of each, a problem over the
    budget alone), the drain refusing a problem marked short of rows, and
    ``align_local_batch`` under a small budget equal to one launch a
    bucket, the host oracle and JAX's ``align_local_batch``;
  * ``far_rows_local_batch`` (the CUDA tests' far rows in the last bitmap
    words): the twin against JAX, and its best run over the far edge.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vgaligner_tpu.ops import poa_device as JPD

from vgaligner_tpu_torch import kernels
from vgaligner_tpu_torch.ops import poa_device as PD
from vgaligner_tpu_torch.ops.poa import align_local_no_gap_host, build_base_graph
from vgaligner_tpu_torch.testing import (far_rows_local_batch, one_torch_thread,
                                         random_local_batch, with_local_edge_cases)

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)
NAMES = ("best", "tape", "tlen", "qend")
CPU = torch.device("cpu")


def _batch(P, W, V=None, B=8):
    V = V or (128 if W == 256 else 256)
    return with_local_edge_cases(random_local_batch(40 + P * 7 + W, B, V, P, W - 1,
                                                    far_frac=0.3))


def _far_by_hand(vpred, nv, ring):
    return [len({int(p) for v in range(int(nv[b])) for p in vpred[b, v] if 0 <= p < v - ring})
            for b in range(len(nv))]


@pytest.mark.parametrize("W", [32, 128, 256])
@pytest.mark.parametrize("P", [2, 4, 8])
def test_poa_local_cpu_route_matches_jax(P, W):
    arrs = _batch(P, W)
    want = jax.device_get(JPD.poa_local_kernel(*(jnp.asarray(a) for a in arrs)))
    before = kernels.launch_counts()
    got = PD.poa_local(*(torch.from_numpy(a) for a in arrs))
    assert kernels.launch_counts() == before  # CPU tensors: the plain twin, no kernel
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype),
                                      err_msg=name)
    best, _tape, tlen, _qend = (g.numpy() for g in got)
    assert best[0] == 0 and tlen[0] == 0 and tlen[3] == 0  # all-N query; nv = 0
    assert tlen.max() >= 4
    n_backing = PD.backing_rows_plain(torch.from_numpy(arrs[1]), torch.from_numpy(arrs[2]),
                                      PD.LOCAL_RING, PD.LOCAL_PINS)
    assert (n_backing > 0).any()  # more far vertices than pins: the backing store


@pytest.mark.parametrize("P", [2, 4, 8])
def test_poa_local_warp_cpu_route_outputs(P):
    """``poa_local_warp`` on the CPU: the plain twin's four outputs and
    the backing rows of the kernel's plan."""
    arrs = _batch(P, 128)
    t = [torch.from_numpy(a) for a in arrs]
    got = PD.poa_local_warp(*t)
    for g, w in zip(got[:4], PD.poa_local_plain(*t)):
        assert torch.equal(g, w)
    assert torch.equal(got[4], PD.backing_rows_plain(t[1], t[2], PD.LOCAL_RING, PD.LOCAL_PINS))


@pytest.mark.parametrize("P", [2, 4, 8])
def test_far_vertex_plan_matches_hand_counts(P):
    _vc, vpred, nv, _q, _nq = _batch(P, 128)
    vp, nvt = torch.from_numpy(vpred), torch.from_numpy(nv)
    for ring in (PD.LOCAL_RING, 16):
        assert PD.far_vertices_plain(vp, nvt, ring).tolist() == _far_by_hand(vpred, nv, ring)
    far = _far_by_hand(vpred, nv, PD.LOCAL_RING)
    got = PD.backing_rows_plain(vp, nvt, PD.LOCAL_RING, PD.LOCAL_PINS).tolist()
    assert got == [max(0, f - PD.LOCAL_PINS) for f in far]
    assert max(far) > PD.LOCAL_PINS


@pytest.mark.parametrize("P,W", [(2, 128), (4, 32), (8, 256)])
def test_rows_past_a_problems_nv_change_nothing(P, W):
    """Each problem alone (batch max nv = its own nv) gives the outputs
    it gives inside the batch."""
    arrs = _batch(P, W, V=96)
    whole = PD.poa_local_plain(*(torch.from_numpy(a) for a in arrs))
    for b in range(arrs[0].shape[0]):
        alone = PD.poa_local_plain(*(torch.from_numpy(np.ascontiguousarray(a[b : b + 1]))
                                     for a in arrs))
        for name, w, g in zip(NAMES, whole, alone):
            assert torch.equal(w[b : b + 1], g), (b, name)


def test_predecessor_at_or_past_its_vertex_reads_zero():
    """A live slot naming its own vertex or a later one reads the zero
    row, as a dead slot does: the same outputs as with that slot dead."""
    arrs = _batch(4, 128)
    vpred = arrs[1]
    v = int(arrs[2][1]) // 2
    assert vpred[1, v, 0] == v and vpred[1, v + 1, 3] >= v + 1
    dead = np.array(vpred, copy=True)
    dead[1, v, 0] = -1
    dead[1, v + 1, 3] = -1
    t = [torch.from_numpy(a) for a in arrs]
    with_self = PD.poa_local_plain(*t)
    t[1] = torch.from_numpy(dead)
    for g, w in zip(with_self, PD.poa_local_plain(*t)):
        assert torch.equal(g, w)


def test_kernel_source_sizes_match_the_plan():
    src = os.path.join(os.path.dirname(kernels.__file__), "csrc", "poa_local_warp.cu")
    with open(src) as fh:
        text = fh.read()
    sizes = {m.group(1): int(m.group(2))
             for m in re.finditer(r"constexpr int (RING|SLOTS|PINS) = (\d+);", text)}
    assert sizes["RING"] == PD.LOCAL_RING and sizes["PINS"] == PD.LOCAL_PINS
    assert sizes["SLOTS"] >= 2 * sizes["RING"] and sizes["SLOTS"] & (sizes["SLOTS"] - 1) == 0
    assert "poa_local_warp.cu" in kernels.SOURCES
    assert PD.LOCAL_WARP_WIDTHS == (32, 64, 128, 256)


def test_build_log_kept_beside_the_library(tmp_path, monkeypatch):
    """A library built by an earlier process is not rebuilt, and its
    ptxas report (which chip_smoke.py prints for K7) is read back."""
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kernels, "build_log", "")
    path = kernels.library_path()
    with open(path, "wb"):
        pass
    assert kernels.build() == path and kernels.build_log == ""
    with open(f"{path}.log", "w") as fh:
        fh.write("ptxas info    : Used 40 registers")
    assert kernels.build() == path and kernels.build_log.endswith("40 registers")


def test_kernel_source_takes_counted_backing_rows():
    """K7's store is K9's layout: rows [back_off[b], back_off[b + 1]),
    far rows numbered by rank (a running count for writes, the bitmap and
    one redux.sync for reads), tlen -1 for a problem short of rows; the
    store is no longer a plane indexed by vertex."""
    src = os.path.join(os.path.dirname(kernels.__file__), "csrc", "poa_local_warp.cu")
    with open(src) as fh:
        text = fh.read()
    assert "const int* __restrict__ back_off" in text and "const void* back_off" in text
    assert "backing + (size_t)back_off[b] * W" in text
    assert "backing + (size_t)b * V * W" not in text and "back_b + (size_t)pp * W" not in text
    assert "n_back = min(n_far, back_off[b + 1] - back_off[b])" in text
    assert "back_b + (size_t)rank * W" in text and "back_b + (size_t)n_written * W" in text
    assert "__reduce_add_sync" in text and "tlen[b] = n_back < n_far ? -1 : n;" in text
    assert "if (b >= B) return;" in text.split("back_off[b", 1)[0]  # odd B: no read past B


# ---------------------------------------------------------------------------
# the warp route's launch plan


@pytest.mark.parametrize("V,W,P,w", [(256, 128, 2, 128), (128, 256, 8, 256), (256, 100, 4, 128)])
def test_warp_route_problem_bytes_match_a_hand_count(V, W, P, w):
    """Inputs, cells, tape, scalars and the counted int16 backing rows at
    the route's width w (100 runs at 128, its query padded), as K9's."""
    assert PD.local_route(W) == ("poa_local_warp", w)
    back = np.array([0, 1, 7, 40])
    inputs = V + 4 * V * P + (W - 1) + 4 + 4 + 4  # codes, preds, q, nv, nq, offset
    cells = V * w
    tape = 4 * w
    scalars = 4 * 4  # best, tlen, qend, n_backing
    padded_q = (w - 1) if w != W else 0
    want = [inputs + cells + tape + scalars + padded_q + 2 * w * r for r in back]
    assert PD.local_problem_bytes(V, W, P, back).tolist() == want
    # no whole plane: a problem with no far row costs no backing byte
    assert want[0] < V * w * 2


def _local_problem(rng, n_nodes, max_label, q_len, far=0.3, mutate=0.05):
    """A random DAG (chain edges plus skips back, with probability
    ``far`` a node) and a query read off one of its walks, mutated, cut or
    repeated to ``q_len``."""
    nodes = ["".join("ACGT"[c] for c in rng.integers(0, 4, int(rng.integers(1, max_label + 1))))
             for _ in range(n_nodes)]
    edges = [(b - 1, b) for b in range(1, n_nodes)]
    edges += [(int(rng.integers(0, b - 1)), b) for b in range(2, n_nodes) if rng.random() < far]
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


def _warp_bucket(seed, n_far=11, n_near=12):
    """(problems, base graphs, encoded queries) of one V 256 x L 127
    bucket (K7's route): problems with far skips past the pins, then
    chains (no backing row)."""
    from vgaligner_tpu_torch.utils.dna import encode_seq

    rng = np.random.default_rng(seed)
    probs = ([_local_problem(rng, 45, 5, 100) for _ in range(n_far)]
             + [_local_problem(rng, 45, 5, 100, far=0.0) for _ in range(n_near)])
    bgs = [build_base_graph(n, e) for n, e, _q in probs]
    assert all(len(bg.codes) <= 256 for bg in bgs)
    return probs, bgs, [encode_seq(q) for _n, _e, q in probs]


@pytest.mark.parametrize("budget_in_problems", [0.5, 1.0, 2.5, 7.0, 100.0])
def test_warp_route_chunks_carry_the_backing_rows(budget_in_problems):
    """``local_chunks`` at W 128: real problems in order, each launch under
    the budget (greedy), and back_rows the host's ``backing_rows_plain``
    of each problem, which the bytes count."""
    _probs, bgs, qs = _warp_bucket(3)
    (_s, _e, whole, back), = PD.local_chunks(bgs, qs, 256, 127, 1 << 40)
    want = PD.backing_rows_plain(torch.from_numpy(whole[1]), torch.from_numpy(whole[2]),
                                 PD.LOCAL_RING, PD.LOCAL_PINS).numpy()
    np.testing.assert_array_equal(back, want)
    assert (back[:11] > 0).any() and (back[11:] == 0).all()
    per = PD.local_problem_bytes(256, 128, whole[1].shape[-1], back)
    assert len(set(per.tolist())) > 1  # backing rows cost their bytes
    budget = int(budget_in_problems * per.min())
    chunks = list(PD.local_chunks(bgs, qs, 256, 127, budget))
    starts = [s for s, _e, _a, _b in chunks]
    ends = [e for _s, e, _a, _b in chunks]
    assert starts == [0] + ends[:-1] and ends[-1] == 23
    for s, e, arrs, rows in chunks:
        for a, full in zip(arrs, whole):
            np.testing.assert_array_equal(a, full[s:e])  # real problems only
        np.testing.assert_array_equal(rows, back[s:e])
        assert e - s == 1 or per[s:e].sum() <= budget
        if e < 23:  # greedy: the next problem would not have fitted
            assert per[s : e + 1].sum() > budget
    if budget_in_problems < 1:
        assert all(e - s == 1 for s, e, _a, _b in chunks)
    if budget_in_problems == 100.0:
        assert len(chunks) == 1


def test_a_warp_route_problem_over_the_budget_runs_alone():
    """A problem whose backing rows take it past the budget gets a launch
    of its own at W 128; its neighbours still share theirs."""
    from vgaligner_tpu_torch.utils.dna import encode_seq

    rng = np.random.default_rng(5)
    probs = [_local_problem(rng, 40, 5, 100, far=0.0) for _ in range(13)]
    # problem 6: 250 one-base nodes, each also reading the one 10 back
    nodes = ["ACGT"[int(c)] for c in rng.integers(0, 4, 250)]
    probs[6] = (nodes, [(b - 1, b) for b in range(1, 250)] + [(b - 10, b) for b in range(10, 250)],
                "".join(nodes[:100]))
    bgs = [build_base_graph(n, e) for n, e, _q in probs]
    qs = [encode_seq(q) for _n, _e, q in probs]
    (_s, _e, _a, back), = PD.local_chunks(bgs, qs, 256, 127, 1 << 40)
    assert back[6] > 200 and (np.delete(back, 6) == 0).all()
    per = PD.local_problem_bytes(256, 128, 2, back)
    budget = int(2.5 * per.max(where=back == 0, initial=0))
    assert per[6] > budget
    chunks = [(s, e) for s, e, _a, _b in PD.local_chunks(bgs, qs, 256, 127, budget)]
    assert chunks == [(0, 2), (2, 4), (4, 6), (6, 7), (7, 9), (9, 11), (11, 13)]


def test_drain_refuses_a_short_warp_route_problem(monkeypatch):
    """K7 marks a problem it could not give every backing row with tlen
    -1, as K9 does; the drain of a W 128 bucket raises on it."""
    probs, _bgs, _qs = _warp_bucket(7, 3, 1)
    calls = []
    real = PD.poa_local_warp

    def short(vcodes, vpred, nv, q, nq, back_rows=None):
        calls.append(back_rows)
        best, tape, tlen, qend, nb = real(vcodes, vpred, nv, q, nq, back_rows)
        return best, tape, torch.where(torch.arange(len(tlen)) == 1, -1, tlen), qend, nb

    monkeypatch.setattr(PD, "poa_local_warp", short)
    with pytest.raises(RuntimeError, match="local POA route.*backing rows"):
        PD.align_local_batch(probs, CPU)
    assert len(calls) == 1 and calls[0] is not None and len(calls[0]) == 4


def test_align_local_batch_on_the_warp_route_chunked(monkeypatch):
    """``align_local_batch`` at W 128 and 256 under a budget of a few
    problems a launch: K7's wrapper gets each launch's host-counted rows,
    and every result equals the route in one launch a bucket, the host
    oracle and the JAX package's ``align_local_batch``."""
    probs = _warp_bucket(11)[0]
    rng = np.random.default_rng(12)
    probs += [_local_problem(rng, 60, 5, 200) for _ in range(4)]  # V 256 x L 255, W 256
    launches = []
    real = PD.poa_local_warp

    def spy(vcodes, vpred, nv, q, nq, back_rows=None):
        want = PD.backing_rows_plain(vpred, nv, PD.LOCAL_RING, PD.LOCAL_PINS).numpy()
        np.testing.assert_array_equal(back_rows, want)
        launches.append((vcodes.shape[0], q.shape[1] + 1))
        return real(vcodes, vpred, nv, q, nq, back_rows)

    monkeypatch.setattr(PD, "poa_local_warp", spy)
    whole = PD.align_local_batch(probs, CPU)
    assert sorted(launches) == [(4, 256), (23, 128)]
    launches.clear()
    monkeypatch.setattr(PD, "_LOCAL_BUDGET",
                        3 * int(PD.local_problem_bytes(256, 128, 2, [0])[0]))
    chunked = PD.align_local_batch(probs, CPU)
    assert len(launches) > 2 and sum(b for b, _w in launches) == len(probs)
    assert max(b for b, w in launches if w == 128) <= 3
    want = JPD.align_local_batch(probs)
    for i, (c, w1, prob, j) in enumerate(zip(chunked, whole, probs, want)):
        assert c == w1 == align_local_no_gap_host(*prob), i
        assert dataclasses.astuple(c) == dataclasses.astuple(j), i
    assert sum(r.n_aligned > 20 for r in chunked) >= 20


def test_far_rows_batch_matches_jax():
    """``far_rows_local_batch`` at V 2,048 x W 256: the twin equals JAX
    ``poa_local_kernel``; problem 0 keeps 56 backing rows, f's row ranks
    behind every other far vertex's, and its best run takes the far edge
    u <- f (problem 1: the same run over a pinned row)."""
    V = 2048
    arrs = far_rows_local_batch(V, 256)
    t = [torch.from_numpy(a) for a in arrs]
    got = PD.poa_local(*t)
    want = jax.device_get(JPD.poa_local_kernel(*(jnp.asarray(a) for a in arrs)))
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype),
                                      err_msg=name)
    assert PD.backing_rows_plain(t[1], t[2], PD.LOCAL_RING, PD.LOCAL_PINS).tolist() == [56, 0]
    f = V - 140
    for b in range(2):
        _ops, vids = PD.unpack_tape(got[1][b, : got[2][b]].numpy())
        at = list(vids).index(f + 30)
        assert vids[at + 1] == f and int(got[2][b]) >= 200


def test_probe_takes_an_earlier_warp_kernel():
    """``kernel_probe --old-local-warp PATH`` is a flag of its own, and
    the probe refuses to run without a card."""
    from vgaligner_tpu_torch import kernel_probe

    src = os.path.join(os.path.dirname(kernels.__file__), "csrc", "poa_local_warp.cu")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a CUDA GPU"):
            kernel_probe.main(["--old-local-warp", src])
    with pytest.raises(SystemExit):
        kernel_probe.main(["--old-local-warp"])  # the flag takes a path
    assert "--old-local-warp PATH" in kernel_probe.__doc__
