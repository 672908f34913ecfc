"""Port vs JAX package: the local gapless POA at rows of 512-16,384
columns as the cluster kernel (kernels/csrc/poa_local_cluster.cu), and
the local route cut into launches under a byte budget; tolerance 0.

  * ``poa_local``'s CPU route at W 512/1,024/2,048 (V 64) and 16,384 (V
    128) x P 2/4/8 (the plain twin the kernel is held to on the card)
    against JAX ``poa_local_kernel``, on batches with far predecessors,
    more far vertices than the kernel pins, a predecessor at and past its
    vertex, nv far below V and nv = 0; ``poa_local`` routes each width to
    its kernel, off-ladder widths padded on the right (at L 300 and 9,000
    equal to the unpadded twin and to JAX);
  * the largest H the device route can reach: a chain of 8,192 vertices
    matched by its query gives 2 x 8,192 = 16,384, inside K9's int16;
  * a numpy model of the kernel's column split: each slice computes its
    row from its own columns of the ring, pins and backing rows and, for
    its first column, the halo the slice before it pushed (or the global
    backing row), and equals ``poa_local_plain`` at 1/2/4/8 slices, on
    random batches and on a chain whose match run crosses a slice
    boundary over a far edge, pinned and on the backing store;
  * ``align_local_batch`` under a small byte budget: several launches of
    real problems only, equal to the unchunked route and to JAX's; the
    default budget takes the long reads' largest bucket in one launch;
    ``local_problem_bytes`` at the cluster route's widths against a hand
    count (the warp route's: tests/test_torch_local_warp.py);
  * the drain refuses a problem the kernel marks short of backing rows;
  * the kernel source's ring, pin, column and cluster sizes, and the
    edited copies ``kernel_probe`` times.
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
from vgaligner_tpu_torch.testing import (far_jump_local_batch, one_torch_thread,
                                         random_local_batch, with_local_edge_cases)

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)
NAMES = ("best", "tape", "tlen", "qend")
CPU = torch.device("cpu")


def _batch(P, W, V=64):
    far = with_local_edge_cases(random_local_batch(80 + P * 5 + W, 6, V, P, W - 1, far_frac=0.3))
    near = random_local_batch(81 + P * 5 + W, 2, V, P, W - 1, far_frac=0.0)
    return [np.concatenate(x) for x in zip(far, near)]


@pytest.mark.parametrize("W", [512, 1024, 2048, 16384])
@pytest.mark.parametrize("P", [2, 4, 8])
def test_cluster_cpu_route_matches_jax(P, W):
    arrs = _batch(P, W, 128 if W == 16384 else 64)
    want = jax.device_get(JPD.poa_local_kernel(*(jnp.asarray(a) for a in arrs)))
    before = kernels.launch_counts()
    t = [torch.from_numpy(a) for a in arrs]
    got = PD.poa_local(*t)
    assert kernels.launch_counts() == before  # CPU tensors: the plain twin, no kernel
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype),
                                      err_msg=name)
    *four, n_backing = PD.poa_local_cluster(*t)
    for g, w in zip(four, got):
        assert torch.equal(g, w)
    _vc, vpred, nv, _q, _nq = arrs
    np.testing.assert_array_equal(n_backing.numpy(), [
        max(0, len({int(p) for v in range(int(nv[b])) for p in vpred[b, v]
                    if 0 <= p < v - PD.LOCAL_RING}) - PD.LOCAL_PINS) for b in range(len(nv))])
    assert (n_backing.numpy()[:6] > 0).any() and (n_backing.numpy()[6:] == 0).all()
    assert nv[2] == 4 and nv[3] == 0 and got[2].numpy().max() >= 4


def test_each_width_takes_its_kernel():
    calls = []
    real = PD.poa_local_warp, PD.poa_local_cluster

    def spy(name, fn):
        return lambda *a: calls.append(name) or fn(*a)

    PD.poa_local_warp, PD.poa_local_cluster = (spy(n, f) for n, f in zip(("K7", "K9"), real))
    before = kernels.launch_counts()
    try:
        for W in (128, 384, 512, 1024, 2048, 4096, 8192, 16384):
            t = [torch.from_numpy(a) for a in random_local_batch(W, 2, 24, 2, W - 1)]
            best, tape, tlen, qend = PD.poa_local(*t)
            assert tape.shape == (2, W) and (tlen[1:] > 0).all()
    finally:
        PD.poa_local_warp, PD.poa_local_cluster = real
    assert calls == ["K7", "K9", "K9", "K9", "K9", "K9", "K9", "K9"]  # 384 padded to 512
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("L", [300, 9000])
def test_off_ladder_rows_run_padded(L):
    """A local row of L + 1 columns off the ladder runs padded to 512 or
    16,384 with code 4: the padded twin's best, tape over the first L + 1
    columns, tlen and qend equal the unpadded twin's and JAX's."""
    arrs = with_local_edge_cases(random_local_batch(500 + L, 6, 128, 4, L, far_frac=0.3))
    t = [torch.from_numpy(a) for a in arrs]
    W = L + 1
    assert PD.local_route(W) == ("poa_local_cluster", 512 if L == 300 else 16384)
    q_w = PD.pad_row(t[3], None, PD.local_route(W)[1])[0]
    padded = PD.poa_local_plain(t[0], t[1], t[2], q_w, t[4])
    want = PD.poa_local_plain(*t)
    jax_want = jax.device_get(JPD.poa_local_kernel(*(jnp.asarray(a) for a in arrs)))
    got = PD.poa_local(*t)
    assert padded[1].shape[1] == PD.local_route(W)[1] and got[1].shape == want[1].shape
    for name, p, g, w, j in zip(NAMES, padded, got, want, jax_want):
        if name == "tape":
            p = p[:, :W]
        assert torch.equal(p, w) and torch.equal(g, w), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(j).astype(g.numpy().dtype),
                                      err_msg=name)
    assert (want[2].numpy()[1:3] > 0).all()


def test_largest_h_on_the_device_route():
    """The largest cell a device-route problem can hold: a chain of 8,192
    vertices (the route's vertex cap) and a query of the same 8,192 bases
    in a row of 16,384 columns, one run of 8,192 matches, H = 16,384 =
    2 min(nv, nq), half of K9's int16 range; the walk is the whole
    chain."""
    rng = np.random.default_rng(6)
    V, L = 8192, 16383
    seq = rng.integers(0, 4, V).astype(np.int8)
    vpred = np.full((1, V, 2), -1, dtype=np.int32)
    vpred[0, 1:, 0] = np.arange(V - 1)
    q = np.full((1, L), 4, dtype=np.int8)
    q[0, :V] = seq
    t = [torch.from_numpy(a) for a in (seq[None], vpred, np.array([V], np.int32), q,
                                        np.array([V], np.int32))]
    best, tape, tlen, qend = PD.poa_local(*t)
    assert float(best[0]) == 2 * V == 16384 <= np.iinfo(np.int16).max
    assert int(tlen[0]) == V and int(qend[0]) == V
    _ops, vids = PD.unpack_tape(tape[0, :V].numpy())
    np.testing.assert_array_equal(vids, np.arange(V - 1, -1, -1))


# ---------------------------------------------------------------------------
# the column split in numpy

RING, SLOTS, PINS = PD.LOCAL_RING, 16, PD.LOCAL_PINS


def _split_model(arrs, n_slices, seen):
    """(best, tape, tlen, qend) of the DP with the row cut into
    ``n_slices`` column slices, each holding its own columns of a ring
    of SLOTS rows (read up to RING back), of PINS pinned rows and of the
    global backing rows, and a halo of the column left of its first that
    the slice before it pushes at each row.  ``seen`` counts the positive
    left-column values a slice read from a ring halo, a pinned halo and a
    backing row."""
    vcodes, vpred, nv, q, _nq = arrs
    B, V = vcodes.shape
    P, W = vpred.shape[2], q.shape[1] + 1
    wc = W // n_slices
    out = (np.zeros(B, np.float32), np.full((B, W), PD._END_FILL, np.int32),
           np.zeros(B, np.int32), np.zeros(B, np.int32))
    for b in range(B):
        n = int(nv[b])
        far = sorted({int(p) for v in range(n) for p in vpred[b, v] if 0 <= p < v - RING})
        pins, back = far[:PINS], {u: i for i, u in enumerate(far[PINS:])}
        ring = np.zeros((n_slices, SLOTS, wc), np.int64)
        pinned = np.zeros((n_slices, PINS, wc), np.int64)
        halo = np.zeros((n_slices, SLOTS + PINS), np.int64)
        backing = np.zeros((len(back), W), np.int64)
        cells = np.zeros((V, W), np.int64)
        qcode = np.concatenate([[-1], np.where(q[b] < 4, q[b], -1)])
        bests = [(0, 0, 0)] * n_slices
        for v in range(n):
            code = int(vcodes[b, v])
            rows = []
            for s in range(n_slices):
                j0 = s * wc
                mbest, mslot = np.zeros(wc, np.int64), np.full(wc, 15)
                for p in range(P):
                    pp = int(vpred[b, v, p])
                    if not 0 <= pp < v:
                        continue
                    if v - pp <= RING:
                        own, left, kind = ring[s, pp % SLOTS], halo[s, pp % SLOTS], "ring"
                    elif pp in pins:
                        k = pins.index(pp)
                        own, left, kind = pinned[s, k], halo[s, SLOTS + k], "pin"
                    else:
                        g = backing[back[pp]]
                        own, left, kind = g[j0 : j0 + wc], (g[j0 - 1] if j0 else 0), "backing"
                    left = left if s > 0 else 0
                    if left > 0:
                        seen[kind] += 1
                    cand = np.concatenate([[left], own[:-1]])
                    upd = cand > mbest
                    mbest, mslot = np.where(upd, cand, mbest), np.where(upd, p, mslot)
                sub = np.where(qcode[j0 : j0 + wc] == code, 2, -4)
                row = np.maximum(mbest + sub, 0)
                cells[v, j0 : j0 + wc] = mslot | ((row > 0) << 4)
                rows.append(row)
                if row.max() > bests[s][0]:
                    bests[s] = (int(row.max()), v, j0 + int(row.argmax()))
            for s, row in enumerate(rows):  # after the row's barrier
                ring[s, v % SLOTS] = row
                if v in pins:
                    pinned[s, pins.index(v)] = row
                if v in back:
                    backing[back[v], s * wc : (s + 1) * wc] = row
                if s + 1 < n_slices:
                    halo[s + 1, v % SLOTS] = row[-1]
                    if v in pins:
                        halo[s + 1, SLOTS + pins.index(v)] = row[-1]
        best, bv, bj = min(bests, key=lambda x: (-x[0], x[1], x[2]))
        v, j, steps = bv, bj, 0
        while steps < W and v >= 0 and j > 0 and cells[v, j] >> 4:
            out[1][b, steps] = PD.OP_M | ((v + 2) << 2)
            slot = cells[v, j] & 15
            v = -2 if slot == 15 else int(vpred[b, v, min(slot, P - 1)])
            j -= 1
            steps += 1
        out[0][b], out[2][b], out[3][b] = best, steps, bj
    return out


@pytest.mark.parametrize("n_slices", [1, 2, 4, 8])
def test_column_split_model_matches_plain(n_slices):
    seen = {"ring": 0, "pin": 0, "backing": 0}
    W = 128
    cases = [with_local_edge_cases(random_local_batch(95 + n_slices, 6, 64, 4, W - 1,
                                                      far_frac=0.3)),
             far_jump_local_batch(W, 64, 128)]
    for arrs in cases:
        got = _split_model(arrs, n_slices, seen)
        want = PD.poa_local_plain(*(torch.from_numpy(a) for a in arrs))
        for name, g, w in zip(NAMES, got, want):
            np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    # the far jump: its match run crosses column 64 over the far edge 92 <- 62
    ops, vids = PD.unpack_tape(want[1][0, : want[2][0]].numpy())
    at = list(vids).index(92)
    assert vids[at + 1] == 62 and int(want[2][0]) >= 90
    assert PD.backing_rows_plain(torch.from_numpy(arrs[1]), torch.from_numpy(arrs[2]),
                                 RING, PINS).tolist() == [1, 0]  # problem 0 on backing, 1 pinned
    if n_slices > 1:
        assert seen["ring"] > 0 and seen["pin"] > 0 and seen["backing"] > 0


# ---------------------------------------------------------------------------
# the launches under a byte budget (C1)


def _problem(rng, n_nodes, max_label, q_len):
    nodes = ["".join("ACGT"[c] for c in rng.integers(0, 4, int(rng.integers(1, max_label + 1))))
             for _ in range(n_nodes)]
    edges = [(b - 1, b) for b in range(1, n_nodes)]
    edges += [(int(a), b) for b in range(2, n_nodes) if rng.random() < 0.3
              for a in rng.choice(b - 1, size=1)]
    seq = "".join(nodes)
    start = int(rng.integers(0, max(1, len(seq) - q_len)))
    q = "".join(c if rng.random() > 0.05 else "ACGT"[int(rng.integers(0, 4))]
                for c in seq[start : start + q_len])
    return nodes, edges, q or "A"


def _problems():
    rng = np.random.default_rng(17)
    return ([_problem(rng, int(rng.integers(3, 20)), 5, int(rng.integers(20, 100)))
             for _ in range(11)]
            + [_problem(rng, 70, 6, 300) for _ in range(5)])  # V 256, W 512: the cluster route


def test_budget_cuts_buckets_into_launches_of_real_problems(monkeypatch):
    problems = _problems()
    whole = PD.align_local_batch(problems, CPU)
    launches = []
    real = PD.poa_local

    def record(*args, **kw):
        launches.append((args[0].shape[0], args[3].shape[1] + 1))
        return real(*args, **kw)

    monkeypatch.setattr(PD, "poa_local", record)
    monkeypatch.setattr(PD, "_LOCAL_BUDGET", 3 << 20)  # a few problems a launch
    chunked = PD.align_local_batch(problems, CPU)
    want = JPD.align_local_batch(problems)
    for c, w, j in zip(chunked, whole, want):
        assert dataclasses.astuple(c) == dataclasses.astuple(w) == dataclasses.astuple(j)
    assert sum(b for b, _w in launches) == len(problems)  # no padding copies
    assert len(launches) > len({w for _b, w in launches}) and max(b for b, _w in launches) > 1
    assert sum(g.n_aligned > 10 for g in chunked) >= 12


def test_local_chunks_follow_the_budget():
    rng = np.random.default_rng(3)
    bgs_qs = [_problem(rng, 60, 6, 300) for _ in range(9)]
    from vgaligner_tpu_torch.ops.poa import build_base_graph
    from vgaligner_tpu_torch.utils.dna import encode_seq

    bgs = [build_base_graph(n, e) for n, e, _q in bgs_qs]
    qs = [encode_seq(q) for _n, _e, q in bgs_qs]
    _s, _e, arrs, back = next(PD.local_chunks(bgs, qs, 256, 511))
    cost = PD.local_problem_bytes(256, 512, arrs[1].shape[-1], back)
    assert len(back) == 9 and (back > 0).any()  # a backing row costs its bytes

    def greedy(budget):
        sizes, used = [], None
        for c in cost:
            if used is None or used + c > budget:
                sizes.append(0)
                used = 0
            sizes[-1] += 1
            used += c
        return sizes

    for budget in (1, int(cost.max()), int(cost[:4].sum()), int(cost[:4].sum()) - 1,
                   int(cost.sum())):
        got = [(e - s, a[0].shape[0], len(bk)) for s, e, a, bk in
               PD.local_chunks(bgs, qs, 256, 511, budget)]
        assert [n for n, _b, _k in got] == greedy(budget)
        assert all(n == b == k for n, b, k in got)
    assert greedy(int(cost.sum())) == [9] and greedy(1) == [1] * 9


def test_default_budget_takes_the_long_read_bucket_whole():
    """The long reads' largest rspoa bucket (64 problems of V 2,048 x W
    2,048, no backing row) fits one launch, as do 8,192 main-path
    problems (V 256 x W 128) and the W 16,384 route's widest bucket
    by some problems (its cell plane, 128 MiB a problem, and no H plane
    on the cluster route)."""
    per = PD.local_problem_bytes(2048, 2048, 2, np.zeros(64))
    assert per.sum() < PD._LOCAL_BUDGET and per[0] < 5 << 20
    assert PD.local_problem_bytes(256, 128, 2, np.zeros(8192)).sum() < PD._LOCAL_BUDGET
    wide = PD.local_problem_bytes(8192, 16384, 2, np.zeros(1))[0]
    assert 128 << 20 < wide < 129 << 20 and PD._LOCAL_BUDGET // wide >= 8
    back = PD.local_problem_bytes(2048, 2048, 2, np.array([0, 10]))
    assert back[1] - back[0] == 10 * 2048 * 2


@pytest.mark.parametrize("V,W,P,w", [(256, 512, 2, 512), (2048, 2048, 4, 2048),
                                     (128, 384, 8, 512)])
def test_cluster_route_problem_bytes_match_a_hand_count(V, W, P, w):
    """Inputs (with the backing offset), cells, tape, scalars and the
    counted int16 backing rows at the route's width w (384 runs at 512,
    its query padded): the same count as the warp route's."""
    assert PD.local_route(W) == ("poa_local_cluster", w)
    back = np.array([0, 3, 25])
    inputs = V + 4 * V * P + (W - 1) + 4 + 4 + 4  # codes, preds, q, nv, nq, offset
    padded_q = (w - 1) if w != W else 0
    want = [inputs + V * w + 4 * w + 4 * 4 + padded_q + 2 * w * r for r in back]
    assert PD.local_problem_bytes(V, W, P, back).tolist() == want


def test_drain_refuses_a_problem_short_of_backing_rows(monkeypatch):
    """The cluster kernel marks a problem it could not give every backing
    row it needs with tlen -1; ``align_local_batch`` raises on it rather
    than decode a wrong alignment."""
    real = PD.poa_local

    def short(*args, **kw):
        best, tape, tlen, qend = real(*args, **kw)
        return best, tape, torch.where(torch.arange(len(tlen)) == 0, -1, tlen), qend

    monkeypatch.setattr(PD, "poa_local", short)
    with pytest.raises(RuntimeError, match="backing rows"):
        PD.align_local_batch(_problems()[:3], CPU)


def test_kernel_source_sizes_match_the_wrapper():
    src = os.path.join(os.path.dirname(kernels.__file__), "csrc", "poa_local_cluster.cu")
    with open(src) as fh:
        text = fh.read()
    sizes = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (RING|SLOTS|PINS|C|SLICE|MAX_CTAS) = (\d+);", text)}
    assert sizes["RING"] == PD.LOCAL_RING and sizes["PINS"] == PD.LOCAL_PINS
    assert sizes["SLOTS"] == SLOTS >= 2 * sizes["RING"]
    assert "constexpr int MAX_THREADS = SLICE / C;" in text
    # the widths the source's cta_cols takes: min(SLICE, W) columns a CTA,
    # a power of two of CTAs up to MAX_CTAS
    assert PD.CLUSTER_WIDTHS[-1] == sizes["SLICE"] * sizes["MAX_CTAS"] == 16384
    assert all(W // min(W, sizes["SLICE"]) in (1, 2, 4, 8) for W in PD.CLUSTER_WIDTHS)
    assert sizes["SLICE"] == 2048 and min(PD.CLUSTER_WIDTHS) % (32 * sizes["C"]) == 0
    assert "poa_local_cluster.cu" in kernels.SOURCES and "poa_local_cluster" in kernels.LAUNCHES


def test_probe_edits_the_columns_a_cta():
    """``kernel_probe``'s copies of the source differ only in SLICE, and
    its entry point refuses to run without a card."""
    from vgaligner_tpu_torch import kernel_probe

    src = os.path.join(os.path.dirname(kernels.__file__), "csrc", "poa_local_cluster.cu")
    with open(src) as fh:
        text = fh.read()
    var = kernel_probe.slice_sources(text)
    assert var["slice2048"] == text and set(var) == {"slice2048", "slice1024", "slice512"}
    for cols in (1024, 512):
        edited = var[f"slice{cols}"]
        assert f"constexpr int SLICE = {cols};" in edited
        assert edited.replace(f"SLICE = {cols};", "SLICE = 2048;") == text
    with pytest.raises(ValueError):
        kernel_probe.slice_sources(text.replace("SLICE = 2048", "SLICE = 64"))
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            kernel_probe.main(["--old-chain-dp", src])
