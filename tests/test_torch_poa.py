"""Port vs JAX package: the POA DP and traceback plain twins, and the
fused route ``poa_dp_tb`` (its CPU path).

The JAX side is ``poa_dp_xla`` and ``traceback_batch`` on the CPU (the
XLA twins tests/test_poa_pallas2.py holds the Pallas DP to).  Compared
with tolerance 0: score, best_sink, tbits over rows v < nv, and
tape[:tlen] and tlen.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vgaligner_tpu.ops import poa_device as JPD
from vgaligner_tpu.ops.poa import build_base_graph
from vgaligner_tpu.utils.dna import encode_seq

from vgaligner_tpu_torch.ops import poa_device as PD
from vgaligner_tpu_torch.testing import one_torch_thread, random_poa_batch

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


def _random_dag(rng, n_nodes):
    nodes = ["".join("ACGT"[c] for c in rng.integers(0, 4, int(rng.integers(1, 6))))
             for _ in range(n_nodes)]
    edges = []
    for b in range(1, n_nodes):
        for a in rng.choice(b, size=min(b, int(rng.integers(1, 3))), replace=False):
            edges.append((int(a), b))
    return nodes, edges


def _graph_batch(seed, B, v_pad, l_pad):
    """Base graphs built by the JAX package's own problem builder."""
    rng = np.random.default_rng(seed)
    probs = []
    for i in range(B):
        nodes, edges = _random_dag(rng, int(rng.integers(2, 12)))
        seq = "".join(nodes)
        q = "".join(c if rng.random() > 0.1 else "ACGTN"[int(rng.integers(0, 5))]
                    for c in seq[: int(rng.integers(1, min(len(seq), l_pad) + 1))])
        probs.append(JPD.prepare_problem(build_base_graph(nodes, edges), encode_seq(q),
                                         v_pad, l_pad))
    vpred = JPD._slice_preds(np.stack([p.vpred for p in probs]), B)
    return (np.stack([p.vcodes for p in probs]), vpred.astype(np.int32),
            np.stack([p.is_sink for p in probs]).astype(np.uint8),
            np.asarray([p.nv for p in probs], np.int32), np.stack([p.q for p in probs]),
            np.asarray([p.nq for p in probs], np.int32))


def _jax_dp_traceback(arrs, l_pad):
    vcodes, vpred, is_sink, nv, q, nq = arrs
    init_row = PD.make_init_row(l_pad)
    np.testing.assert_array_equal(init_row, JPD.make_init_row(l_pad))
    js, jk, jtb = jax.device_get(JPD.poa_dp_xla(
        jnp.asarray(vcodes), jnp.asarray(vpred), jnp.asarray(is_sink != 0),
        jnp.asarray(nv), jnp.asarray(q), jnp.asarray(nq), jnp.asarray(init_row)))
    jtape, jtl = jax.device_get(JPD.traceback_batch(
        jnp.asarray(jtb), jnp.asarray(vpred), jnp.asarray(jk), jnp.asarray(nq)))
    return init_row, (js, jk, jtb, jtape, jtl)


def _compare(arrs, l_pad, fused=False):
    vcodes, vpred, is_sink, nv, q, nq = arrs
    init_row, (js, jk, jtb, jtape, jtl) = _jax_dp_traceback(arrs, l_pad)

    t = [torch.from_numpy(a) for a in arrs]
    if fused:
        s, k, tb, tape, tl, _nb = PD.poa_dp_tb(*t, torch.from_numpy(init_row))
    else:
        s, k, tb = PD.poa_dp(*t, torch.from_numpy(init_row))
        tape, tl = PD.poa_traceback(tb, t[1], k, t[5])
    np.testing.assert_array_equal(s.numpy(), js)
    np.testing.assert_array_equal(k.numpy(), jk)
    for b in range(len(nv)):
        np.testing.assert_array_equal(tb[b, : nv[b]].numpy(), jtb[b, : nv[b]])
    np.testing.assert_array_equal(tl.numpy(), jtl)
    assert tape.shape == jtape.shape
    for b in range(len(nv)):
        np.testing.assert_array_equal(tape[b, : tl[b]].numpy(),
                                      jtape[b, : jtl[b]].astype(np.int32))
    ops, vids = PD.unpack_tape(tape.numpy())
    jops, jvids = JPD.unpack_tape(jtape)
    np.testing.assert_array_equal(ops, jops)
    np.testing.assert_array_equal(vids, jvids)
    return s, tl


@pytest.mark.parametrize("seed", range(3))
def test_graph_batches_match_jax(seed):
    s, tl = _compare(_graph_batch(seed, 12, 64, 127), 127)
    assert (tl.numpy() > 0).all()


@pytest.mark.parametrize("P,W", [(2, 128), (4, 128), (8, 256)])
def test_random_dag_batches_match_jax(P, W):
    """Pred-less vertices, several sinks, N codes, far predecessors."""
    arrs = random_poa_batch(10 + P, 8, 256 if W == 128 else 64, P, W - 1)
    vpred, is_sink = arrs[1], arrs[2]
    assert ((vpred[:, 1:, 0] < 0) & (np.arange(1, vpred.shape[1]) < arrs[3][:, None])).any()
    assert (is_sink.sum(axis=1) > 1).all()
    assert (arrs[0] == 4).any() and (arrs[4] == 4).any()
    _compare(arrs, W - 1)


def _backing_rows_by_hand(vpred, nv):
    out = []
    for b in range(len(nv)):
        far = {int(p) for v in range(int(nv[b])) for p in vpred[b, v]
               if 0 <= p < v - PD.TB_RING}
        out.append(max(0, len(far) - PD.TB_PINS))
    return np.asarray(out, np.int32)


@pytest.mark.parametrize("P", [2, 4, 8])
@pytest.mark.parametrize("W", [32, 128, 256])
def test_fused_route_matches_jax(P, W):
    """The fused DP + traceback route (its CPU path) against the JAX DP and
    traceback_batch: nv < V, predecessors farther back than the kernel's
    row ring, and problems with more far-referenced vertices than it pins
    (its backing-store path), beside problems within the ring."""
    V = 96 if W == 32 else 64
    arrs = random_poa_batch(40 + P + W, 6, V, P, W - 1, far_frac=0.4)
    near = random_poa_batch(41 + P + W, 3, V, P, W - 1, far_frac=0.0)
    arrs = tuple(np.concatenate([a, n]) for a, n in zip(arrs, near))
    nv, vpred = arrs[3], arrs[1]
    assert (nv < V).any()
    want_nb = _backing_rows_by_hand(vpred, nv)
    assert (want_nb[:6] > 0).any() and (want_nb[6:] == 0).all()
    _compare(arrs, W - 1, fused=True)
    t = [torch.from_numpy(a) for a in arrs]
    nb = PD.poa_dp_tb(*t, torch.from_numpy(PD.make_init_row(W - 1)))[5]
    np.testing.assert_array_equal(nb.numpy(), want_nb)


def test_fused_route_takes_rows_up_to_256():
    assert PD.TB_WIDTHS == (32, 64, 128, 256)
    calls = []
    real_tb, real_dp = PD.poa_dp_tb, PD.poa_dp

    def spy(name, fn):
        return lambda *a: calls.append(name) or fn(*a)

    PD.poa_dp_tb, PD.poa_dp = spy("tb", real_tb), spy("dp", real_dp)
    try:
        for W in (128, 256, 512):
            arrs = [torch.from_numpy(a) for a in random_poa_batch(W, 2, 32, 2, W - 1)]
            PD.dp_and_traceback(*arrs, torch.from_numpy(PD.make_init_row(W - 1)))
    finally:
        PD.poa_dp_tb, PD.poa_dp = real_tb, real_dp
    assert calls == ["tb", "tb", "dp"]


def test_slice_preds_matches_jax():
    rng = np.random.default_rng(0)
    for fan in (1, 2, 3, 5, 8):
        vpred = np.full((4, 16, 8), -1, np.int32)
        vpred[:3, 5, :fan] = rng.integers(0, 5, fan)
        vpred[3] = 0  # a zeroed padding row must not widen the slice
        np.testing.assert_array_equal(PD._slice_preds(vpred, 3),
                                      JPD._slice_preds(vpred, 3))


def test_ladders_match_jax():
    for n in (1, 7, 8, 9, 100, 1024, 3000):
        assert PD._b_pad_for(n) == JPD._b_pad_for(n)
        for v_pad, l_pad in ((256, 127), (2048, 127), (8192, 1023)):
            assert PD.padded_rows(n, v_pad, l_pad) == JPD.padded_rows(n, v_pad, l_pad)
            assert PD._b_chunk_for(v_pad, l_pad) == JPD._b_chunk_for(v_pad, l_pad)
    for n in (1, 100, 127, 128, 600):
        assert PD._l_pad_for(n) == JPD._l_pad_for(n)
