"""Port vs JAX package: the chaining DP (fast and exact) and the gap cost.

The JAX side runs ``chain_scores`` on the CPU, where fast mode takes the
XLA scan that tests/test_chain_pallas.py holds the Pallas kernel to.
Tolerance 0: every compared value is an integer or an exact f64.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vgaligner_tpu.ops import chain as jax_chain

from vgaligner_tpu_torch.ops import chain as C
from vgaligner_tpu_torch.testing import one_torch_thread

K = 11
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


def _random_anchors(seed, B, A):
    rng = np.random.default_rng(seed)
    qb = rng.integers(0, 90, (B, A)).astype(np.int32)
    tb = rng.integers(0, 20000 if A <= 128 else 4 * A, (B, A)).astype(np.int64)
    valid = rng.random((B, A)) < 0.85
    return qb, tb, tb + K, valid


def _dense_diagonal(B, A):
    qb = np.tile(np.arange(A, dtype=np.int32) % 80, (B, 1))
    tb = np.tile(np.arange(A, dtype=np.int64) % 80, (B, 1)) + 100
    return qb, tb, tb + K, np.ones((B, A), bool)


CASES = {
    "random0": lambda: _random_anchors(0, 8, 64),
    "random1": lambda: _random_anchors(1, 8, 64),
    "random2": lambda: _random_anchors(2, 8, 64),
    "random_long": lambda: _random_anchors(3, 3, 600),
    "short_window": lambda: _random_anchors(4, 6, 24),
    "dense_diagonal": lambda: _dense_diagonal(4, 128),
}


def _both(case, precision, bandwidth=50):
    qb, tb, te, valid = CASES[case]()
    table = C.make_gap_cost_table(K, 1000)
    np.testing.assert_array_equal(table, jax_chain.make_gap_cost_table(K, 1000))
    want = jax_chain.chain_scores(
        jnp.asarray(qb), jnp.asarray(tb), jnp.asarray(te), jnp.asarray(valid),
        jnp.asarray(table), seed_length=K, bandwidth=bandwidth, precision=precision,
    )
    t = torch.from_numpy
    got = C.chain_scores(t(qb), t(tb), t(te), t(valid), table, seed_length=K,
                         bandwidth=bandwidth, precision=precision)
    return got, want


@pytest.mark.parametrize("case", sorted(CASES))
def test_fast_mode_matches_jax_scan(case):
    got, want = _both(case, "fast")
    for name in ("order", "qb", "tb", "te", "valid", "f", "pred", "curr_max"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got.pred.numpy() >= 0).any()


@pytest.mark.parametrize("case", ["random0", "random_long", "dense_diagonal"])
def test_exact_mode_matches_jax(case):
    got, want = _both(case, "exact")
    for name in ("order", "f", "pred", "curr_max"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_fast_mode_wide_bandwidth_matches_jax():
    got, want = _both("random_long", "fast", bandwidth=100)
    np.testing.assert_array_equal(got.f.numpy(), np.asarray(want.f))
    np.testing.assert_array_equal(got.pred.numpy(), np.asarray(want.pred))


def test_gap_cost_exhaustive_g_le_1000():
    g = np.arange(0, 1001, dtype=np.int32)
    got = C.gap_cost_scaled_i32(torch.from_numpy(g), K).numpy()
    with jax.enable_x64(False):
        want = np.asarray(jax.jit(lambda x: jax_chain.gap_cost_scaled_i32(x, K))(
            jnp.asarray(g)))
    np.testing.assert_array_equal(got, want)
    table = C.make_gap_cost_table(K, 1000)
    np.testing.assert_array_equal(got.astype(np.int64),
                                  np.floor(table * 1000.0 + 0.5).astype(np.int64))


def test_kernel_log2_coefficients_are_the_f32_roundings():
    """chain_dp.cu carries the polynomial as f32 bit patterns; they must
    be the roundings the JAX and plain versions use."""
    src = os.path.join(os.path.dirname(C.__file__), "..", "kernels", "csrc", "chain_dp.cu")
    with open(src) as fh:
        bits = re.findall(r"const float c(\d) = __uint_as_float\((0x[0-9a-f]{8})u\)", fh.read())
    assert [int(d) for d, _ in bits] == list(range(8))
    for d, hexbits in bits:
        want = np.float32(jax_chain._LOG2_COEF[int(d)]).view(np.uint32)
        assert int(hexbits, 16) == int(want)
    assert C._LOG2_COEF == jax_chain._LOG2_COEF
