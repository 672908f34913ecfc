"""Port vs JAX package: global POA under the contract of the VMEM-resident
Pallas DP (``vgaligner_tpu/ops/poa_pallas.py``), tolerance 0.

The JAX side is ``poa_global_kernel(..., use_pallas=True)``; on the CPU
its Pallas kernel runs in interpret mode, as tests/test_poa_pallas.py
runs it.  The port's ``poa_global_kernel`` pads the row to the same
128-multiple width and runs its one POA DP (K2's twin on the CPU).
Where JAX's own VMEM budget sends a shape to the XLA scan, its tape is
the unpadded width's, and the tapes are compared up to tlen.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vgaligner_tpu.ops import poa_device as JPD

from vgaligner_tpu_torch.ops import poa_device as PD
from vgaligner_tpu_torch.testing import one_torch_thread, random_poa_batch

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


def _both(arrs, L):
    vcodes, vpred, is_sink, nv, q, nq = arrs
    init_row = PD.make_init_row(L)
    want = jax.device_get(JPD.poa_global_kernel(
        jnp.asarray(vcodes), jnp.asarray(vpred), jnp.asarray(is_sink != 0), jnp.asarray(nv),
        jnp.asarray(q), jnp.asarray(nq), jnp.asarray(init_row), use_pallas=True))
    t = torch.from_numpy
    got = PD.poa_global_kernel(*(t(a) for a in arrs), t(init_row))
    return [g.numpy() for g in got], want


@pytest.mark.parametrize("L", [100, 200, 300])
def test_p3_contract_matches_jax_pallas(L):
    arrs = random_poa_batch(300 + L, 6, 64, 2 if L != 200 else 4, L)
    (score, tape, tlen), (js, jtape, jtl) = _both(arrs, L)
    l_w = ((L + 1 + 127) // 128) * 128
    assert tape.shape == jtape.shape == (6, 64 + l_w + 1)  # JAX took the Pallas route
    np.testing.assert_array_equal(score, js)
    np.testing.assert_array_equal(tlen, jtl)
    np.testing.assert_array_equal(tape, jtape.astype(np.int32))
    assert (tlen > 0).all()


def test_p3_contract_where_jax_falls_back_to_xla():
    """(5V + 24) * l_w * 4 bytes over 14 MiB: JAX runs the XLA scan at
    W = L + 1, the port still the l_w-wide DP; same score, tlen and
    tape[:tlen]."""
    L, V = 400, 2048
    arrs = random_poa_batch(7, 2, V, 2, L)
    (score, tape, tlen), (js, jtape, jtl) = _both(arrs, L)
    assert jtape.shape == (2, V + L + 2) and tape.shape == (2, V + 512 + 1)
    np.testing.assert_array_equal(score, js)
    np.testing.assert_array_equal(tlen, jtl)
    for b in range(2):
        np.testing.assert_array_equal(tape[b, : tlen[b]], jtape[b, : jtl[b]].astype(np.int32))
