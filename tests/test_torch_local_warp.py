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
  * the kernel source's ring and pin sizes are the ones the plan uses.
"""

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
from vgaligner_tpu_torch.testing import one_torch_thread, random_local_batch, with_local_edge_cases

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)
NAMES = ("best", "tape", "tlen", "qend")


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
