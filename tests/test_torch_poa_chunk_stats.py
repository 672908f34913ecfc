"""The POA chunk census (``poa_chunk_stats``) on the CPU: its counts
against counts made by hand, and an end-to-end run at a small size."""

import json

import numpy as np
import pytest

from vgaligner_tpu_torch import poa_chunk_stats
from vgaligner_tpu_torch.ops import poa_device as PD
from vgaligner_tpu_torch.testing import one_torch_thread, random_poa_batch

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


def _far_by_hand(vpred, nv, ring):
    return [len({int(p) for v in range(int(nv[b])) for p in vpred[b, v] if 0 <= p < v - ring})
            for b in range(len(nv))]


@pytest.mark.parametrize("far_frac", [0.0, 0.05, 0.3])
def test_chunk_stats_counts_match_hand_counts(far_frac):
    _vc, vpred, _sink, nv, _q, _nq = random_poa_batch(5, 10, 128, 4, 63, far_frac=far_frac)
    st = poa_chunk_stats.chunk_stats(vpred, nv, 8)
    far8, far16 = _far_by_hand(vpred[:8], nv[:8], 8), _far_by_hand(vpred[:8], nv[:8], 16)
    assert st["problems"] == 8 and st["V"] == 128 and st["P"] == 4
    assert st["nv_sum"] == int(nv[:8].sum()) and st["nv_max"] == int(nv[:8].max())
    assert st["topological"]
    assert st["far8_max"] == max(far8) and st["far8_sum"] == sum(far8)
    assert st["far16_max"] == max(far16)
    assert st["backing_problems"] == sum(f > PD.TB_PINS for f in far8)


def test_chunk_stats_sees_a_predecessor_past_its_vertex():
    _vc, vpred, _sink, nv, _q, _nq = random_poa_batch(6, 4, 64, 2, 31)
    vpred[1, 3, 0] = 3
    assert not poa_chunk_stats.chunk_stats(vpred, nv, 4)["topological"]


def test_census_of_the_main_path_at_a_small_size(tmp_path):
    path = tmp_path / "stats.json"
    out = poa_chunk_stats.main(["--reads", "96", "--backbone", "900", "--json", str(path)])
    assert json.loads(path.read_text()) == json.loads(json.dumps(out))
    assert out["problems"] == sum(c["problems"] for c in out["chunks"]) >= 90
    assert out["topological"] and 0 < out["nv_mean"] <= max(c["V"] for c in out["chunks"])
    assert all(c["W"] == 128 and c["B"] >= c["problems"] for c in out["chunks"])
    assert out["backing_problems"] <= out["problems"]
    assert np.isfinite(out["nv_mean"])
