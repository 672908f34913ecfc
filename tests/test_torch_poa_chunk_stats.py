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
    # real problems only, each launch under the global route's budget
    assert all(c["W"] == 128 and c["B"] == c["problems"] for c in out["chunks"])
    assert all(0 < c["bytes"] <= PD._HBM_BUDGET for c in out["chunks"])
    assert out["backing_problems"] <= out["problems"]
    assert np.isfinite(out["nv_mean"])


def test_census_of_the_rspoa_path_at_a_small_size(tmp_path):
    """``--engine rspoa``: the local POA launches of ``map -p rspoa``, the
    real problems of each (V, L) bucket under the byte budget, no padding
    copies, each launch's device bytes counting its backing rows."""
    path = tmp_path / "rspoa.json"
    out = poa_chunk_stats.main(["--engine", "rspoa", "--reads", "96", "--backbone", "900",
                                "--json", str(path)])
    assert json.loads(path.read_text()) == json.loads(json.dumps(out))
    assert out["engine"] == "rspoa" and out["problems"] >= 90
    for c in out["chunks"]:
        assert c["W"] == 128 and c["V"] >= 256 and c["B"] == c["problems"]
        assert c["P"] in (2, 4, 8)
        assert c["bytes"] == int(PD.local_problem_bytes(c["V"], 128, c["P"], [0]).sum()
                                 * c["B"] + 2 * 128 * c["backing_rows_sum"])
        assert 0 < c["bytes"] <= PD._LOCAL_BUDGET
    assert out["topological"] and 0 < out["nv_mean"] <= max(c["V"] for c in out["chunks"])
    assert out["backing_problems"] <= out["problems"]


def test_census_of_the_long_reads_at_a_small_size(tmp_path):
    """``--long``: the first reads of chip_smoke.py's long reads, whose
    rows of 2,048 columns the cluster kernel takes; backing rows are
    counted at its ring of 8 and 4 pins."""
    path = tmp_path / "long.json"
    out = poa_chunk_stats.main(["--long", "--reads", "3", "--backbone", "3000",
                                "--json", str(path)])
    assert json.loads(path.read_text()) == json.loads(json.dumps(out))
    assert out["long"] and out["reads"] == 3 and out["problems"] >= 3
    for c in out["chunks"]:
        assert c["W"] in PD.CLUSTER_WIDTHS and c["V"] >= 2048 and c["B"] == c["problems"]
        assert 0 < c["bytes"] <= PD._HBM_BUDGET
        assert 1500 <= c["nv_sum"] / c["problems"] <= c["V"]
        assert c["backing_rows_max"] <= c["backing_rows_sum"]
    assert out["topological"]
    assert out["backing_rows"] == sum(c["backing_rows_sum"] for c in out["chunks"])


def test_chunk_stats_backing_follows_ring_and_pins():
    _vc, vpred, _sink, nv, _q, _nq = random_poa_batch(9, 8, 128, 4, 63, far_frac=0.3)
    far16 = _far_by_hand(vpred, nv, 16)
    st = poa_chunk_stats.chunk_stats(vpred, nv, 8, ring=16, pins=2)
    assert st["backing_problems"] == sum(f > 2 for f in far16)
    assert st["backing_rows_sum"] == sum(max(0, f - 2) for f in far16)
    assert st["backing_rows_max"] == max(max(0, f - 2) for f in far16)
