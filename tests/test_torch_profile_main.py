"""The port's profiling script runs end to end at a small size on the CPU."""

import json

import pytest

from vgaligner_tpu_torch import profile_main
from vgaligner_tpu_torch.testing import one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


def test_profile_main_reports_every_figure(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "profile.json"
    out = profile_main.main(["--device", "cpu", "--reads", "48", "--backbone", "500",
                             "--json", str(path)])
    assert json.loads(path.read_text()) == json.loads(json.dumps(out))
    for name in ("stream_export", "stream_no_export"):
        secs, rates = out[name]["seconds"], out[name]["reads_per_s"]
        assert len(secs) == profile_main.REPS and min(secs) > 0
        assert rates == [48 / s for s in secs]
    assert len(out["cprofile_top"]) == profile_main.TOP
    assert {"count", "encode", "device_map", "backtrack", "coords"} <= set(out["mapper_phases"])
    assert out["unpipelined_no_export_seconds"] > 0
    assert out["device_busy_share"] is None  # device time is measured on CUDA only
    assert list(tmp_path.iterdir()) == [path]  # the per-chain GFAs stay in its temp dir
