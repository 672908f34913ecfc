"""``python -m vgaligner_tpu_torch.parallel.check`` on CPU ranks: the
multi-device check runs every leg through the CLI at -t 1, -t 2 and
-t 2 --shard-index and finds them byte-identical (about 40 s here)."""

import json

from vgaligner_tpu_torch.parallel import check


def test_check_finds_two_cpu_ranks_identical_to_one(capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rc = check.main(["--ranks", "2", "--device", "cpu", "--reads", "8", "--backbone", "300",
                     "--timeout", "240"])
    out = capsys.readouterr().out.splitlines()
    summary = json.loads(out[-1])
    assert rc == 0 and summary["ok"]
    assert [r["name"] for r in summary["runs"]] == [
        "abpoa-t1", "abpoa-t2", "abpoa-t2-shard", "rspoa-t1", "rspoa-t2", "rspoa-t2-shard"]
    assert all(r["identical_to_t1"] for r in summary["runs"])
    assert summary["runs"][0]["files"] > 2  # the abPOA leg's subgraph GFAs are compared too
