"""A later change adds a configuration, a traffic mix, a per-layer metric
and a cell with new files and entries only."""

import hashlib
import json
import os
import shutil

from helpers import ROOT


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "vgbench")):
        for f in files:
            if "__pycache__" in d:
                continue
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_cell_needs_only_new_files(tmp_path):
    from vgbench import harness, manifest

    shutil.copytree(os.path.join(ROOT, "vgbench"), tmp_path / "vgbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    before = _digests(str(tmp_path))

    with open(tmp_path / "vgbench/configs/drb1-abpoa.json") as fh:
        cfg = json.load(fh)
    cfg["name"] = "drb1-abpoa-best3"
    cfg["map_argv"] = cfg["map_argv"] + ["-b", "3"]
    (tmp_path / "vgbench/configs/drb1-abpoa-best3.json").write_text(json.dumps(cfg))
    with open(tmp_path / "vgbench/traffic/short100.json") as fh:
        tr = json.load(fh)
    tr["name"] = "short150"
    tr["read_len"] = 150
    (tmp_path / "vgbench/traffic/short150.json").write_text(json.dumps(tr))
    (tmp_path / "vgbench/metrics/writer.reads.py").write_text(
        "def read(record):\n    return record['reads']\n")
    with open(tmp_path / "BENCHMARK.json") as fh:
        b = json.load(fh)
    b["configs"].append({"name": "drb1-abpoa-best3", "source": "s",
                         "file": "vgbench/configs/drb1-abpoa-best3.json", "reduced": [],
                         "why": "w"})
    b["workloads"].append({"name": "drb1-abpoa-best3.short150", "config": "drb1-abpoa-best3",
                           "traffic": "short150", "chips": 1, "why": "w"})
    b["per_layer"].append({"name": "writer.reads", "unit": "reads", "better": "higher",
                           "source": "program_span", "layer": "CLI + writer", "moves":
                           "reads_per_s", "workloads": ["drb1-abpoa-best3.short150"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    after = _digests(str(tmp_path))
    changed = [p for p in before if after.get(p) != before[p]]
    assert changed == []
    cell = manifest.cell("drb1-abpoa-best3.short150", root=str(tmp_path))
    assert cell["traffic"]["read_len"] == 150
    args = harness.map_args(cell["config"], cell["traffic"], harness.paths(str(tmp_path)))
    assert args.align_best_n == 3 and args.also_align
    got = manifest.per_layer({"reads": 7}, cell["per_layer"][-1:],
                             root=str(tmp_path / "vgbench"))
    assert got == {"writer.reads": {"value": 7.0, "unit": "reads"}}
