"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import json
import os
import re

from helpers import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_keys_names_and_units():
    b = bench()
    assert set(b) == TOP
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    for n in names:
        assert NAME.match(n), n
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in b[group]}) == len(b[group])
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        for k in c["reduced"]:
            assert NAME.match(k)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and "\n" not in w["why"]


def test_files_exist_under_paths():
    b = bench()
    assert b["paths"] == ["vgbench"]
    configs = {c["name"]: c for c in b["configs"]}
    used = set()
    for w in b["workloads"]:
        c = configs[w["config"]]
        used.add(c["name"])
        assert c["file"].startswith("vgbench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as fh:
            assert json.load(fh)["name"] == c["name"]
        assert os.path.exists(os.path.join(ROOT, "vgbench", "traffic", w["traffic"] + ".json"))
    assert used == set(configs)
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "vgbench", "metrics", m["name"] + ".py"))
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_metrics_move_what_their_cells_report():
    b = bench()
    cells = [w["name"] for w in b["workloads"]]
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in e2e[m["moves"]], (m["name"], w)
    for w in cells:
        assert sum(w in s for s in e2e.values()) >= 2
        assert any(w in m.get("workloads", cells) for m in b["per_layer"])


def test_four_card_cells_at_most_a_quarter():
    b = bench()
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert all(w["chips"] in (1, 4) for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)
