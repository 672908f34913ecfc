"""BENCHMARK.json and the files it names, found by name.

A cell (``workloads`` entry) names a configuration, ``configs/<name>.json``,
and a traffic mix, ``traffic/<name>.json``; a per-layer metric is read by
``metrics/<name>.py``.  Adding any of them adds files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell(name: str, root: str = ROOT) -> dict:
    """The cell with its configuration, traffic and metric entries."""
    bench = load(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    here = os.path.join(root, os.path.basename(HERE))
    config = _json(os.path.join(root, cfg_entry["file"]))
    traffic = _json(os.path.join(here, "traffic", w["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    layers = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    return {"workload": w, "config": config, "traffic": traffic, "end_to_end": e2e,
            "per_layer": layers}


def reader(name: str, root: Optional[str] = None) -> Callable[[dict], Optional[float]]:
    """``read(record)`` of metrics/<name>.py."""
    path = os.path.join(root or HERE, "metrics", name + ".py")
    mod_name = "vgbench_metric_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer(record: dict, metrics: List[dict], root: Optional[str] = None) -> Dict[str, dict]:
    """Each metric a reader finds something for, in BENCHMARK.json's order."""
    out = {}
    for m in metrics:
        value = reader(m["name"], root)(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
