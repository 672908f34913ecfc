"""Shared fixtures of the benchmark's CPU tests."""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def small_cell(name: str, backbone_len: int = 600, **traffic) -> dict:
    """A cell (``<configuration>.<traffic>``, from their files) on a
    short graph, for runs on the CPU."""
    import json
    import tempfile

    from vgbench import traffic as traffic_mod

    config, mix = name.split(".")
    with open(os.path.join(ROOT, "vgbench", "configs", config + ".json")) as fh:
        cfg_file = json.load(fh)
    with open(os.path.join(ROOT, "vgbench", "traffic", mix + ".json")) as fh:
        mix_file = json.load(fh)
    e2e = [{"name": n, "unit": u} for n, u in
           (("reads_per_s", "reads/s"), ("peak_device_mib", "MiB"), ("setup_s", "s"))]
    cell = {"workload": {"name": name, "chips": cfg_file["chips"]}, "config": cfg_file,
            "traffic": mix_file, "end_to_end": e2e, "per_layer": []}
    cfg = dict(cell["config"])
    cfg["graph"] = dict(cfg["graph"], backbone_len=backbone_len)
    with tempfile.TemporaryDirectory() as d:
        cfg["graph_shape"] = traffic_mod.write_graph(os.path.join(d, "g.gfa"), **cfg["graph"])
    traffic = dict({"warmup_reads": 32}, **traffic)
    cell = dict(cell, config=cfg, traffic=dict(cell["traffic"], **traffic))
    return cell
