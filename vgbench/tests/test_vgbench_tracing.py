"""The program's spans in the benchmark: the innermost attribution of
idle time (``innermost.py``) and the readers of the program's spans and
counters on a CPU rehearsal of each cell."""

import json

import pytest

from helpers import small_cell

NEW = {"drb1-abpoa.short100": {"aligner.extract_ms_per_kread",
                               "aligner.export_paths_ms_per_kread",
                               "aligner.export_write_ms_per_kread",
                               "aligner.launch_ms_per_kread",
                               "aligner.host_problems_per_kread",
                               "aligner.device_problems_per_kread",
                               "aligner.export_files_per_kread"},
       "drb1-abpoa.maponly100": set()}
BOTH = {"mapper.device_wait_ms_per_kread", "writer.fsync_ms_per_kread",
        "stream.join_ms_per_kread", "writer.bytes_per_kread"}


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def _kernel(ts, dur):
    return {"ph": "X", "cat": "kernel", "name": "void chain_dp_kernel(int)", "ts": ts,
            "dur": dur, "tid": 7}


def _write(tmp_path, events):
    path = str(tmp_path / "trace.json")
    with open(path, "w") as fh:
        json.dump({"traceEvents": events}, fh)
    return path


def _window(events, lo=1000.0, dur=1000.0):
    return [_span("vgbench.window", lo, dur)] + events


def _idle(kernels, lo, hi):
    """The window's idle stretches between the kernels, as reduce_trace
    finds them."""
    from vgbench.trace import _union

    idle, prev = [], lo
    for a, b in _union([(max(k["ts"], lo), min(k["ts"] + k["dur"], hi)) for k in kernels]):
        if a > prev:
            idle.append((prev, a))
        prev = max(prev, b)
    if hi > prev:
        idle.append((prev, hi))
    return idle


def _credit(idle, spans, lo, hi):
    """Idle seconds by the innermost span open, ``stream.wait`` where none
    is: reduce_trace's idle loop with ``innermost_segments`` in it."""
    from vgbench.innermost import innermost_segments

    by = {}
    for sa, sb, name in innermost_segments(
            [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in spans], lo, hi):
        for a, b in idle:
            ca, cb = max(a, sa), min(b, sb)
            if cb > ca:
                key = name or "stream.wait"
                by[key] = by.get(key, 0.0) + (cb - ca) * 1e-6
    return by


def test_innermost_segments_label_the_innermost_span():
    from vgbench.innermost import innermost_segments

    spans = [_span("aligner.begin", 1100.0, 500.0), _span("aligner.extract", 1100.0, 100.0),
             _span("aligner.export", 1250.0, 300.0), _span("writer", 1700.0, 400.0)]
    got = innermost_segments([(e["ts"], e["ts"] + e["dur"], e["name"]) for e in spans],
                             1000.0, 2000.0)
    assert got == [(1000.0, 1100.0, None), (1100.0, 1200.0, "aligner.extract"),
                   (1200.0, 1250.0, "aligner.begin"), (1250.0, 1550.0, "aligner.export"),
                   (1550.0, 1600.0, "aligner.begin"), (1600.0, 1700.0, None),
                   (1700.0, 2000.0, "writer")]


def test_innermost_credits_the_innermost_span():
    spans = [
        _span("aligner.begin", 1100.0, 500.0),
        _span("aligner.extract", 1100.0, 100.0),
        _span("aligner.export", 1250.0, 300.0),
        _span("aligner.launch", 1560.0, 30.0),
        _span("writer", 1700.0, 100.0),
        _span("writer.fsync", 1750.0, 40.0),
    ]
    kernels = [_kernel(1300.0, 50.0), _kernel(1580.0, 30.0)]
    got = _credit(_idle(kernels, 1000.0, 2000.0), spans, 1000.0, 2000.0)
    # idle: 1000-1300, 1350-1580, 1610-2000 (microseconds)
    want = {"aligner.extract": 100.0, "aligner.begin": 50.0 + 10.0,
            "aligner.export": 50.0 + 200.0, "aligner.launch": 20.0, "writer": 50.0 + 10.0,
            "writer.fsync": 40.0, "stream.wait": 100.0 + 90.0 + 200.0}
    assert set(got) == set(want)
    for name, us in want.items():
        assert got[name] == pytest.approx(us * 1e-6, abs=1e-12), name
    idle = 1000.0 - 50.0 - 30.0
    assert sum(got.values()) == pytest.approx(idle * 1e-6, rel=1e-12)


def test_innermost_sums_to_the_idle_time_on_deep_nesting(tmp_path):
    from vgbench.trace import reduce_trace

    spans = [_span(f"level{d}", 1000.0 + 10 * d, 900.0 - 20 * d) for d in range(20)]
    kernels = [_kernel(1000.0 + 37 * i, 11.0) for i in range(27)]
    got = _credit(_idle(kernels, 1000.0, 2000.0), spans, 1000.0, 2000.0)
    r = reduce_trace(_write(tmp_path, _window(spans + kernels)))
    assert sum(got.values()) == pytest.approx(r["window_s"] - r["busy_s"], rel=1e-9)
    # the old rule counts each nested level's share again
    assert sum(s for _, s in r["idle_by_host"]) > 2 * sum(got.values())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_innermost_equals_reduce_trace_without_nesting(tmp_path, seed):
    """The harness's own spans never nest: the same labels."""
    import random

    from vgbench.trace import reduce_trace

    rng = random.Random(seed)
    spans, t = [], 900.0
    names = ["mapper", "aligner.begin", "writer"]
    while t < 2100.0:
        dur = rng.uniform(1.0, 40.0)
        spans.append(_span(rng.choice(names), t, dur))
        t += dur + rng.choice([0.0, rng.uniform(0.0, 15.0)])
    kernels = [_kernel(rng.uniform(950.0, 2050.0), rng.uniform(0.5, 9.0)) for _ in range(80)]
    got = _credit(_idle(kernels, 1000.0, 2000.0), spans, 1000.0, 2000.0)
    want = dict(reduce_trace(_write(tmp_path, _window(spans + kernels)))["idle_by_host"])
    assert set(got) == set(want)
    for name, s in want.items():
        assert got[name] == pytest.approx(s, rel=1e-9, abs=1e-15), name


@pytest.fixture
def few_threads():
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("workload", sorted(NEW))
def test_rehearsal_reads_every_new_metric(workload, few_threads):
    """A traced CPU run of the cell: each new metric listed for it reads
    a number, and the abPOA route's spans account for ``aligner.begin``."""
    from vgaligner_tpu_torch.models import stream
    from vgbench import manifest, run

    cell = small_cell(workload)
    cell["per_layer"] = manifest.cell(workload)["per_layer"]
    listed = {m["name"] for m in cell["per_layer"]}
    assert NEW[workload] | BOTH <= listed
    out = run.execute(cell, 2 ** 31 + 5, 0.5, True, device="cpu", batch=64)
    assert out["correct"]
    metrics = {k: v["value"] for k, v in out["metrics"].items()}
    for name in NEW[workload] | BOTH:
        assert name in metrics and metrics[name] >= 0, name
    assert {"writer.ms_per_kread", "stream.wait_ms_per_kread", "mapper.ms_per_kread"} <= \
        set(metrics)
    assert metrics["writer.bytes_per_kread"] > 0
    if workload == "drb1-abpoa.short100":
        assert metrics["aligner.host_problems_per_kread"] == 0.0
        assert stream.LAST_RUN["counters"]["aligner.host_problems"] == 0
        # a file and a problem for every chain aligned
        assert metrics["aligner.device_problems_per_kread"] > 0
        assert metrics["aligner.export_files_per_kread"] == pytest.approx(
            metrics["aligner.device_problems_per_kread"])
        covered = sum(metrics[m] for m in ("aligner.extract_ms_per_kread",
                                           "aligner.export_paths_ms_per_kread",
                                           "aligner.export_write_ms_per_kread",
                                           "aligner.launch_ms_per_kread"))
        assert 0.95 * metrics["aligner.begin_ms_per_kread"] <= covered
        assert covered <= metrics["aligner.begin_ms_per_kread"]
