"""The port's spans and counters (``utils/timing.py``) and where the
program opens them.

  * ``Tracer``: nesting, two threads on one name, counters, ``add``,
    ``snapshot``/``since`` deltas; a ``record_function`` only while a
    profiler is active on the thread, and then the spans sit inside the
    profiler's window in its Chrome trace as user annotations;
  * the mapper's, the abPOA and rspoa routes', the writer's and the
    stream's spans and counters on a small CPU run, the host POA counted
    and its results unchanged, the export's paths counted as the native
    pass's and timed inside the export, and the abPOA route's spans
    covering ``begin_alignments``.
"""

import json
import os
import threading
import time

import pytest
import torch

from vgaligner_tpu_torch.graph import graph_from_gfa
from vgaligner_tpu_torch.index import Index
from vgaligner_tpu_torch.io.fastx import QuerySequence
from vgaligner_tpu_torch.io.resume import ResumableGafWriter
from vgaligner_tpu_torch.models import poa_aligner as PA
from vgaligner_tpu_torch.models import stream
from vgaligner_tpu_torch.models.mapper import Mapper
from vgaligner_tpu_torch.testing import one_torch_thread, sample_reads, write_synthetic_gfa
from vgaligner_tpu_torch.utils import timing
from vgaligner_tpu_torch.utils.timing import TRACER, Tracer, ready_event

CPU = torch.device("cpu")
_one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

MAPPER_SPANS = {"mapper.count", "mapper.encode", "mapper.launch", "mapper.device_wait",
                "mapper.gather", "mapper.backtrack", "mapper.coords", "mapper.emit"}
ABPOA_BEGIN = ("aligner.extract", "aligner.export", "aligner.build", "aligner.launch",
               "aligner.host_poa")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("tracing")
    gfa = str(root / "graph.gfa")
    write_synthetic_gfa(gfa, seed=5, backbone_len=900)
    graph = graph_from_gfa(gfa)
    index = Index.build(graph, 11, 100, 100)
    reads = sample_reads(graph, 40, 100, seed=9, sub_rate=0.01)
    queries = [QuerySequence(f"r{i}", s) for i, s in enumerate(reads)]
    mapper = Mapper(index, CPU, precision="exact")
    return dict(graph=graph, index=index, queries=queries, mapper=mapper,
                chains=mapper.map_reads(queries))


def _gaf(alns):
    return "".join(a.to_string() for a in alns)


def test_spans_nest_and_count():
    tr = Tracer()
    with tr.span("outer"):
        for _ in range(3):
            with tr.span("inner"):
                time.sleep(0.002)
    assert tr.counts == {"outer": 1, "inner": 3}
    assert tr.totals["inner"] >= 0.006
    assert tr.totals["outer"] >= tr.totals["inner"]


def test_span_records_when_the_block_raises():
    tr = Tracer()
    with pytest.raises(ValueError):
        with tr.span("failing"):
            raise ValueError("x")
    assert tr.counts["failing"] == 1


def test_two_threads_time_one_name():
    tr = Tracer()
    n = 500
    gate = threading.Barrier(2)

    def work():
        gate.wait()
        for _ in range(n):
            with tr.span("shared"):
                pass
            tr.count("shared.items")

    threads = [threading.Thread(target=work) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert tr.counts["shared"] == 2 * n
    assert tr.counters["shared.items"] == 2 * n
    assert tr.totals["shared"] > 0


def test_counters_and_add():
    tr = Tracer()
    tr.count("files")
    tr.count("files", 4)
    tr.count("none", 0)
    tr.add("loop.half", 0.25)
    tr.add("loop.half", 0.5)
    snap = tr.snapshot()
    assert snap == {"spans": {"loop.half": 0.75}, "counters": {"files": 5, "none": 0}}
    assert tr.counts["loop.half"] == 2


def test_snapshot_deltas():
    tr = Tracer()
    tr.add("a", 1.0)
    tr.count("c", 2)
    before = tr.snapshot()
    tr.add("a", 0.5)
    tr.add("b", 0.25)
    tr.count("c", 3)
    delta = tr.since(before)
    assert delta == {"spans": {"a": 0.5, "b": 0.25}, "counters": {"c": 3}}
    assert tr.since(tr.snapshot()) == {"spans": {"a": 0.0, "b": 0.0}, "counters": {"c": 0}}
    before["spans"]["a"] = 99.0  # a snapshot is a copy
    assert tr.totals["a"] == 1.5


def test_no_profiler_enters_no_record_function(monkeypatch):
    entered = []
    real = timing.record_function

    def spy(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(timing, "record_function", spy)
    tr = Tracer()
    with tr.span("quiet"):
        pass
    tr.wait("quiet.wait", None)
    assert entered == []
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with tr.span("loud"):
            pass
    assert entered == ["loud"]


def test_spans_sit_inside_the_profilers_window(tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function

    tr = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("window"):
            with tr.span("layer.outer"):
                with tr.span("layer.inner"):
                    torch.ones(64).sum()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    by_name = {e["name"]: e for e in events if e.get("ph") == "X"
               and e.get("cat") == "user_annotation"}
    win = by_name["window"]
    lo, hi = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    for name in ("layer.outer", "layer.inner"):
        e = by_name[name]
        assert e["tid"] == win["tid"]
        assert lo <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= hi + 1e-3
    outer, inner = by_name["layer.outer"], by_name["layer.inner"]
    end = lambda e: float(e["ts"]) + float(e["dur"])  # noqa: E731
    assert float(outer["ts"]) <= float(inner["ts"]) and end(inner) <= end(outer) + 1e-3


def test_wait_without_an_event_is_an_empty_span():
    tr = Tracer()
    assert ready_event(CPU) is None
    tr.wait("x.device_wait", None)
    assert tr.counts["x.device_wait"] == 1 and tr.totals["x.device_wait"] < 0.01


def test_mapper_spans(world):
    mapper = world["mapper"]
    assert mapper.timer is TRACER
    before = TRACER.snapshot()
    chains = mapper.map_reads(world["queries"])
    mapper.chains_gaf_text(chains)
    got = TRACER.since(before)["spans"]
    assert MAPPER_SPANS | {"mapper.gaf"} <= {k for k, v in got.items() if v > 0}
    assert not {"gather", "device_map", "count"} & set(TRACER.totals)


def test_abpoa_route_spans_and_counters(world, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    aligner = PA.PoaAligner(world["index"], CPU, export_subgraphs=True, graph=world["graph"])
    before = TRACER.snapshot()
    aligner.finish_alignments(aligner.begin_alignments(world["chains"]))
    got = TRACER.since(before)
    n = sum(not cs[0].is_placeholder for cs in world["chains"])
    ran = {k for k, v in got["spans"].items() if v > 0}
    assert {"aligner.extract", "aligner.export", "aligner.export.paths",
            "aligner.export.write", "aligner.build", "aligner.launch",
            "aligner.device_wait", "aligner.drain", "aligner.select"} <= ran
    assert got["spans"].get("aligner.host_poa", 0.0) == 0.0
    assert got["counters"]["aligner.export_files"] == n == len(os.listdir("subgraphs"))
    assert got["counters"]["aligner.device_problems"] == n
    assert got["counters"]["aligner.host_problems"] == 0  # registered, none ran there
    halves = got["spans"]["aligner.export.paths"] + got["spans"]["aligner.export.write"]
    assert halves <= got["spans"]["aligner.export"]


def test_export_paths_come_from_the_native_pass(world, tmp_path, monkeypatch):
    """Every exported chain's paths come from the batch's native pass
    (``aligner.export.native_paths`` equals ``aligner.export_files``), and
    ``aligner.export.paths`` is still a span inside ``aligner.export``, on
    the tracer and on the profiler's trace."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.chdir(tmp_path)
    aligner = PA.PoaAligner(world["index"], CPU, export_subgraphs=True, graph=world["graph"])
    before = TRACER.snapshot()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state = aligner.begin_alignments(world["chains"])
    aligner.finish_alignments(state)
    got = TRACER.since(before)
    n = sum(not cs[0].is_placeholder for cs in world["chains"])
    assert got["counters"]["aligner.export.native_paths"] == n
    assert got["counters"]["aligner.export_files"] == n == len(os.listdir("subgraphs"))
    assert 0 < got["spans"]["aligner.export.paths"] <= got["spans"]["aligner.export"]
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = {e["name"]: e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"}
    outer, inner = events["aligner.export"], events["aligner.export.paths"]
    end = lambda e: float(e["ts"]) + float(e["dur"])  # noqa: E731
    assert inner["tid"] == outer["tid"]
    assert float(outer["ts"]) <= float(inner["ts"]) and end(inner) <= end(outer) + 1e-3


def test_host_problems_are_counted_and_unchanged(world, tmp_path, monkeypatch):
    """Every subgraph over a lowered vertex cap runs on the native host
    POA under ``aligner.host_poa``: counted, and the GAF text is the
    device route's."""
    monkeypatch.chdir(tmp_path)
    aligner = PA.PoaAligner(world["index"], CPU)
    want = _gaf(aligner.best_alignments_for_queries(world["chains"]))
    monkeypatch.setattr(PA, "_V_DEVICE_CAP", 0)
    before = TRACER.snapshot()
    got_alns = aligner.best_alignments_for_queries(world["chains"])
    got = TRACER.since(before)
    n = sum(not cs[0].is_placeholder for cs in world["chains"])
    assert _gaf(got_alns) == want
    assert got["counters"]["aligner.host_problems"] == n
    assert got["counters"]["aligner.device_problems"] == 0
    assert got["spans"]["aligner.host_poa"] > 0
    assert got["spans"].get("aligner.launch", 0.0) == 0.0


def test_rspoa_route_spans(world):
    aligner = PA.PoaAligner(world["index"], CPU, engine=PA.PoaEngine.RSPOA)
    before = TRACER.snapshot()
    aligner.best_alignments_for_queries(world["chains"])
    got = TRACER.since(before)["spans"]
    assert {"aligner.extract", "aligner.build", "aligner.launch", "aligner.select"} <= \
        {k for k, v in got.items() if v > 0}
    assert got.get("aligner.export", 0.0) == 0.0


def test_writer_spans_and_bytes(tmp_path):
    prefix = str(tmp_path / "out")
    w = ResumableGafWriter(prefix, prefix + "-chains.gaf", prefix + "-alignments.gaf")
    before = TRACER.snapshot()
    w.write_chains(2, b"row1\nrow2\n")
    w.write_alignments(b"aln1\naln2\n", 2)
    got = TRACER.since(before)
    w.close(done=True)
    assert got["counters"]["writer.bytes"] == 20
    assert got["spans"]["writer.write"] > 0 and got["spans"]["writer.fsync"] > 0
    assert TRACER.counts["writer.fsync"] >= 3  # two data files and one progress commit


@pytest.mark.parametrize("align", [False, True])
def test_stream_leaves_its_spans(world, tmp_path, monkeypatch, align):
    monkeypatch.chdir(tmp_path)
    aligner = (PA.PoaAligner(world["index"], CPU, export_subgraphs=True, graph=world["graph"])
               if align else None)
    rows = []
    stream.stream_map_align(world["mapper"], world["queries"], aligner, batch_size=16,
                            on_chains=rows.append,
                            on_alignments=rows.append if align else None)
    first = stream.LAST_RUN
    assert first["spans"]["stream.join"] > 0
    assert TRACER.counts["stream.join"] >= 3  # 40 reads in batches of 16
    assert MAPPER_SPANS <= {k for k, v in first["spans"].items() if v > 0}
    if align:
        assert first["counters"]["aligner.export_files"] == sum(
            not cs[0].is_placeholder for cs in world["chains"])
    stream.stream_map_align(world["mapper"], world["queries"][:16], aligner, batch_size=8,
                            on_chains=rows.append,
                            on_alignments=rows.append if align else None)
    second = stream.LAST_RUN
    assert second is not first and second["spans"]["stream.join"] > 0
    if align:
        assert second["counters"]["aligner.export_files"] == sum(
            not cs[0].is_placeholder for cs in world["chains"][:16])


def test_abpoa_spans_cover_begin_alignments(world, tmp_path, monkeypatch):
    """The program's spans inside ``begin_alignments`` account for most
    of it; the rest is the selection loop and the span bookkeeping."""
    monkeypatch.chdir(tmp_path)
    aligner = PA.PoaAligner(world["index"], CPU, export_subgraphs=True, graph=world["graph"])
    chains = world["chains"] * 4
    before = TRACER.snapshot()
    t0 = time.perf_counter()
    state = aligner.begin_alignments(chains)
    begin = time.perf_counter() - t0
    got = TRACER.since(before)["spans"]
    aligner.finish_alignments(state)
    covered = sum(got.get(k, 0.0) for k in ABPOA_BEGIN)
    assert 0.95 * begin <= covered <= begin
