"""One run of a cell: set-up, the measured window, and the record.

The window drives the port's CLI path, ``stream_map_align``, with the
``Mapper`` and ``PoaAligner`` built from the configuration's option list
exactly as ``cli._map_run`` builds them, and both GAFs written through
``ResumableGafWriter`` by callbacks that do what the CLI's do.  On
several cards each rank is one process on its card, as ``cli._rank_main``
runs it, and rank 0 merges and writes.

Set-up: parse the graph, build the index as ``vgaligner index`` does
(without writing it), make the reads from the seed, build the mapper and
aligner, and run a few hundred warm-up reads through the same path.

The window starts with the first batch and ends with the write of the
last batch that started before ``seconds`` had passed: batches are
handed to the stream whole, and once the time is up each further batch
is empty (rank 0 decides, for every rank).  Empty batches do no work.
``reads_per_s`` is every read of the window over the whole window.
"""

from __future__ import annotations

import collections.abc
import gc
import os
import time
from typing import Optional

import numpy as np

from . import traffic as _traffic
from . import work as _work
from .trace import WINDOW, Spans, reduce_trace

def paths(workdir: str) -> dict:
    return {"graph": os.path.join(workdir, "graph.gfa"),
            "out": os.path.join(workdir, "out"),
            "warm": os.path.join(workdir, "warm")}


def n_reads(traffic: dict, seconds: float, batch: int) -> int:
    """Reads made for the window: ``max_reads_per_s`` over the window
    and one batch more, in whole batches."""
    n = int(traffic["max_reads_per_s"] * seconds) + batch
    return -(-n // batch) * batch


def make_reads(gfa: str, traffic: dict, seed: int, n_window: int):
    """(warm-up reads, window reads) as (name, sequence) pairs."""
    n_warm = traffic["warmup_reads"]
    L = traffic["read_len"]
    text = _traffic.make_reads(gfa, n_warm + n_window, L, traffic["sub_rate"], seed).decode()
    warm = [(f"w{i}", text[i * L:(i + 1) * L]) for i in range(n_warm)]
    off = n_warm * L
    win = [(f"q{i}", text[off + i * L:off + (i + 1) * L]) for i in range(n_window)]
    return warm, win


def map_args(config: dict, traffic: dict, p: dict):
    from vgaligner_tpu_torch.cli import _build_parser

    argv = [a.format(index=p["out"] + ".idx.npz", reads=p["out"] + ".fa", graph=p["graph"])
            for a in config["map_argv"] + traffic["map_argv"]]
    return _build_parser().parse_args(argv)


def build_index(config: dict, graph, p: dict):
    """``Index.build`` as ``cli.index_main`` calls it, without the file."""
    from vgaligner_tpu_torch.cli import _build_parser
    from vgaligner_tpu_torch.index import Index

    args = _build_parser().parse_args([a.format(graph=p["graph"]) for a in config["index_argv"]])
    return Index.build(graph, args.kmer_length, max_furcations=args.max_furcations,
                       max_degree=args.max_degree, out_prefix=None,
                       sampling_rate=args.sampling_rate, generate_mappings=False,
                       mappings_path=None, n_policy=args.n_policy,
                       dedup_positions=not args.keep_duplicate_positions,
                       modimizer=args.modimizer)


_EMPTY = ("vgbench-empty",)


def _skip_empty(obj, method: str, reads: "WindowReads") -> None:
    """Calls on the empty batches after the window return at once."""
    fn = getattr(obj, method)

    def wrapped(arg, *a, **kw):
        if arg is _EMPTY or (reads.closed and len(arg) == 0):
            return [] if method in ("map_reads", "finish_map", "finish_alignments") else _EMPTY
        return fn(arg, *a, **kw)

    setattr(obj, method, wrapped)


class WindowReads(collections.abc.Sequence):
    """The window's reads as the stream slices them: whole batches until
    ``seconds`` have passed since ``t0``, empty batches after."""

    def __init__(self, queries: list, seconds: float, mesh=None):
        self.queries = queries
        self.seconds = seconds
        self.mesh = mesh
        self.t0 = None
        self.handed = 0
        self.closed = False

    def __len__(self) -> int:
        return len(self.queries)

    def _expired(self) -> bool:
        late = time.perf_counter() - self.t0 >= self.seconds
        if self.mesh is None:
            return late
        import torch
        import torch.distributed as dist

        flag = torch.tensor([int(late)], dtype=torch.int32, device=self.mesh.device)
        dist.broadcast(flag, 0)
        return bool(flag.item())

    def __getitem__(self, item):
        if not isinstance(item, slice):
            return self.queries[item]
        if item.start and (self.closed or self._expired()):
            self.closed = True
            return []
        part = self.queries[item]
        self.handed += len(part)
        return part


def _capture_work():
    """Patch the kernels' Python entries to keep what each launch's work
    count needs; returns (records, restore)."""
    from vgaligner_tpu_torch.ops import chain as ch
    from vgaligner_tpu_torch.ops import poa_device as pd

    rec = {"chain": [], "global": [], "local": [], "local_tlen": []}
    saved = {}

    def patch(mod, name, make):
        saved[(mod, name)] = getattr(mod, name)
        setattr(mod, name, make(getattr(mod, name)))

    def chain_entry(exact):
        def make(fn):
            def wrapped(qb, tb, te, valid, *a, **kw):
                rec["chain"].append((exact, valid.sum(dim=1)))
                return fn(qb, tb, te, valid, *a, **kw)
            return wrapped
        return make

    def dispatch(fn):
        def wrapped(chunk, qs, *a, **kw):
            out = fn(chunk, qs, *a, **kw)
            vpred, nv = chunk[1], np.asarray(chunk[3], dtype=np.int64)
            nq = np.asarray([len(q) for q in qs], dtype=np.int64)
            rec["global"].append((vpred, nv, nq, out[0][2]))
            return out
        return wrapped

    def chunks(fn):
        def wrapped(*a, **kw):
            for s, e, arrs, back in fn(*a, **kw):
                rec["local"].append((arrs[1], np.asarray(arrs[2], np.int64),
                                     np.asarray(arrs[4], np.int64)))
                yield s, e, arrs, back
        return wrapped

    def local(fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            rec["local_tlen"].append(out[2])
            return out
        return wrapped

    patch(ch, "chain_dp", chain_entry(False))
    patch(ch, "chain_dp_exact", chain_entry(True))
    patch(pd, "kernel_dispatch", dispatch)
    patch(pd, "local_chunks", chunks)
    patch(pd, "poa_local", local)

    def restore():
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)

    return rec, restore


def _work_bounds(rec: dict, bandwidth: int) -> dict:
    """Sum over the window's launches of each family's least time."""
    out = {"chain": {"bound_s": 0.0, "launches": 0, "bound_by": {}},
           "poa": {"bound_s": 0.0, "launches": 0, "bound_by": {}}}

    def add(fam, nbytes, ops, rate):
        t, by = _work.bound_s(nbytes, ops, rate)
        out[fam]["bound_s"] += t
        out[fam]["launches"] += 1
        out[fam]["bound_by"][by] = out[fam]["bound_by"].get(by, 0) + 1

    for exact, n in rec["chain"]:
        nbytes, ops = _work.chain_work(n.cpu().numpy(), bandwidth, exact)
        add("chain", nbytes, ops, _work.F64_OPS_PER_S if exact else _work.F32_OPS_PER_S)
    for vpred, nv, nq, tlen in rec["global"]:
        nbytes, ops = _work.global_work(vpred, nv, nq, tlen.cpu().numpy())
        add("poa", nbytes, ops, _work.F32_OPS_PER_S)
    for (vpred, nv, nq), tlen in zip(rec["local"], rec["local_tlen"]):
        nbytes, ops = _work.local_work(vpred, nv, nq, tlen.cpu().numpy())
        add("poa", nbytes, ops, _work.F32_OPS_PER_S)
    return out


def run(cell: dict, seed: int, seconds: float, trace: bool, workdir: str, device_name: str,
        t_start: float, mesh=None, fault: Optional[str] = None,
        batch: Optional[int] = None) -> dict:
    """Set up, run the window on this process's device, and return its
    record; rank 0 (or the only rank) writes the GAFs under ``workdir``.
    ``fault`` plants one of ``faults.INSTALL`` and ``batch`` replaces the
    stream's batch size: both for the tests only."""
    import torch

    from vgaligner_tpu_torch import kernels
    from vgaligner_tpu_torch.cli import resolve_ranks
    from vgaligner_tpu_torch.device import resolve_device, resolve_precision
    from vgaligner_tpu_torch.graph import graph_from_gfa
    from vgaligner_tpu_torch.io.fastx import QuerySequence
    from vgaligner_tpu_torch.io.resume import ResumableGafWriter
    from vgaligner_tpu_torch.models import stream
    from vgaligner_tpu_torch.models.mapper import Mapper
    from vgaligner_tpu_torch.models.poa_aligner import PoaAligner, PoaEngine
    from vgaligner_tpu_torch.parallel.mesh import collective_counts

    config, traffic = cell["config"], cell["traffic"]
    p = paths(workdir)
    lead = mesh is None or mesh.rank == 0
    device = mesh.device if mesh is not None else resolve_device(device_name)
    graph = graph_from_gfa(p["graph"])
    index = build_index(config, graph, p)
    args = map_args(config, traffic, p)
    if device.type == "cpu" and args.precision == "auto":
        args.precision = config["precision"]  # tests on the CPU: the card's precision
    precision = resolve_precision(args.precision, device)
    if precision != config["precision"]:
        raise RuntimeError(f"the run resolves precision {precision}, the configuration "
                           f"states {config['precision']}")
    ranks = 1 if mesh is None else mesh.size
    if device.type == "cuda" and args.threads and resolve_ranks(args.threads, device) != ranks:
        raise RuntimeError(f"-t {args.threads} resolves to {resolve_ranks(args.threads, device)} "
                           f"ranks; the cell runs {ranks}")
    batch = batch or stream.DEFAULT_BATCH
    warm, win = make_reads(p["graph"], traffic, seed, n_reads(traffic, seconds, batch))
    warm = [QuerySequence(n, s) for n, s in warm]
    win = [QuerySequence(n, s) for n, s in win]

    mapper = Mapper(index, device, bandwidth=50, max_gap=args.max_gap_length,
                    chain_min_n_anchors=args.chain_min_anchors, mapq=args.mapq,
                    precision=precision, both_strands=args.both_strands, mesh=mesh,
                    shard_index=args.shard_index)
    aligner = None
    if args.also_align:
        aligner = PoaAligner(index, device, engine=PoaEngine(args.poa_aligner),
                             export_subgraphs=True, graph=graph,
                             bubble_closure=args.bubble_closure, range_mode=args.range_mode,
                             mesh=mesh)
    reads = WindowReads(win, seconds, mesh)
    for m in ("map_reads", "begin_map", "finish_map"):
        _skip_empty(mapper, m, reads)
    if aligner is not None:
        _skip_empty(aligner, "begin_alignments", reads)
        _skip_empty(aligner, "finish_alignments", reads)
    if fault:
        from .faults import INSTALL

        INSTALL[fault](mapper, aligner, mesh)

    spans = Spans(annotate=trace)
    state = {"writer": None, "t_end": None, "written": 0}

    def on_chains(b):
        n = b.n_reads if isinstance(b, stream.GafBatch) else len(b)
        if not n:
            return
        with spans.span("writer"):
            rows = b.blob if isinstance(b, stream.GafBatch) else mapper.chains_gaf_text(b)
            state["writer"].write_chains(n, rows)
            if aligner is None:
                state["written"] += n
        state["t_end"] = time.perf_counter()

    def on_alignments(b):
        n = b.n_reads if isinstance(b, stream.GafBatch) else len(b)
        if not n:
            return
        with spans.span("writer"):
            if isinstance(b, stream.GafBatch):
                state["writer"].write_alignments(b.blob, b.n_reads)
            else:
                state["writer"].write_alignments(b)
            state["written"] += n
        state["t_end"] = time.perf_counter()

    def writer_for(prefix):
        if not lead:
            return None
        align = prefix + "-alignments.gaf" if aligner is not None else None
        return ResumableGafWriter(prefix, prefix + "-chains.gaf", align, resume=False)

    def drive(queries):
        stream.stream_map_align(mapper, queries, aligner, batch_size=batch,
                                align_best_n=args.align_best_n, on_chains=on_chains,
                                on_alignments=on_alignments if aligner else None, mesh=mesh)

    # warm-up: a few hundred reads through the same path
    state["writer"] = writer_for(p["warm"])
    drive(warm)
    if lead:
        state["writer"].close(done=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()
    setup_end = time.time()

    if trace:
        spans.wrap(mapper, "map_reads", "mapper")
        spans.wrap(mapper, "begin_map", "mapper")
        spans.wrap(mapper, "finish_map", "mapper")
        if aligner is not None:
            spans.wrap(aligner, "begin_alignments", "aligner.begin")
            spans.wrap(aligner, "finish_alignments", "aligner.finish")
        work_rec, restore = _capture_work()
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
    state.update(writer=writer_for(p["out"]), written=0, t_end=None)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    coll0 = sum(collective_counts().values())
    launches0 = kernels.launch_counts()
    phases0 = dict(mapper.timer.totals)
    t0 = time.perf_counter()
    t0_wall = time.time()
    reads.t0 = t0
    if trace:
        from torch.profiler import record_function

        with record_function(WINDOW):
            drive(reads)
    else:
        drive(reads)
    t_end = state["t_end"] if lead else time.perf_counter()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    coll = sum(collective_counts().values()) - coll0
    launches = {k: v - launches0.get(k, 0) for k, v in kernels.launch_counts().items()
                if v - launches0.get(k, 0)}
    if reads.handed >= len(win) and not reads.closed:
        raise RuntimeError(f"the run ran out of reads ({len(win)}) before {seconds} s: "
                           "raise the traffic's max_reads_per_s")
    if lead:
        state["writer"].close(done=True)
    window_s = t_end - t0
    rec = {
        "rank": 0 if mesh is None else mesh.rank,
        "ranks": 1 if mesh is None else mesh.size,
        "setup_end_wall": setup_end,
        "window_start_wall": t0_wall,
        "setup_s": setup_end - t_start,
        "window_s": window_s,
        "reads": reads.handed,
        "written": state["written"],
        "peak_bytes": int(peak),
        "collectives": coll if mesh is not None else None,
        "launches": launches,
        "device_kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "mapper_phases": {k: v - phases0.get(k, 0.0) for k, v in mapper.timer.totals.items()},
        "batch": batch,
        "generated": len(win),
        "precision": precision,
    }
    if trace:
        prof.stop()
        restore()
        tpath = os.path.join(workdir, f"trace-{rec['rank']}.json")
        prof.export_chrome_trace(tpath)
        del prof
        rec["trace"] = reduce_trace(tpath)
        os.remove(tpath)
        rec["work"] = _work_bounds(work_rec, 50)
        rec["layers"] = spans.totals(t0, t0 + window_s)
        rec["main"] = spans.totals(t0, t0 + window_s, main_only=True)
    del mapper, aligner, index, graph, win, warm, reads
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def export_stats(workdir: str) -> dict:
    """Files and bytes the abPOA export wrote under ``./subgraphs``."""
    d = os.path.join(workdir, "subgraphs")
    n = size = 0
    if os.path.isdir(d):
        with os.scandir(d) as it:
            for e in it:
                n += 1
                size += e.stat().st_size
    return {"export_files": n, "export_bytes": size}
