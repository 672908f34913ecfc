"""Where the main path's time goes: map + align on chip_smoke.py's workload.

    python -m vgaligner_tpu_torch.profile_main [--device cuda] [--reads 12288]
        [--backbone 22600] [--json PATH]

On the seeded synthetic graph of ``chip_smoke.py`` (``write_synthetic_gfa``
with seed 0, k = 11, 100 bp reads from bench.py's sampler, seed 77) it
measures, in a temporary working directory (the subgraph export writes
one GFA file per chain there):

  1. streamed map + align (``stream_map_align``, batches of 8,192) with
     and without the per-chain subgraph GFA export ``-G`` forces, twice
     each, as seconds and reads/s;
  2. one unpipelined map + align with export under cProfile: the 12
     functions of most cumulative time, and the Mapper's phase times;
  3. one unpipelined map + align without export, first unprofiled (its
     wall time) and then under torch.profiler: device time per kernel
     or copy, and their sum over that unprofiled wall time as the
     device's busy share.  CUDA only; on the CPU the
     device figures are reported as not measured.

Prints one line per figure and, with ``--json``, writes them all to PATH.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import shutil
import sys
import tempfile
import time

K = 11
READ_LEN = 100
REPS = 2
TOP = 12


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_profile(run, device) -> dict:
    """Time per device-side event name (ms) of one ``run()``: kernels and
    copies.  Host ops (``aten::copy_`` and the like) are left out, since
    their device time is that of the device events they launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        _sync(device)
    per_name = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CPU and ev.self_device_time_total > 0:
            per_name[ev.key] = (ev.self_device_time_total / 1000.0, ev.count)
    return per_name


def main(argv=None) -> dict:
    import torch

    from .graph import graph_from_gfa
    from .index import Index
    from .io.fastx import QuerySequence
    from .utils.timing import PhaseTimer
    from .device import resolve_device
    from .models.mapper import Mapper
    from .models.poa_aligner import PoaAligner
    from .models.stream import DEFAULT_BATCH, stream_map_align
    from .testing import sample_reads, write_synthetic_gfa

    ap = argparse.ArgumentParser(prog="python -m vgaligner_tpu_torch.profile_main")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--reads", type=int, default=12288)
    ap.add_argument("--backbone", type=int, default=22600)
    ap.add_argument("--json", dest="json_path")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    precision = "fast" if device.type == "cuda" else "exact"
    out = {"device": str(device), "precision": precision, "reads": args.reads}
    if device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(device)

    cwd = os.getcwd()
    work = tempfile.mkdtemp(prefix="vg_profile_")
    try:
        os.chdir(work)
        gfa = os.path.join(work, "graph.gfa")
        out["graph"] = write_synthetic_gfa(gfa, seed=0, backbone_len=args.backbone)
        graph = graph_from_gfa(gfa)
        reads = sample_reads(graph, args.reads, READ_LEN, seed=77)
        queries = [QuerySequence(f"read{i}", r) for i, r in enumerate(reads)]
        index = Index.build(graph, K, 100, 100)
        mapper = Mapper(index, device, bandwidth=50, precision=precision)
        aligners = {
            "export": PoaAligner(index, device, export_subgraphs=True, graph=graph),
            "no_export": PoaAligner(index, device, export_subgraphs=False, graph=graph),
        }

        def map_align(aligner):
            chains = mapper.map_reads(queries)
            return aligner.finish_alignments(aligner.begin_alignments(chains, 1))

        map_align(aligners["no_export"])  # warm-up: the kernel build, first launches
        _sync(device)

        for name, aligner in aligners.items():
            secs = []
            for _ in range(REPS):
                t0 = time.monotonic()
                stream_map_align(mapper, queries, aligner, batch_size=DEFAULT_BATCH,
                                 on_alignments=lambda _alns: None)
                _sync(device)
                secs.append(time.monotonic() - t0)
            out[f"stream_{name}"] = {"seconds": secs,
                                     "reads_per_s": [args.reads / s for s in secs]}
            print(f"[stream] map + align, {name}: "
                  + ", ".join(f"{s:.3f} s ({args.reads / s:.1f} reads/s)" for s in secs))

        mapper.timer = PhaseTimer()
        prof = cProfile.Profile()
        t0 = time.monotonic()
        prof.enable()
        map_align(aligners["export"])
        _sync(device)
        prof.disable()
        out["cprofile_seconds"] = time.monotonic() - t0
        stats = pstats.Stats(prof)
        rows = sorted(stats.stats.items(), key=lambda kv: kv[1][3], reverse=True)
        out["cprofile_top"] = [
            {"function": f"{os.path.basename(fn)}:{line}({func})", "calls": nc,
             "tottime": tt, "cumtime": ct}
            for (fn, line, func), (_cc, nc, tt, ct, _callers) in rows[:TOP]
        ]
        out["mapper_phases"] = mapper.timer.summary()
        print(f"[cprofile] unpipelined map + align with export: "
              f"{out['cprofile_seconds']:.3f} s under the profiler")
        for r in out["cprofile_top"]:
            print(f"[cprofile]   {r['cumtime']:9.3f} s cum {r['tottime']:9.3f} s self "
                  f"{r['calls']:8d}x {r['function']}")
        print("[mapper] " + ", ".join(f"{k} {v:.4f} s"
                                      for k, v in out["mapper_phases"].items()))

        t0 = time.monotonic()
        map_align(aligners["no_export"])
        _sync(device)
        wall = time.monotonic() - t0
        out["unpipelined_no_export_seconds"] = wall
        if device.type == "cuda":
            per_name = _device_profile(lambda: map_align(aligners["no_export"]), device)
            total = sum(ms for ms, _n in per_name.values())
            out["device_ms"] = {k: {"ms": ms, "count": n} for k, (ms, n) in per_name.items()}
            out["device_ms_total"] = total
            out["device_busy_share"] = total / (wall * 1000.0)
            print(f"[device] unpipelined map + align without export: {wall:.3f} s wall, "
                  f"{total:.3f} ms device time, busy share "
                  f"{out['device_busy_share']:.4f}")
            for k, (ms, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:TOP]:
                print(f"[device]   {ms:9.3f} ms {n:6d}x {k}")
        else:
            out["device_busy_share"] = None
            print(f"[device] unpipelined map + align without export: {wall:.3f} s wall; "
                  "device time not measured on the CPU")
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)

    if args.json_path:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_path)), exist_ok=True)
        with open(args.json_path, "w") as fh:
            json.dump(out, fh, indent=1)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
