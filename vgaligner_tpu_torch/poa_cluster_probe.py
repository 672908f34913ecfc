"""Where the cluster POA kernel's time goes, on the card.

    python -m vgaligner_tpu_torch.poa_cluster_probe [--reps 10] [--json PATH]

Maps chip_smoke.py's long reads (``testing.long_reads`` on
``write_synthetic_gfa`` seed 0, k = 11, ``map -p abpoa`` with fast
chaining) on the card and keeps the largest chunk the cluster kernel
(kernels/csrc/poa_dp_tb_cluster.cu) receives.  Then it builds edited
copies of that source with nvcc, one library each, into
``_build/probe/``:

  * ``slice512``: the source as it is (512 columns a CTA up to W 8,192,
    ``CLUSTER_SLICE``);
  * ``slice256`` and ``slice1024``: 256 or 1,024 columns a CTA there (at
    W 2,048: 8 CTAs of 2 warps, or 2 CTAs of 8 warps, a cluster);
  * ``nowalk``: the kernel ending after its last row, so it writes no
    score, best sink or tape: the DP's share of the time.

Each is held against ``poa_dp_plain`` + ``poa_traceback_plain`` on the
chunk (``nowalk`` on tbits below nv), then timed in turns, each variant
and then each in reverse order, ``--reps`` launches a turn through its C
entry on outputs allocated once.  Last, ``slice512`` and ``nowalk`` are
timed on the chunk's problem of the largest nv alone, so that the
difference from the whole chunk is what its problems cost each other.
Every line carries the card's name and power limit; without a CUDA GPU it
exits with an error.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

K = 11
_SLICE_LINE = "constexpr int SLICE = 512;"
_WALK_LINE = "if (nqc < jw || nqc >= jw + 32 * C) return;"


def variant_sources(src: str) -> dict:
    """The probe's edited copies of the kernel source, by name."""
    if _SLICE_LINE not in src or _WALK_LINE not in src:
        raise ValueError("poa_dp_tb_cluster.cu no longer has the lines the probe edits")
    return {
        "slice512": src,
        "slice256": src.replace(_SLICE_LINE, "constexpr int SLICE = 256;"),
        "slice1024": src.replace(_SLICE_LINE, "constexpr int SLICE = 1024;"),
        "nowalk": src.replace(_WALK_LINE, "return;"),
    }


def _build(sources: dict, out_dir: str) -> dict:
    """nvcc, one process a source text, all started together, each into a
    library of its own -> {name: (CDLL, ptxas register lines)}; the
    caller binds the C entries."""
    from . import kernels

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        procs[name] = subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-shared", "-o",
             os.path.join(out_dir, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
        so = ctypes.CDLL(os.path.abspath(os.path.join(out_dir, f"{name}.so")))
        libs[name] = (so, [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                           if "Used" in ln and "registers" in ln])
    return libs


def _largest_long_chunk(dev):
    """The largest chunk (rows below nv x W) that the long reads' abPOA
    alignment gives the cluster kernel: its seven arguments."""
    from .graph import graph_from_gfa
    from .index import Index
    from .io.fastx import QuerySequence
    from .models.mapper import Mapper
    from .models.poa_aligner import PoaAligner, PoaEngine
    from .ops import poa_device as PD
    from .testing import long_reads, write_synthetic_gfa

    work = tempfile.mkdtemp(prefix="vg_cluster_probe_")
    captured: dict = {}
    real = PD.poa_dp_tb_cluster

    def keep_largest(*args):
        size = int(args[3].sum()) * args[4].shape[1]
        if not captured or size > captured["size"]:
            captured.update(args=args, size=size)
        return real(*args)

    try:
        gfa = os.path.join(work, "graph.gfa")
        write_synthetic_gfa(gfa, seed=0)
        graph = graph_from_gfa(gfa)
        index = Index.build(graph, K, 100, 100)
        qs = [QuerySequence(f"read{i}", r) for i, r in enumerate(long_reads(graph))]
        PD.poa_dp_tb_cluster = keep_largest
        chains = Mapper(index, dev, precision="fast").map_reads(qs)
        PoaAligner(index, dev, engine=PoaEngine.ABPOA).best_alignments_for_queries(chains)
    finally:
        PD.poa_dp_tb_cluster = real
        shutil.rmtree(work, ignore_errors=True)
    return captured["args"]


def _launcher(so, t, init):
    """A call of the variant's C entry on ``t`` with outputs allocated
    once -> (call, outputs)."""
    import torch

    from . import kernels

    from .ops import poa_device as PD

    B, V = t[0].shape
    P, L = t[1].shape[-1], t[4].shape[1]
    W, dev = L + 1, t[0].device
    off = PD._back_offsets(t[1], t[3], None, PD.TB_RING, PD.TB_PINS)
    outs = [torch.from_numpy(off).to(dev),
            torch.empty((max(int(off[-1]), 1), 3 * W), dtype=torch.float32, device=dev),
            torch.empty(B, dtype=torch.float32, device=dev),
            torch.empty(B, dtype=torch.int32, device=dev),
            torch.empty((B, V, W), dtype=torch.int32, device=dev),
            torch.empty((B, V + W + 1), dtype=torch.int32, device=dev),
            torch.empty(B, dtype=torch.int32, device=dev),
            torch.empty(B, dtype=torch.int32, device=dev)]
    ptrs = ([x.data_ptr() for x in t] + [init.data_ptr(), B, V, P, L]
            + [o.data_ptr() for o in outs] + [kernels.stream_ptr(dev)])
    def call():  # holds outs: the allocator must not hand their memory on while in use
        kernels.check(so.vg_poa_dp_tb_cluster(*ptrs), "poa_cluster_probe")
        return outs

    return call, outs


def _ms(fn, reps):
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> dict:
    import torch

    from .kernels import BUILD_DIR, CSRC
    from .ops import poa_device as PD

    ap = argparse.ArgumentParser(prog="python -m vgaligner_tpu_torch.poa_cluster_probe")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--json", dest="json_path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("poa_cluster_probe: needs a CUDA GPU (torch.cuda.is_available() is False)")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    with open(os.path.join(CSRC, "poa_dp_tb_cluster.cu")) as fh:
        libs = _build(variant_sources(fh.read()), os.path.join(BUILD_DIR, "probe"))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for so, _regs in libs.values():
        so.vg_poa_dp_tb_cluster.argtypes = [vp] * 7 + [ci] * 4 + [vp] * 9
        so.vg_poa_dp_tb_cluster.restype = ci
    args_ = _largest_long_chunk(dev)
    t, init = list(args_[:6]), args_[6]
    B, V = t[0].shape
    W, P = t[4].shape[1] + 1, t[1].shape[-1]
    ws, wk, wtb = PD.poa_dp_plain(*t, init)
    wtape, wtl = PD.poa_traceback_plain(wtb, t[1], wk, t[5])
    below_nv = torch.arange(V, device=dev)[None, :] < t[3][:, None]
    out = {"card": card, "B": B, "V": V, "W": W, "P": P, "slice": PD.CLUSTER_SLICE[W],
           "nv_mean": float(t[3].float().mean()), "nv_max": int(t[3].max()),
           "walk_steps_mean": float(wtl.float().mean()), "walk_steps_max": int(wtl.max()),
           "registers": {n: regs for n, (_so, regs) in libs.items()}, "chunk_ms": {},
           "alone_ms": {}}
    print(f"[probe] largest long-read chunk B {B} V {V} W {W} P {P} ({W // out['slice']} CTAs "
          f"of {out['slice']} columns as the source stands): nv mean "
          f"{out['nv_mean']:.1f} max {out['nv_max']}, walk steps mean "
          f"{out['walk_steps_mean']:.1f} max {out['walk_steps_max']} ({card})")
    calls = {}
    for name, (so, regs) in libs.items():
        call, (_off, _bk, score, sink, tbits, tape, tlen, _nb) = _launcher(so, t, init)
        call()
        torch.cuda.synchronize()
        same = torch.equal(tbits[below_nv], wtb[below_nv])
        if name != "nowalk":
            same = same and all(torch.equal(a, b) for a, b in
                                ((score, ws), (sink, wk), (tape, wtape), (tlen, wtl)))
        if not same:
            raise AssertionError(f"poa_cluster_probe: the {name} variant differs from the "
                                 "plain pair")
        calls[name] = call
        print(f"[probe] {name}: equal to the plain pair; ptxas {'; '.join(regs)}")
    for name in list(calls) + list(calls)[::-1]:
        out["chunk_ms"].setdefault(name, []).append(_ms(calls[name], args.reps))
    for name, ms in out["chunk_ms"].items():
        print(f"[probe] {name} on the chunk: {ms[0]:.4f}, {ms[1]:.4f} ms ({card})")
    b = int(t[3].argmax())
    one = [x[b : b + 1].contiguous() for x in t]
    for name in ("slice512", "nowalk"):
        out["alone_ms"][name] = _ms(_launcher(libs[name][0], one, init)[0], args.reps)
        print(f"[probe] {name} on the problem of nv {out['nv_max']} alone: "
              f"{out['alone_ms'][name]:.4f} ms ({card})")
    if args.json_path:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_path)), exist_ok=True)
        with open(args.json_path, "w") as fh:
            json.dump(out, fh, indent=1)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
