"""The benchmark of vgaligner_tpu_torch: one run of one cell.

    python3 -m vgbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

runs the cell's configuration under its traffic on this machine's cards
(one process a card), in a fresh directory under ``TMPDIR`` that is
removed at exit, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics, read from a
torch.profiler trace of the window and the harness's spans), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number that
decided ``correct`` beside its limit, which also end standard error.

It exits non-zero and prints no result without as many cards as the
cell asks for, without the program beside it, or when JAX has been
loaded.  ``--control int16`` puts the reference, computed in int16, the
arithmetic one step below the fast cells' int32, in the program's place
(``judge.py``): such runs are controls, never benchmark runs.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from typing import List, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from vgbench import harness, manifest, traffic  # noqa: E402
from vgbench.judge import judge  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "vgaligner_tpu")
RANK_TIMEOUT = 330.0


def log(msg: str) -> None:
    print(f"[vgbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the benchmark forbids."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _rank_entry(rank, size, workdir, cell, seed, seconds, trace, t_start, device, fault,
                batch, queue):
    import torch
    import torch.distributed as dist

    backend = "gloo"
    if device == "cuda":
        torch.cuda.set_device(rank)
        backend = "nccl"
    else:
        torch.set_num_threads(1)  # CPU ranks (the tests) share the host's cores
    try:
        from vgaligner_tpu_torch.parallel.distributed import TIMEOUT
        from vgaligner_tpu_torch.parallel.mesh import make_mesh

        dist.init_process_group(backend, init_method=f"file://{workdir}/rendezvous", rank=rank,
                                world_size=size, timeout=TIMEOUT)
        try:
            mesh = make_mesh(size)
            rec = harness.run(cell, seed, seconds, trace, workdir, device, t_start, mesh=mesh,
                              fault=fault, batch=batch)
        finally:
            dist.destroy_process_group()
        queue.put(("ok", rank, rec))
    except BaseException:
        queue.put(("error", rank, traceback.format_exc()))
        raise


def _ranks(cell, size, seed, seconds, trace, workdir, device, fault, batch) -> List[dict]:
    """Each rank in a spawned process of its own; their records, rank order."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, size, workdir, cell, seed, seconds, trace, T_START, device,
                               fault, batch, q), daemon=True)
             for r in range(size)]
    for p in procs:
        p.start()
    recs: dict = {}
    errors = []
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        while len(recs) + len(errors) < size:
            try:
                kind, rank, got = q.get(timeout=2.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if dead or time.monotonic() > deadline:
                    errors.append(f"ranks {dead} ended without a result" if dead
                                  else "a rank gave no result in time")
                    break
                continue
            if kind == "ok":
                recs[rank] = got
            else:
                errors.append(f"rank {rank}:\n{got}")
                break
    finally:
        for p in procs:
            p.join(timeout=30)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [recs[r] for r in range(size)]


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ") or None
    except (OSError, subprocess.SubprocessError):
        return None


def execute(cell: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
            control: Optional[str] = None, fault: Optional[str] = None,
            batch: Optional[int] = None) -> dict:
    """Everything of a run after the look for cards: the result line's
    object.  Works in a fresh directory under TMPDIR, removed at the end."""
    chips = cell["workload"]["chips"]
    stated = cell["config"]["precision"]
    workdir = tempfile.mkdtemp(prefix="vgbench-")
    here = os.getcwd()
    os.chdir(workdir)
    try:
        p = harness.paths(workdir)
        shape = traffic.write_graph(p["graph"], **cell["config"]["graph"])
        if shape != cell["config"]["graph_shape"]:
            raise RuntimeError(f"graph {shape} is not the configuration's "
                               f"{cell['config']['graph_shape']}")
        if chips == 1:
            recs = [harness.run(cell, seed, seconds, trace, workdir, device, T_START,
                                fault=fault, batch=batch)]
        else:
            recs = _ranks(cell, chips, seed, seconds, trace, workdir, device, fault, batch)
        lead = recs[0]
        log(f"setup {lead['setup_s']:.3f} s, window {lead['window_s']:.3f} s, "
            f"{lead['written']} of {lead['reads']} reads written, batch {lead['batch']}, "
            f"precision {lead['precision']}")
        log(f"launches {json.dumps(lead['launches'])}")
        phases = {k: round(v, 4) for k, v in lead["mapper_phases"].items()}
        log(f"mapper phases (s) {json.dumps(phases)}")
        log(f"export {json.dumps(harness.export_stats(workdir))}, GAF bytes "
            + json.dumps({os.path.basename(f): os.path.getsize(f)
                          for f in (p['out'] + '-chains.gaf', p['out'] + '-alignments.gaf')
                          if os.path.exists(f)}))
        if device == "cuda":
            log(f"card {_power_limit()}")
        metrics = {}
        if trace:
            record = _record(recs)
            metrics = manifest.per_layer(record, cell["per_layer"])
            log("spans (s) " + json.dumps({k: round(v, 4) for k, v in lead["layers"].items()}))
            log("work " + json.dumps(record["work"]))
        else:
            e2e = {"reads_per_s": lead["written"] / lead["window_s"],
                   "peak_device_mib": max(r["peak_bytes"] for r in recs) / 2 ** 20,
                   "setup_s": max(r["setup_end_wall"] for r in recs) - T_START}
            units = {m["name"]: m["unit"] for m in cell["end_to_end"]}
            metrics = {k: {"value": v, "unit": units[k]} for k, v in e2e.items() if k in units}
        config, mix = cell["config"], cell["traffic"]
        engine = None
        args = harness.map_args(config, mix, p)
        if args.also_align:
            engine = args.poa_aligner
        _warm, reads = harness.make_reads(p["graph"], mix, seed, lead["generated"])
        reads = reads[:lead["reads"]]
        verdict = judge(p["graph"], reads, p["out"] + "-chains.gaf",
                        p["out"] + "-alignments.gaf" if engine else None,
                        os.path.join(workdir, "subgraphs"), mix, stated, engine, seed,
                        control=control)
        log(f"judged in {verdict['seconds']:.2f} s: compared {json.dumps(verdict['compared'])}"
            f", failed examples {verdict['examples']}")
        device_info = {"platform": "gpu" if device == "cuda" else "cpu",
                       "kind": lead["device_kind"], "count": chips,
                       "memory_peak_bytes": max(r["peak_bytes"] for r in recs)}
        out = {"correct": verdict["correct"], "attempted": verdict["attempted"],
               "failed": verdict["failed"], "metrics": metrics, "device": device_info}
        if trace:
            device_info["busy_s"] = sum(r["trace"]["busy_s"] for r in recs) / len(recs)
            device_info["window_s"] = sum(r["trace"]["window_s"] for r in recs) / len(recs)
            ops: dict = {}
            for r in recs:
                for name, s in r["trace"]["device_ops"]:
                    ops[name] = ops.get(name, 0.0) + s
            out["breakdown"] = {
                "device_ops": sorted(([n, s] for n, s in ops.items()), key=lambda x: -x[1])[:10],
                "idle_gaps": lead["trace"]["idle_by_host"][:10]}
        out["checks"] = verdict["checks"]
        return out
    finally:
        os.chdir(here)
        shutil.rmtree(workdir, ignore_errors=True)


def _record(recs: List[dict]) -> dict:
    """What the per-layer readers read: rank 0's spans, the window's
    reads, and the device figures over every rank."""
    lead = recs[0]
    work = {fam: {"bound_s": sum(r["work"][fam]["bound_s"] for r in recs),
                  "launches": sum(r["work"][fam]["launches"] for r in recs)}
            for fam in lead["work"]}
    kernel_s = {fam: sum(r["trace"]["kernel_s"][fam] for r in recs)
                for fam in lead["trace"]["kernel_s"]}
    idle = [1.0 - r["trace"]["busy_s"] / r["trace"]["window_s"] for r in recs
            if r["trace"]["window_s"] > 0]
    return {"reads": lead["written"], "window_s": lead["window_s"], "layers": lead["layers"],
            "main": lead["main"], "work": work, "kernel_s": kernel_s,
            "idle_share": sum(idle) / len(idle) if idle else None,
            "collectives": lead["collectives"], "ranks": lead["ranks"]}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="vgbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("int16",), default=None)
    a = ap.parse_args(argv)
    try:
        cell = manifest.cell(a.workload)
        import torch

        chips = cell["workload"]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            log(f"needs {chips} CUDA card(s); torch.cuda.is_available() is "
                f"{torch.cuda.is_available()}, {torch.cuda.device_count()} visible")
            return 2
        import vgaligner_tpu_torch  # noqa: F401  (the program under test)

        out = execute(cell, a.seed, a.seconds, bool(a.trace), control=a.control)
    except Exception:
        log(traceback.format_exc())
        return 1
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {found}")
        return 3
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
