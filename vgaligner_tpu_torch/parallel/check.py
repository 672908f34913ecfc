"""Multi-device check: ``map -t N`` against ``map -t 1`` through the CLI.

    python -m vgaligner_tpu_torch.parallel.check --ranks 4
    python -m vgaligner_tpu_torch.parallel.check --ranks 3 --device cpu --reads 64 --backbone 600

On chip_smoke.py's seeded synthetic graph (``testing.write_synthetic_gfa``,
seed 0) and its 100 bp path-window reads (``--reads``, default 12,288):
``index -k 11``, then for each leg (``-p abpoa -D -G``, and ``-p rspoa
-D -G --precision exact``) ``map`` at ``-t 1``, ``-t N`` and ``-t N
--shard-index``, each in its own directory, on ``--device`` (cuda: one
card a rank over NCCL; cpu: gloo ranks).  Every ``-t N`` run's chains
GAF, alignments GAF and subgraph GFA files must equal the ``-t 1``
run's byte for byte.  Prints the card's name and power limit (cuda), a
line a run (the process's wall seconds, and rank 0's "Chaining +
alignment took" time, which leaves out start-up and index load) and one
JSON line; exits 1 on any difference or failed run.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

LEGS = (("abpoa", []), ("rspoa", ["--precision", "exact"]))
# the directory that holds the package, for the CLI processes' imports
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _outputs(cwd: str) -> dict:
    files = {}
    for root, _dirs, names in os.walk(cwd):
        for name in names:
            if name.endswith((".gaf", ".gfa")):
                path = os.path.join(root, name)
                with open(path, "rb") as fh:
                    files[os.path.relpath(path, cwd)] = fh.read()
    return files


def _map(work, name, leg, extra, n_ranks, shard, device, timeout):
    cwd = os.path.join(work, name)
    os.makedirs(cwd)
    argv = [sys.executable, "-m", "vgaligner_tpu_torch", "map", "-i", os.path.join(work, "g"),
            "-f", os.path.join(work, "reads.fa"), "-G", os.path.join(work, "g.gfa"), "-D",
            "-p", leg, *extra, "--device", device, "-t", str(n_ranks), "-o", "out"]
    if shard:
        argv.append("--shard-index")
    t0 = time.monotonic()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [x for x in os.environ.get("PYTHONPATH", "").split(os.pathsep) if x]))
    proc = subprocess.run(argv, cwd=cwd, capture_output=True, text=True, timeout=timeout,
                          env=env)
    wall = time.monotonic() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{name} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    took = re.search(r"Chaining \+ alignment took: (\d+) ms", proc.stderr)
    return cwd, wall, int(took.group(1)) / 1e3


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--reads", type=int, default=12288)
    p.add_argument("--backbone", type=int, default=22600)
    p.add_argument("--timeout", type=float, default=900.0)
    args = p.parse_args(argv)

    import torch

    from .. import cli
    from ..graph import graph_from_gfa
    from ..testing import sample_reads, write_fasta, write_synthetic_gfa

    card = None
    if args.device == "cuda":
        if torch.cuda.device_count() < args.ranks:
            print(f"check: {args.ranks} ranks need {args.ranks} cards, "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 2
        cards = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
        card = f"{len(cards)} x {cards[0]}" if len(set(cards)) == 1 else "; ".join(cards)
        print(card)
    runs, ok = [], True
    with tempfile.TemporaryDirectory(prefix="vg_ranks_check_") as work:
        gfa = os.path.join(work, "g.gfa")
        write_synthetic_gfa(gfa, seed=0, backbone_len=args.backbone)
        write_fasta(os.path.join(work, "reads.fa"),
                    sample_reads(graph_from_gfa(gfa), args.reads, 100, seed=77))
        cli.main(["index", "-i", gfa, "-k", "11", "-o", os.path.join(work, "g")])
        for leg, extra in LEGS:
            want = None
            for n_ranks, shard in ((1, False), (args.ranks, False), (args.ranks, True)):
                name = f"{leg}-t{n_ranks}{'-shard' if shard else ''}"
                cwd, wall, took = _map(work, name, leg, extra, n_ranks, shard, args.device,
                                       args.timeout)
                got = _outputs(cwd)
                want = got if want is None else want
                same = got == want and "out-alignments.gaf" in got
                ok &= same
                runs.append(dict(name=name, ranks=n_ranks, shard_index=shard, wall_s=wall,
                                 map_s=took, reads_per_s=args.reads / took, files=len(got),
                                 identical_to_t1=same))
                print(f"[ranks] {name}: {wall:.2f} s wall, map + align {took:.3f} s "
                      f"({args.reads / took:.1f} reads/s), {len(got)} files, "
                      f"{'identical to -t 1' if same else 'DIFFERS from -t 1'}"
                      + (f" ({card})" if card else ""), flush=True)
    print(json.dumps({"device": args.device, "card": card, "reads": args.reads,
                      "ranks": args.ranks, "ok": ok, "runs": runs}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
