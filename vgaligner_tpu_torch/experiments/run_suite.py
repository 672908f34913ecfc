"""HLA-zoo validation suite: the Snakemake pipeline as one runner.

Counterpart of ``vgaligner_tpu/experiments/run_suite.py``.  Per dataset
(reference Snakefile:7-151): simulate reads from the graph's embedded
paths with a fixed seed (the vg-sim protocol, seed 77, config.yaml:2),
run index + map + --also-align on ``--device`` (the card by default;
``--device cpu`` runs the plain PyTorch twins), and score every aligned
read's GAF path against the node range of its source window
(gafcompare path Jaccard).  Also records per-phase timings and reads/s.

Usage:
    python -m vgaligner_tpu_torch.experiments.run_suite \
        [--datasets DIR] [--graphs 1-simple,2-DRB1-3123] [--n-reads N]
        [--read-len L] [-k K] [--precision fast|exact] [--poa abpoa|rspoa]
        [--device cuda|cpu] [--out report.json]

``DIR`` holds one directory a dataset with a ``graph.gfa`` in it (the
reference repository's ``experiments-snakemake`` layout, the default,
relative to the working directory); with no dataset found it exits 2.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
import traceback
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..device import resolve_device

log = logging.getLogger(__name__)

DEFAULT_DATASETS = "experiments-snakemake"


@dataclass
class DatasetReport:
    name: str
    n_nodes: int
    seq_len: int
    n_kmers: int
    n_reads: int
    index_build_s: float
    map_s: float
    align_s: float
    reads_found: int
    avg_jaccard: float
    exact_rate: float
    map_align_rps: float


def simulate_reads(graph, n: int, read_len: int, seed: int = 77, orient: str = "forward"):
    """Path-window read sampler (vg sim analog, Snakefile:25-32) ->
    (reads [(name, seq)], truth {name: SIGNED node ids of the window}).

    ``orient`` "as-path" emits each window as its path spells it (the
    vg-sim protocol: windows on reverse steps are reverse-strand reads,
    which the forward-only anchor path cannot map, map.rs:62);
    "forward" reverse-complements windows lying wholly on reverse steps
    and flips their truth, so every read is forward-strand."""
    from ..graph.handlegraph import handle_id, handle_is_reverse
    from ..utils.dna import reverse_complement

    rng = np.random.default_rng(seed)
    all_paths = []
    for pid in graph.paths_iter():
        nodes = graph.get_path(pid).nodes
        seq = "".join(graph.sequence(h) for h in nodes)
        starts = np.cumsum([0] + [len(graph.sequence(h)) for h in nodes])
        all_paths.append((nodes, seq, starts))
    if not all_paths:
        raise ValueError("graph has no embedded paths to sample from")
    read_len = min(read_len, max(len(seq) for _, seq, _ in all_paths))
    paths = [p for p in all_paths if len(p[1]) >= read_len]

    reads: List[Tuple[str, str]] = []
    truth: Dict[str, List[int]] = {}
    for i in range(n):
        nodes, seq, starts = paths[int(rng.integers(len(paths)))]
        start = int(rng.integers(0, max(len(seq) - read_len, 1)))
        end = start + read_len
        name = f"r{i}"
        window = seq[start:end]
        lo = int(np.searchsorted(starts, start, side="right")) - 1
        hi = int(np.searchsorted(starts, end, side="left"))
        steps = nodes[lo:hi]
        ids = [-handle_id(h) if handle_is_reverse(h) else handle_id(h) for h in steps]
        if orient == "forward" and steps and all(handle_is_reverse(h) for h in steps):
            window = reverse_complement(window)
            ids = [-x for x in reversed(ids)]
        reads.append((name, window))
        truth[name] = ids
    return reads, truth


def run_dataset(gfa_path: str, name: str, n_reads: int, read_len: int, k: int,
                precision: str, poa_engine: str = "abpoa", sim_orient: str = "forward",
                both_strands: bool = False, device=None) -> DatasetReport:
    """One dataset through index, map and align on ``device`` (the card
    when None), scored against the simulated reads' windows."""
    from ..graph import graph_from_gfa
    from ..index import Index
    from ..io.fastx import QuerySequence
    from ..models.mapper import Mapper
    from ..models.poa_aligner import PoaAligner, PoaEngine
    from .gafcompare import compare_paths, signed_ids

    graph = graph_from_gfa(gfa_path)
    t0 = time.monotonic()
    index = Index.build(graph, k, 100, 100)
    index_build_s = time.monotonic() - t0

    reads, truth = simulate_reads(graph, n_reads, read_len, orient=sim_orient)
    queries = [QuerySequence.from_name_and_string(n, s) for n, s in reads]

    mapper = Mapper(index, device, chain_min_n_anchors=3, precision=precision,
                    both_strands=both_strands)
    aligner = PoaAligner(index, device, engine=PoaEngine(poa_engine))
    # a full-shape warm-up, so the timings below leave out kernel builds
    # and first-launch costs
    aligner.best_alignments_for_queries(mapper.map_reads(queries))

    t0 = time.monotonic()
    chains = mapper.map_reads(queries)
    map_s = time.monotonic() - t0

    t0 = time.monotonic()
    alignments = aligner.best_alignments_for_queries(chains)
    align_s = time.monotonic() - t0

    query_paths: Dict[str, List[int]] = {}
    for aln in alignments:
        if aln.path_matching and aln.path_matching != "*":
            query_paths[aln.query_name] = signed_ids(aln.path_matching)
    res = compare_paths(query_paths, truth)

    return DatasetReport(
        name=name,
        n_nodes=graph.n_nodes,
        seq_len=index.seq_length,
        n_kmers=index.n_kmers,
        n_reads=len(queries),
        index_build_s=round(index_build_s, 3),
        map_s=round(map_s, 3),
        align_s=round(align_s, 3),
        reads_found=res.reads_found,
        avg_jaccard=round(res.avg_jaccard, 4),
        exact_rate=round(res.exact_rate, 4),
        map_align_rps=round(len(queries) / max(map_s + align_s, 1e-9), 1),
    )


def discover_datasets(datasets_dir: str) -> List[Tuple[str, str]]:
    """(name, graph.gfa path) of each dataset directory, by name."""
    out = []
    if not os.path.isdir(datasets_dir):
        return out
    for entry in sorted(os.listdir(datasets_dir)):
        gfa = os.path.join(datasets_dir, entry, "graph.gfa")
        if os.path.exists(gfa):
            out.append((entry, gfa))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="HLA-zoo validation suite")
    ap.add_argument("--datasets", default=DEFAULT_DATASETS)
    ap.add_argument("--graphs", default=None,
                    help="comma-separated dataset names (default: all)")
    ap.add_argument("--n-reads", type=int, default=512)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("-k", "--kmer-length", type=int, default=11)
    ap.add_argument("--precision", default="fast", choices=("fast", "exact"))
    ap.add_argument("--sim-orient", default="forward", choices=("forward", "as-path"),
                    help="read orientation model (as-path = strict vg-sim protocol)")
    ap.add_argument("--both-strands", action="store_true",
                    help="map each read's revcomp too and keep the better strand "
                         "(pair with --sim-orient as-path)")
    ap.add_argument("--poa", default="abpoa", choices=("abpoa", "rspoa"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default) needs a card; cpu runs the plain PyTorch path")
    ap.add_argument("--out", default=None, help="write JSON report here")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.WARNING)
    device = resolve_device(args.device)
    datasets = discover_datasets(args.datasets)
    if args.graphs:
        keep = set(args.graphs.split(","))
        datasets = [(n, p) for n, p in datasets if n in keep]
    if not datasets:
        print("no datasets found", file=sys.stderr)
        return 2

    reports: List[DatasetReport] = []
    print(f"{'dataset':<22} {'nodes':>6} {'kmers':>8} {'reads':>6} "
          f"{'idx_s':>6} {'map_s':>6} {'aln_s':>6} {'found':>6} "
          f"{'jacc':>7} {'exact':>7} {'r/s':>8}")
    for name, gfa in datasets:
        try:
            r = run_dataset(gfa, name, args.n_reads, args.read_len, args.kmer_length,
                            args.precision, args.poa, args.sim_orient, args.both_strands,
                            device)
        except Exception as exc:  # keep going like snakemake -k
            traceback.print_exc()
            print(f"{name:<22} FAILED: {exc}")
            continue
        reports.append(r)
        print(f"{r.name:<22} {r.n_nodes:>6} {r.n_kmers:>8} {r.n_reads:>6} "
              f"{r.index_build_s:>6.2f} {r.map_s:>6.2f} {r.align_s:>6.2f} "
              f"{r.reads_found:>6} {r.avg_jaccard:>7.4f} {r.exact_rate:>7.4f} "
              f"{r.map_align_rps:>8.1f}")

    if reports:
        total_reads = sum(r.n_reads for r in reports)
        avg_j = sum(r.avg_jaccard * r.n_reads for r in reports) / total_reads
        print(f"\nsuite: {len(reports)} graphs, {total_reads} reads, "
              f"weighted avg jaccard {avg_j:.4f} on {device}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump([asdict(r) for r in reports], fh, indent=2)
        print(f"report written to {args.out}")
    return 0 if reports else 1


if __name__ == "__main__":
    sys.exit(main())
