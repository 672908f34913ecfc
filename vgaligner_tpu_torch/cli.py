"""Command-line interface: ``python -m vgaligner_tpu_torch index|map``.

The flags, defaults and quirks are those of ``vgaligner_tpu/cli.py``
(reference: subcommands/cli.yml, index_main.rs, map_main.rs):

  * out-prefix defaults to the input path without its extension;
  * ``--chain-overlap-max`` is parsed and never read;
  * bandwidth 50 is hard-coded at the map call site;
  * ``--also-align`` requires ``-G`` and exports every chain's subgraph
    GFA under ``./subgraphs``.

Added: ``--device {cuda,cpu}`` (default cuda).  The default without a
usable card is an error, never a CPU run.  ``--precision auto`` is exact
on the CPU and fast on CUDA, the JAX CLI's rule.  With ``-p rspoa`` the
aligner writes no subgraph GFAs, as the JAX package's rspoa route does
not.

``-t N`` maps on N devices, one process a device (``resolve_ranks``):
``-t 0`` takes every visible card and ``-t N`` at most N of them;
``--device cpu -t N`` runs N CPU ranks over gloo.  More than one rank
spawns the ranks over a ``file://`` rendezvous in a temporary directory;
each maps and aligns its slice of every batch, rank 0 merges and writes
the GAFs (and prints ``-C`` and validates ``-v``), and each rank writes
the subgraph GFAs of its own reads.  ``--shard-index`` splits the
index's position table over the ranks; with one rank it is a no-op.
``VGALIGNER_TRACE=<dir>`` wraps the run in a ``torch.profiler`` trace,
written on rank 0 as a Chrome trace under ``<dir>``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

log = logging.getLogger("vgaligner")


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vgaligner", description="Aligns reads to a Variation Graph (PyTorch/CUDA)"
    )
    sub = p.add_subparsers(dest="command")

    ip = sub.add_parser("index", help="creates the index")
    ip.add_argument("-i", "--input", required=True, metavar="FILE")
    ip.add_argument("-o", "--output", dest="out_prefix", metavar="STRING")
    ip.add_argument("-k", "--kmer-length", required=True, type=int, metavar="INTEGER")
    ip.add_argument("-e", "--max-furcations", type=int, default=100, metavar="INTEGER")
    ip.add_argument("-m", "--max-degree", type=int, default=100, metavar="INTEGER")
    ip.add_argument("-r", "--sampling-rate", type=int, default=None, metavar="INTEGER")
    ip.add_argument("-g", "--generate-mappings", action="store_true")
    ip.add_argument("-p", "--mappings-path", metavar="FILE")
    ip.add_argument("-t", "--threads", type=int, default=0, metavar="INTEGER")
    ip.add_argument("--n-policy", choices=["drop-kmer", "drop-handle"],
                    default="drop-handle")
    ip.add_argument("--modimizer", choices=["ahash", "code"], default="ahash")
    ip.add_argument("--keep-duplicate-positions", action="store_true")

    mp = sub.add_parser("map", help="map sequences to a graph")
    mp.add_argument("-i", "--index", required=True, metavar="FILE")
    mp.add_argument("-f", "--input-file", required=True, metavar="FILE")
    mp.add_argument("-o", "--out", dest="out_prefix", metavar="STRING")
    mp.add_argument("-g", "--max-gap-length", type=int, default=1000, metavar="INTEGER")
    mp.add_argument("-r", "--max-mismatch-rate", type=float, default=0.1, metavar="FLOAT")
    mp.add_argument("-c", "--chain-overlap-max", type=float, default=None,
                    metavar="FLOAT", help="accepted but unused (reference parity)")
    mp.add_argument("-a", "--chain-min-anchors", type=int, default=3, metavar="INTEGER")
    mp.add_argument("-b", "--align-best-n", type=int, default=1, metavar="INTEGER")
    mp.add_argument("-C", "--write-console", action="store_true")
    mp.add_argument("-D", "--also-align", action="store_true")
    mp.add_argument("-t", "--threads", type=int, default=0, metavar="INTEGER",
                    help="devices to use, one process each: 0 = every visible card "
                         "(1 with --device cpu), N = at most N cards, or N CPU ranks")
    mp.add_argument("-v", "--also-validate", action="store_true")
    mp.add_argument("-G", "--graph", dest="input_graph", metavar="FILE")
    mp.add_argument("-P", "--validation-path", metavar="FILE")
    mp.add_argument("-p", "--poa-aligner", required=True, metavar="ALIGNER_NAME",
                    choices=["rspoa", "abpoa"])
    mp.add_argument("--mapq", action="store_true")
    mp.add_argument("--shard-index", action="store_true",
                    help="offset-shard the position table over the -t ranks (needs -t > 1)")
    mp.add_argument("--range-mode", default=None, choices=("corridor", "id"))
    mp.add_argument("--bubble-closure", action="store_true")
    mp.add_argument("--resume", action="store_true")
    mp.add_argument("--both-strands", action="store_true")
    mp.add_argument("--precision", choices=["auto", "exact", "fast"], default="auto",
                    help="chaining DP arithmetic: 'exact' f64 (the reference's "
                         "bits), 'fast' scaled int32; 'auto' is exact on cpu and "
                         "fast on cuda")
    mp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the array work runs (default cuda; no fallback)")
    return p


def _strip_ext(path: str) -> str:
    for ext in (".gfa", ".fasta", ".fa", ".fastq", ".fq"):
        if path.endswith(ext):
            return path[: -len(ext)]
    return path


def index_main(args) -> None:
    from .graph import graph_from_gfa
    from .index import Index

    out_prefix = args.out_prefix or _strip_ext(args.input)
    Index.build(
        graph_from_gfa(args.input),
        args.kmer_length,
        max_furcations=args.max_furcations,
        max_degree=args.max_degree,
        out_prefix=out_prefix,
        sampling_rate=args.sampling_rate,
        generate_mappings=args.generate_mappings,
        mappings_path=args.mappings_path,
        n_policy=args.n_policy,
        dedup_positions=not args.keep_duplicate_positions,
        modimizer=args.modimizer,
    )


def resolve_ranks(threads: int, device) -> int:
    """The ranks (one process a device) ``map -t threads`` runs, as the
    JAX CLI resolves its mesh: -t 1 is one; on CUDA -t 0 is every visible
    card and -t N at most N of them; on the CPU -t N is N gloo ranks and
    -t 0 is one."""
    import torch

    if threads == 1:
        return 1
    if torch.device(device).type == "cuda":
        n_dev = torch.cuda.device_count()
        use = n_dev if threads == 0 else min(threads, n_dev)
    else:
        use = 1 if threads == 0 else threads
    return max(use, 1)


def map_main(args) -> None:
    from .device import resolve_device

    device = resolve_device(args.device)
    if args.resume and args.also_validate:
        sys.exit("--resume cannot be combined with --also-validate "
                 "(validation needs the full in-memory alignment list)")
    if args.also_align and not args.input_graph:
        sys.exit("--also-align requires -G/--graph (map.rs:155-159)")
    n_ranks = resolve_ranks(args.threads, device)
    if n_ranks == 1:
        _map_run(args, device)
        return
    import tempfile

    import torch.multiprocessing as mp

    from .native import require_native

    require_native()  # build the host runtime once, before the ranks start
    log.info("mapping on %d %s ranks", n_ranks, device.type)
    with tempfile.TemporaryDirectory(prefix="vgaligner-ranks-") as rdv:
        mp.spawn(_rank_main, args=(n_ranks, os.path.join(rdv, "rendezvous"), args),
                 nprocs=n_ranks, join=True)


def _rank_main(rank: int, size: int, rendezvous: str, args) -> None:
    """One spawned rank of ``map -t N``: join the group (NCCL on card
    ``rank``, or gloo on the CPU) and run the map on its slices."""
    import torch
    import torch.distributed as dist

    from .parallel.distributed import TIMEOUT
    from .parallel.mesh import make_mesh

    logging.basicConfig(level=logging.INFO,
                        format=f"%(levelname)s %(name)s[rank {rank}]: %(message)s")
    backend = "gloo"
    if args.device == "cuda":
        torch.cuda.set_device(rank)
        backend = "nccl"
    dist.init_process_group(backend, init_method=f"file://{rendezvous}", rank=rank,
                            world_size=size, timeout=TIMEOUT)
    try:
        mesh = make_mesh(size)
        _map_run(args, mesh.device, mesh)
    finally:
        dist.destroy_process_group()
        sys.stdout.flush()


def _map_run(args, device, mesh=None) -> None:
    """The map on one device; with a mesh, this rank's part of it."""
    import contextlib

    import torch

    from .index import Index
    from .io.fastx import read_seqs_from_file
    from .io.resume import ResumableGafWriter
    from .device import resolve_precision
    from .models.mapper import Mapper
    from .models.poa_aligner import PoaAligner, PoaEngine
    from .models.stream import DEFAULT_BATCH, GafBatch, stream_map_align

    lead = mesh is None or mesh.rank == 0
    idx_path = args.index
    index = Index.load(idx_path) if idx_path.endswith(".idx.npz") \
        else Index.load_from_prefix(idx_path)
    queries = read_seqs_from_file(args.input_file)
    out_prefix = args.out_prefix or _strip_ext(args.input_file)

    precision = resolve_precision(args.precision, device)
    log.info("device %s, precision %s", device, precision)
    mapper = Mapper(index, device, bandwidth=50, max_gap=args.max_gap_length,
                    chain_min_n_anchors=args.chain_min_anchors, mapq=args.mapq,
                    precision=precision, both_strands=args.both_strands, mesh=mesh,
                    shard_index=args.shard_index)

    aligner = graph = None
    if args.also_align:
        from .graph import graph_from_gfa

        graph = graph_from_gfa(args.input_graph)
        aligner = PoaAligner(index, device, engine=PoaEngine(args.poa_aligner),
                             export_subgraphs=True, graph=graph,
                             bubble_closure=args.bubble_closure,
                             range_mode=args.range_mode, mesh=mesh)

    chains_file = out_prefix if out_prefix.endswith(".gaf") else out_prefix + "-chains.gaf"
    align_file = (
        out_prefix if out_prefix.endswith(".gaf") else out_prefix + "-alignments.gaf"
    ) if args.also_align else None
    if align_file == chains_file:
        chains_file = None  # a literal .gaf path names the alignments GAF only
    writer = ResumableGafWriter(out_prefix, chains_file, align_file, resume=args.resume) \
        if lead else None
    skip = writer.skip_reads if lead else 0
    if mesh is not None:
        skip = int(mesh.broadcast(torch.tensor([skip], dtype=torch.int64))[0])
    if skip:
        log.info("Resuming: %d reads already done", skip)
    pending_queries = queries[skip:]

    keep_chains = args.write_console
    keep_alns = args.write_console or args.also_validate
    chains_gaf, alignments = [], []
    n_chains = n_alignments = 0
    t0 = time.monotonic()

    def _on_chains(batch):
        nonlocal n_chains
        if isinstance(batch, GafBatch):  # merged from the ranks
            n_reads, n_rows = batch.n_reads, batch.n_rows
            rows = batch.records() if keep_chains else batch.blob
        else:
            n_reads, n_rows = len(batch), sum(len(c) for c in batch)
            rows = mapper.chains_to_gaf(batch) if keep_chains else mapper.chains_gaf_text(batch)
        n_chains += n_rows
        writer.write_chains(n_reads, rows)
        if keep_chains:
            chains_gaf.extend(rows)

    def _on_alignments(batch):
        nonlocal n_alignments
        if isinstance(batch, GafBatch):
            n_alignments += batch.n_reads
            records = batch.records() if keep_alns else None
            writer.write_alignments(batch.blob, batch.n_reads)
        else:
            n_alignments += len(batch)
            records = batch
            writer.write_alignments(batch)
        if keep_alns:
            alignments.extend(records)

    trace_dir = os.environ.get("VGALIGNER_TRACE") if lead else None
    prof = contextlib.nullcontext()
    if trace_dir:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else []))
    with prof:
        stream_map_align(mapper, pending_queries, aligner, batch_size=DEFAULT_BATCH,
                         align_best_n=args.align_best_n, on_chains=_on_chains,
                         on_alignments=_on_alignments if aligner else None, mesh=mesh)
    if not lead:
        return
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        trace = os.path.join(trace_dir, f"vgaligner-map-{os.getpid()}.pt.trace.json")
        prof.export_chrome_trace(trace)
        log.info("trace written to %s", trace)
    writer.close(done=True)
    log.info("Chaining%s took: %d ms", " + alignment" if aligner else "",
             (time.monotonic() - t0) * 1000)
    log.info("Found %d chains!", n_chains)
    if chains_file is not None:
        log.info("Chains stored correctly in %s!", chains_file)
    if args.write_console:
        for rec in chains_gaf:
            print(rec.to_string(), end="")
    if args.also_align:
        log.info("Found %d alignments!", n_alignments)
        log.info("Alignments stored correctly in %s!", align_file)
        if args.also_validate:
            from .io.validate import create_validation_records, \
                write_validation_to_file

            records = create_validation_records(graph, alignments, queries)
            write_validation_to_file(records, args.validation_path)
            log.info("Validation stored correctly in %s!", args.validation_path)
        if args.write_console:
            for rec in alignments:
                print(rec.to_string(), end="")


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    args = _build_parser().parse_args(argv)
    if args.command == "index":
        index_main(args)
    elif args.command == "map":
        map_main(args)
    else:
        print("Missing subcommand, please add [index|map]")
