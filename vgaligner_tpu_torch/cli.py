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
on the CPU and fast on CUDA, the JAX CLI's rule.  What the port does not
run yet fails loudly: ``-t`` > 1, ``--shard-index`` and
``VGALIGNER_TRACE`` (ROADMAP A12).  With ``-p rspoa`` the aligner writes
no subgraph GFAs, as the JAX package's rspoa route does not.
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
                    help="devices to use; one device only so far (ROADMAP A12)")
    mp.add_argument("-v", "--also-validate", action="store_true")
    mp.add_argument("-G", "--graph", dest="input_graph", metavar="FILE")
    mp.add_argument("-P", "--validation-path", metavar="FILE")
    mp.add_argument("-p", "--poa-aligner", required=True, metavar="ALIGNER_NAME",
                    choices=["rspoa", "abpoa"])
    mp.add_argument("--mapq", action="store_true")
    mp.add_argument("--shard-index", action="store_true",
                    help="offset-shard the position table (not ported: ROADMAP A12)")
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


def _refuse_unported(args) -> None:
    if args.threads > 1:
        raise NotImplementedError("-t > 1 (multi-GPU) is not ported yet (ROADMAP A12)")
    if args.shard_index:
        raise NotImplementedError("--shard-index is not ported yet (ROADMAP A12)")
    if os.environ.get("VGALIGNER_TRACE"):
        raise NotImplementedError("VGALIGNER_TRACE is not ported yet (ROADMAP A12)")


def map_main(args) -> None:
    from .index import Index
    from .io.fastx import read_seqs_from_file
    from .io.resume import ResumableGafWriter
    from .device import resolve_device, resolve_precision
    from .models.mapper import Mapper
    from .models.poa_aligner import PoaAligner, PoaEngine
    from .models.stream import DEFAULT_BATCH, stream_map_align

    _refuse_unported(args)
    device = resolve_device(args.device)
    if args.resume and args.also_validate:
        sys.exit("--resume cannot be combined with --also-validate "
                 "(validation needs the full in-memory alignment list)")

    idx_path = args.index
    index = Index.load(idx_path) if idx_path.endswith(".idx.npz") \
        else Index.load_from_prefix(idx_path)
    queries = read_seqs_from_file(args.input_file)
    out_prefix = args.out_prefix or _strip_ext(args.input_file)

    precision = resolve_precision(args.precision, device)
    log.info("device %s, precision %s", device, precision)
    mapper = Mapper(index, device, bandwidth=50, max_gap=args.max_gap_length,
                    chain_min_n_anchors=args.chain_min_anchors, mapq=args.mapq,
                    precision=precision, both_strands=args.both_strands)

    aligner = graph = None
    if args.also_align:
        if not args.input_graph:
            sys.exit("--also-align requires -G/--graph (map.rs:155-159)")
        from .graph import graph_from_gfa

        graph = graph_from_gfa(args.input_graph)
        aligner = PoaAligner(index, device, engine=PoaEngine(args.poa_aligner),
                             export_subgraphs=True, graph=graph,
                             bubble_closure=args.bubble_closure,
                             range_mode=args.range_mode)

    chains_file = out_prefix if out_prefix.endswith(".gaf") else out_prefix + "-chains.gaf"
    align_file = (
        out_prefix if out_prefix.endswith(".gaf") else out_prefix + "-alignments.gaf"
    ) if args.also_align else None
    if align_file == chains_file:
        chains_file = None  # a literal .gaf path names the alignments GAF only
    writer = ResumableGafWriter(out_prefix, chains_file, align_file, resume=args.resume)
    if writer.skip_reads:
        log.info("Resuming: %d reads already done", writer.skip_reads)
    pending_queries = queries[writer.skip_reads :]

    keep_chains = args.write_console
    keep_alns = args.write_console or args.also_validate
    chains_gaf, alignments = [], []
    n_chains = n_alignments = 0
    t0 = time.monotonic()

    def _on_chains(batch_chains):
        nonlocal n_chains
        n_chains += sum(len(c) for c in batch_chains)
        if keep_chains:
            recs = mapper.chains_to_gaf(batch_chains)
            writer.write_chains(len(batch_chains), recs)
            chains_gaf.extend(recs)
        else:
            writer.write_chains(len(batch_chains), mapper.chains_gaf_text(batch_chains))

    def _on_alignments(batch_alns):
        nonlocal n_alignments
        n_alignments += len(batch_alns)
        writer.write_alignments(batch_alns)
        if keep_alns:
            alignments.extend(batch_alns)

    stream_map_align(mapper, pending_queries, aligner, batch_size=DEFAULT_BATCH,
                     align_best_n=args.align_best_n, on_chains=_on_chains,
                     on_alignments=_on_alignments if aligner else None)
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
