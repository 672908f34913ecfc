"""What the POA batches of a CLI run ask of the row-ring POA kernels.

    python -m vgaligner_tpu_torch.poa_chunk_stats [--engine abpoa|rspoa]
        [--long] [--reads N] [--backbone 22600] [--json PATH]

Maps chip_smoke.py's reads (``write_synthetic_gfa`` seed 0, k = 11, 100
bp reads from bench.py's sampler, seed 77; with ``--long``, its long
reads: 64 of 1,500-2,100 bp and one of 10 kb, ``testing.long_reads``)
on the CPU and builds the POA problem batches exactly as the CLI does,
without running the DP; ``--reads`` takes the first N of them (12,288
and 65 by default):

  * ``--engine abpoa`` (``map -p abpoa -D``, fast chaining): the
    launches ``kernel_dispatch`` receives, the real problems of each (V,
    L) bucket of each stream batch of 8,192 reads cut into launches under
    the route's byte budget (``global_chunks``), which the fused DP +
    traceback kernels run (poa_dp_tb.cu up to 256 columns,
    poa_dp_tb_cluster.cu at 512-16,384; a subgraph over 8,192 vertices
    takes the host POA and is in no launch), each with its device bytes
    (``global_problem_bytes``);
  * ``--engine rspoa`` (``map -p rspoa -D``, exact chaining): the local
    POA launches ``_dispatch_local_bucket`` makes, the real problems of
    each (V, L) bucket of each stream batch of 8,192 reads cut into
    chunks under the route's byte budget (``local_chunks``), which the
    one-warp local POA kernel (poa_local_warp.cu) runs at rows up to 256
    columns and the cluster one (poa_local_cluster.cu) at 512-8,192, each
    with its device bytes (``local_problem_bytes``).

Per batch it reports the shape and the real problems' vertex counts nv
(mean and max), whether every predecessor precedes its vertex, and how
many distinct vertices each problem reads from farther back than a row
ring of 8 and of 16 rows, and so how many problems overflow the
kernel's pinned rows into its backing store and how many rows they keep
there (a ring of 8 rows and 4 pins, poa_dp_tb.cu's and
poa_dp_tb_cluster.cu's for abPOA, poa_local_warp.cu's and
poa_local_cluster.cu's for rspoa).  Every one of those kernels holds
only the rows the host counts, so a launch's device bytes include its
backing rows, not a plane a vertex.  Everything here is counted on the
host; nothing is timed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

K = 11
READ_LEN = 100


def chunk_stats(vpred, nv, n_real: int, ring: int = 8, pins: int = 4) -> dict:
    """Figures of one batch's real problems (numpy vpred [B,V,P], nv [B]);
    ``backing_problems`` counts those with more far vertices (read from
    more than ``ring`` rows back) than ``pins``."""
    import numpy as np
    import torch

    from .ops import poa_device as PD

    vp = torch.from_numpy(np.ascontiguousarray(vpred[:n_real]))
    nvt = torch.from_numpy(np.ascontiguousarray(nv[:n_real]).astype(np.int32))
    V = vp.shape[1]
    v_ids = torch.arange(V)[None, :, None]
    live = (vp >= 0) & (v_ids < nvt.to(torch.int64)[:, None, None])
    far8 = PD.far_vertices_plain(vp, nvt, 8)
    far16 = PD.far_vertices_plain(vp, nvt, 16)
    backing = PD.backing_rows_plain(vp, nvt, ring, pins)
    return {
        "problems": n_real, "V": V, "P": vp.shape[2],
        "nv_sum": int(nvt.sum()), "nv_max": int(nvt.max()),
        "topological": bool((vp[live] < v_ids.expand_as(vp)[live]).all()),
        "far8_max": int(far8.max()), "far8_sum": int(far8.sum()),
        "far16_max": int(far16.max()),
        "backing_problems": int((backing > 0).sum()),
        "backing_rows_sum": int(backing.sum()), "backing_rows_max": int(backing.max()),
    }


class _Recorded(Exception):
    """Stops ``align_local_batch`` once its buckets are recorded."""


def _record_batches(engine: str, index, chains, batch: int, chunks: list) -> None:
    """Build the engine's POA batches as the CLI does and record each
    one's ``chunk_stats`` in ``chunks``; no DP runs."""
    import torch

    from .models.poa_aligner import PoaAligner, PoaEngine
    from .ops import poa_device as PD

    cpu = torch.device("cpu")
    if engine == "abpoa":
        real = PD.kernel_dispatch

        def record(chunk, qs, v_pad, l_pad, device, back_rows):
            vcodes, vpred, _sink, nv, _node_of, _off_in = chunk
            vp = PD._slice_preds(vpred)
            nbytes = PD.global_problem_bytes(v_pad, l_pad + 1, vp.shape[-1], back_rows)
            chunks.append(dict(chunk_stats(vp, nv, len(qs), PD.TB_RING, PD.TB_PINS),
                               W=l_pad + 1, B=vcodes.shape[0], bytes=int(nbytes.sum())))

        PD.kernel_dispatch = record
        try:
            aligner = PoaAligner(index, cpu)
            for s in range(0, len(chains), batch):
                aligner.begin_alignments(chains[s : s + batch], 1)
        finally:
            PD.kernel_dispatch = real
        return

    real_dispatch, real_decode = PD._dispatch_local_bucket, PD._decode_local_bucket

    def record_local(bgs, qs, v_pad, l_pad, device):
        for s, e, arrs, back in PD.local_chunks(bgs, qs, v_pad, l_pad):
            nbytes = PD.local_problem_bytes(v_pad, l_pad + 1, arrs[1].shape[-1], back)
            chunks.append(dict(chunk_stats(arrs[1], arrs[2], e - s, PD.LOCAL_RING,
                                           PD.LOCAL_PINS), W=l_pad + 1, B=e - s,
                               bytes=int(nbytes.sum())))
        return [(0, len(bgs), ())]

    def stop(*_args):
        raise _Recorded

    PD._dispatch_local_bucket, PD._decode_local_bucket = record_local, stop
    try:
        aligner = PoaAligner(index, cpu, engine=PoaEngine.RSPOA)
        for s in range(0, len(chains), batch):
            try:
                aligner.begin_alignments(chains[s : s + batch], 1)
            except _Recorded:
                pass
    finally:
        PD._dispatch_local_bucket, PD._decode_local_bucket = real_dispatch, real_decode


def main(argv=None) -> dict:
    import shutil
    import tempfile

    import torch

    from .graph import graph_from_gfa
    from .index import Index
    from .io.fastx import QuerySequence
    from .models.mapper import Mapper
    from .models.stream import DEFAULT_BATCH
    from .testing import long_reads, sample_reads, write_synthetic_gfa

    ap = argparse.ArgumentParser(prog="python -m vgaligner_tpu_torch.poa_chunk_stats")
    ap.add_argument("--engine", choices=["abpoa", "rspoa"], default="abpoa")
    ap.add_argument("--long", action="store_true",
                    help="chip_smoke.py's long reads instead of its 100 bp reads")
    ap.add_argument("--reads", type=int, help="the first N reads (default: all 12,288, or 65)")
    ap.add_argument("--backbone", type=int, default=22600)
    ap.add_argument("--json", dest="json_path")
    args = ap.parse_args(argv)

    work = tempfile.mkdtemp(prefix="vg_chunk_stats_")
    chunks: list = []
    try:
        gfa = os.path.join(work, "graph.gfa")
        shape = write_synthetic_gfa(gfa, seed=0, backbone_len=args.backbone)
        graph = graph_from_gfa(gfa)
        if args.long:
            reads = long_reads(graph)[: args.reads]
        else:
            reads = sample_reads(graph, args.reads or 12288, READ_LEN, seed=77)
        index = Index.build(graph, K, 100, 100)
        precision = "fast" if args.engine == "abpoa" else "exact"
        mapper = Mapper(index, torch.device("cpu"), bandwidth=50, precision=precision)
        chains = mapper.map_reads([QuerySequence(f"read{i}", r) for i, r in enumerate(reads)])
        _record_batches(args.engine, index, chains, DEFAULT_BATCH, chunks)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    problems = sum(c["problems"] for c in chunks)
    out = {
        "engine": args.engine, "long": args.long, "graph": shape, "reads": len(reads),
        "chunks": chunks,
        "problems": problems,
        "nv_mean": sum(c["nv_sum"] for c in chunks) / max(problems, 1),
        "topological": all(c["topological"] for c in chunks),
        "far8_max": max((c["far8_max"] for c in chunks), default=0),
        "far16_max": max((c["far16_max"] for c in chunks), default=0),
        "backing_problems": sum(c["backing_problems"] for c in chunks),
        "backing_rows": sum(c["backing_rows_sum"] for c in chunks),
    }
    for c in chunks:
        nbytes = f", {c['bytes']} device bytes" if "bytes" in c else ""
        print(f"[chunk] B {c['B']} V {c['V']} W {c['W']} P {c['P']}{nbytes}: "
              f"{c['problems']} problems, "
              f"nv mean {c['nv_sum'] / c['problems']:.1f} max {c['nv_max']}, far vertices "
              f"(ring 8) max {c['far8_max']} sum {c['far8_sum']}, (ring 16) max "
              f"{c['far16_max']}, {c['backing_problems']} over the pins (backing rows sum "
              f"{c['backing_rows_sum']} max {c['backing_rows_max']}), topological "
              f"{c['topological']}")
    print(f"[total] {args.engine}: {len(chunks)} batches, {problems} problems, mean nv "
          f"{out['nv_mean']:.2f}; every predecessor precedes its vertex: {out['topological']}; "
          f"far vertices per problem, ring 8: max {out['far8_max']}, ring 16: max "
          f"{out['far16_max']}; {out['backing_problems']} problems take the backing store "
          f"({out['backing_rows']} rows)")
    if args.json_path:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_path)), exist_ok=True)
        with open(args.json_path, "w") as fh:
            json.dump(out, fh, indent=1)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
