"""What the main path's POA chunks ask of the fused DP + traceback kernel.

    python -m vgaligner_tpu_torch.poa_chunk_stats [--reads 12288]
        [--backbone 22600] [--json PATH]

Maps chip_smoke.py's reads (``write_synthetic_gfa`` seed 0, k = 11, 100
bp reads from bench.py's sampler, seed 77) on the CPU, builds the abPOA
engine's POA problem chunks exactly as ``map -p abpoa -D`` does, and
reports them without running the DP: per chunk its shape and the real
problems' vertex counts nv (mean and max), whether every predecessor
precedes its vertex (so that the kernel's all-NEGF sentinel row stands
in for an unwritten row), and how many distinct vertices each problem
reads from farther back than a row ring of 8 and of 16 rows, and so how
many problems overflow the kernel's pinned rows into its backing store.
Everything here is counted on the host; nothing is timed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

K = 11
READ_LEN = 100


def chunk_stats(vpred, nv, n_real: int) -> dict:
    """Figures of one chunk's real problems (numpy vpred [B,V,P], nv [B])."""
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
    return {
        "problems": n_real, "V": V, "P": vp.shape[2],
        "nv_sum": int(nvt.sum()), "nv_max": int(nvt.max()),
        "topological": bool((vp[live] < v_ids.expand_as(vp)[live]).all()),
        "far8_max": int(far8.max()), "far8_sum": int(far8.sum()),
        "far16_max": int(far16.max()),
        "backing_problems": int((PD.backing_rows_plain(vp, nvt) > 0).sum()),
    }


def main(argv=None) -> dict:
    import shutil
    import tempfile

    import torch

    from .graph import graph_from_gfa
    from .index import Index
    from .io.fastx import QuerySequence
    from .models.mapper import Mapper
    from .models.poa_aligner import PoaAligner
    from .ops import poa_device as PD
    from .testing import sample_reads, write_synthetic_gfa

    ap = argparse.ArgumentParser(prog="python -m vgaligner_tpu_torch.poa_chunk_stats")
    ap.add_argument("--reads", type=int, default=12288)
    ap.add_argument("--backbone", type=int, default=22600)
    ap.add_argument("--json", dest="json_path")
    args = ap.parse_args(argv)

    cpu = torch.device("cpu")
    work = tempfile.mkdtemp(prefix="vg_chunk_stats_")
    chunks = []
    real = PD.kernel_dispatch

    def record(chunk, qs, v_pad, l_pad, device):
        vcodes, vpred, _sink, nv, _node_of, _off_in = chunk
        vp = PD._slice_preds(vpred, len(qs))
        chunks.append(dict(chunk_stats(vp, nv, len(qs)), W=l_pad + 1, B=vcodes.shape[0]))

    try:
        gfa = os.path.join(work, "graph.gfa")
        shape = write_synthetic_gfa(gfa, seed=0, backbone_len=args.backbone)
        graph = graph_from_gfa(gfa)
        reads = sample_reads(graph, args.reads, READ_LEN, seed=77)
        index = Index.build(graph, K, 100, 100)
        mapper = Mapper(index, cpu, bandwidth=50, precision="fast")
        chains = mapper.map_reads([QuerySequence(f"read{i}", r) for i, r in enumerate(reads)])
        PD.kernel_dispatch = record
        try:
            PoaAligner(index, cpu).begin_alignments(chains, 1)
        finally:
            PD.kernel_dispatch = real
    finally:
        shutil.rmtree(work, ignore_errors=True)

    problems = sum(c["problems"] for c in chunks)
    out = {
        "graph": shape, "reads": args.reads, "chunks": chunks, "problems": problems,
        "nv_mean": sum(c["nv_sum"] for c in chunks) / max(problems, 1),
        "topological": all(c["topological"] for c in chunks),
        "far8_max": max((c["far8_max"] for c in chunks), default=0),
        "far16_max": max((c["far16_max"] for c in chunks), default=0),
        "backing_problems": sum(c["backing_problems"] for c in chunks),
    }
    for c in chunks:
        print(f"[chunk] B {c['B']} V {c['V']} W {c['W']} P {c['P']}: {c['problems']} problems, "
              f"nv mean {c['nv_sum'] / c['problems']:.1f} max {c['nv_max']}, far vertices "
              f"(ring 8) max {c['far8_max']}, (ring 16) max {c['far16_max']}, "
              f"{c['backing_problems']} over the pins")
    print(f"[total] {len(chunks)} chunks, {problems} problems, mean nv {out['nv_mean']:.2f}; "
          f"every predecessor precedes its vertex: {out['topological']}; far vertices per "
          f"problem, ring 8: max {out['far8_max']}, ring 16: max {out['far16_max']}; "
          f"{out['backing_problems']} problems take the backing store")
    if args.json_path:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_path)), exist_ok=True)
        with open(args.json_path, "w") as fh:
            json.dump(out, fh, indent=1)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
