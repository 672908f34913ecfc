"""Seeded synthetic variation graphs and reads (test and smoke fixture).

``write_synthetic_gfa`` writes a GFA1 file (S, L and P lines) shaped like
the HLA-zoo graphs the reference's experiments use, e.g. bench.py's
2-DRB1-3123 (4,792 nodes, about 22.6 kb of sequence): a random backbone
cut by SNP bubbles (two one-base alleles) and indel bubbles (a 1-6 bp
allele with a skip edge), with node ids in topological order and
haplotype P-lines that each pick alleles.  The defaults give that size;
tests pass a short backbone.

``sample_reads`` is bench.py's path-window read sampler (seed 77): each
read is a window of a random haplotype path at a random offset.  It can
add substitutions, N bases and reverse complements to exercise more of
the aligner.

``run_ranks`` runs one of this module's rank jobs (``rank_map_job``,
``rank_resume_job``) on N CPU ranks over gloo, one spawned process a
rank, the way ``map -t N --device cpu`` runs them; every child imports
its job from here.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

_BASES = "ACGT"
_COMP = str.maketrans("ACGTN", "TGCAN")


def _rand_seq(rng, n: int) -> str:
    return "".join(_BASES[c] for c in rng.integers(0, 4, n))


def write_synthetic_gfa(path: str, seed: int = 0, backbone_len: int = 22600,
                        mean_spacing: float = 10.0, snp_frac: float = 0.55,
                        n_haplotypes: int = 12, alt_freq: float = 0.35) -> dict:
    """Write the graph and return its shape (nodes, edges, paths, bp)."""
    rng = np.random.default_rng(seed)
    backbone = _rand_seq(rng, backbone_len)
    nodes: List[str] = []
    edges: List[tuple] = []
    # flank segment -> (ref allele id, alt allele id or None for a
    # deletion); node ids follow the backbone, so they are topological
    sites = {}
    pos = 0
    prev_tail: List[int] = []  # nodes whose out-edges go to the next node

    def add_node(seq: str) -> int:
        nodes.append(seq)
        nid = len(nodes)
        for t in prev_tail:
            edges.append((t, nid))
        return nid

    segments: List[int] = []
    while pos < backbone_len:
        seg_end = min(backbone_len, pos + max(1, int(rng.geometric(1.0 / mean_spacing))))
        seg = add_node(backbone[pos:seg_end])
        segments.append(seg)
        prev_tail = [seg]
        pos = seg_end
        if pos >= backbone_len - 8:
            continue
        if rng.random() < snp_frac:
            ref_base = backbone[pos]
            alt_base = _BASES[(_BASES.index(ref_base) + int(rng.integers(1, 4))) % 4]
            ref = add_node(ref_base)
            alt = add_node(alt_base)
            sites[seg] = (ref, alt)
            prev_tail = [ref, alt]
            pos += 1
        else:
            ln = int(rng.integers(1, 7))
            ref = add_node(backbone[pos : pos + ln])
            sites[seg] = (ref, None)
            prev_tail = [ref, seg]  # the skip edge leaves the flank segment
            pos += ln
    segments.append(add_node(_rand_seq(rng, 8)))

    haps = []
    for _ in range(n_haplotypes):
        steps = []
        for seg in segments:
            steps.append(seg)
            if seg in sites:
                ref, alt = sites[seg]
                if rng.random() >= alt_freq:
                    steps.append(ref)
                elif alt is not None:
                    steps.append(alt)
        haps.append(steps)

    with open(path, "w") as fh:
        fh.write("H\tVN:Z:1.0\n")
        for i, s in enumerate(nodes, start=1):
            fh.write(f"S\t{i}\t{s}\n")
        for a, b in edges:
            fh.write(f"L\t{a}\t+\t{b}\t+\t0M\n")
        for h, steps in enumerate(haps):
            fh.write(f"P\thap{h}\t{','.join(f'{n}+' for n in steps)}\t*\n")
    return {"nodes": len(nodes), "edges": len(edges), "paths": len(haps),
            "bp": sum(len(s) for s in nodes)}


def sample_reads(graph, n: int, read_len: int = 100, seed: int = 77,
                 sub_rate: float = 0.0, n_rate: float = 0.0,
                 revcomp_frac: float = 0.0, err_seed: Optional[int] = None) -> List[str]:
    """bench.py's path-window sampler, with optional read errors."""
    rng = np.random.default_rng(seed)
    path_seqs = []
    for pid in graph.paths_iter():
        seq = "".join(graph.sequence(h) for h in graph.get_path(pid).nodes)
        if len(seq) >= read_len:
            path_seqs.append(seq)
    if not path_seqs:
        path_seqs = ["".join(graph.sequence(h) for h in graph.handles())]
    reads = []
    for _ in range(n):
        seq = path_seqs[int(rng.integers(len(path_seqs)))]
        start = int(rng.integers(0, max(len(seq) - read_len, 1)))
        reads.append(seq[start : start + read_len])
    if sub_rate or n_rate or revcomp_frac:
        erng = np.random.default_rng(seed + 1 if err_seed is None else err_seed)
        out = []
        for r in reads:
            s = list(r)
            for i in range(len(s)):
                x = erng.random()
                if x < sub_rate:
                    s[i] = _BASES[int(erng.integers(0, 4))]
                elif x < sub_rate + n_rate:
                    s[i] = "N"
            r = "".join(s)
            if erng.random() < revcomp_frac:
                r = r.translate(_COMP)[::-1]
            out.append(r)
        reads = out
    return reads


def long_reads(graph, n_long: int = 64, seed: int = 3) -> List[str]:
    """The long reads chip_smoke.py maps: ``n_long`` reads of 1,500-2,100
    bp, then one of 10 kb, each a path window from ``sample_reads`` with
    1 % substitutions."""
    rng = np.random.default_rng(seed)
    lens = [int(x) for x in rng.integers(1500, 2101, n_long)] + [10000]
    return [sample_reads(graph, 1, n, seed=1000 + i, sub_rate=0.01)[0]
            for i, n in enumerate(lens)]


# (window bp, query bp) of ``wide_route_problems``: subgraphs of about
# 1,000-8,000 base vertices (V pads 1,024 to 8,192), queries of 8.3-14 kb
WIDE_SHAPES = ((1000, 8300), (3500, 9000), (5000, 10500), (6500, 12000), (7200, 14000))


def _path_window(graph, rng, window_bp: int):
    """The node ids of a window of whole nodes, at least ``window_bp``
    long, of a random haplotype path."""
    from .graph.handlegraph import handle_id

    paths = [graph.get_path(p).nodes for p in graph.paths_iter()]
    steps = paths[int(rng.integers(len(paths)))]
    lens = np.cumsum([len(graph.sequence(h)) for h in steps])
    last = int(np.searchsorted(lens, lens[-1] - window_bp, side="right"))
    start = int(rng.integers(0, max(last, 1)))
    base = lens[start - 1] if start else 0
    end = int(np.searchsorted(lens, base + window_bp, side="left")) + 1
    return [handle_id(h) for h in steps[start:end]]


def wide_route_problems(graph, shapes=WIDE_SHAPES, seed: int = 21) -> list:
    """(nodes, edges, query) problems whose POA rows are 16,384 columns
    wide and whose subgraph is under the device routes' cap of 8,192
    base vertices: each subgraph is every node whose id lies between the
    first and the last node of a haplotype path window (ids are
    topological, so each bubble's other allele comes too) with the edges
    among them, and each query is the window's sequence with a random
    stretch inserted in its middle, 8,192-16,383 bp in all."""
    from .graph.handlegraph import handle_id, handle_pack

    out = []
    for i, (window_bp, query_bp) in enumerate(shapes):
        rng = np.random.default_rng(seed + i)
        ids = _path_window(graph, rng, window_bp)
        lo, hi = min(ids), max(ids)
        nodes = [graph.sequence(handle_pack(n, False)) for n in range(lo, hi + 1)]
        edges = [(handle_id(a) - lo, handle_id(b) - lo) for a, b in graph.edges()
                 if lo <= handle_id(a) <= hi and lo <= handle_id(b) <= hi]
        win = "".join(graph.sequence(handle_pack(n, False)) for n in ids)
        k = len(win) // 2
        query = win[:k] + _rand_seq(rng, query_bp - len(win)) + win[k:]
        if sum(len(x) for x in nodes) > 8192 or not 8192 <= len(query) <= 16383:
            raise ValueError(f"shape {(window_bp, query_bp)} misses 16,384 columns under the cap")
        out.append((nodes, edges, query))
    return out


def wide_reads(graph, seed: int = 31) -> List[str]:
    """Reads made as ``wide_route_problems``' queries are, for the CLI: a
    path window of 3 kb from ``sample_reads`` with a random stretch
    inserted at its end or its middle, 8.4 kb in all.  The mapper's
    corridor subgraph of such a read is about the read's length, so
    whether it lands under the 8,192-vertex cap (POA rows of 16,384
    columns on the card) or on the host POA depends on where its chain
    lies: on the synthetic graph of seed 0 the first lands over it (9,885
    base vertices), the second under it (8,185)."""
    out = []
    for i, (window_bp, read_bp, where) in enumerate(((3000, 8400, 1.0), (3000, 8400, 0.5))):
        rng = np.random.default_rng(seed + i)
        win = sample_reads(graph, 1, window_bp, seed=300 + 2 * i)[0]
        k = int(len(win) * where)
        out.append(win[:k] + _rand_seq(rng, read_bp - window_bp) + win[k:])
    return out


def one_torch_thread():
    """Generator for a pytest fixture: torch on one intra-op thread while
    it is active.  Test tensors are tiny, and parallel test workers that
    each start a thread per core oversubscribe the machine many times."""
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def write_fasta(path: str, reads: List[str]) -> None:
    """Reads as FASTA records named read0, read1, ..."""
    with open(path, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f">read{i}\n{r}\n")


def random_poa_batch(seed: int, B: int, V: int, P: int, L: int,
                     n_frac: float = 0.03, far_frac: float = 0.2, min_nv: Optional[int] = None):
    """Random padded POA problems in topological order, the layout the
    native builder gives the DP: vcodes [B,V] int8 (4 = N/pad), vpred
    [B,V,P] int32 (-1 dead), is_sink [B,V] uint8, nv [B] int32, q [B,L]
    int8, nq [B] int32.  Vertices without predecessors restart from the
    virtual source, a few edges reach far back, and every vertex without
    a successor is a sink, so most problems have several sinks.  A
    problem's nv is drawn from [``min_nv``, V], by default [V // 2, V]."""
    rng = np.random.default_rng(seed)
    vcodes = rng.integers(0, 4, (B, V)).astype(np.int8)
    vcodes[rng.random((B, V)) < n_frac] = 4
    vpred = np.full((B, V, P), -1, dtype=np.int32)
    is_sink = np.zeros((B, V), dtype=np.uint8)
    nv = rng.integers(max(1, V // 2) if min_nv is None else min_nv, V + 1, B).astype(np.int32)
    for b in range(B):
        n = int(nv[b])
        vcodes[b, n:] = 4
        has_succ = np.zeros(n, dtype=bool)
        fans = np.minimum(rng.choice(np.arange(P + 1), size=n,
                                     p=_fan_probs(P)), np.arange(n))
        for v in range(1, n):
            cands = set()
            while len(cands) < fans[v]:
                if rng.random() < far_frac:
                    cands.add(int(rng.integers(0, v)))
                else:
                    cands.add(max(0, v - 1 - int(rng.integers(0, 8))))
            ps = list(cands)
            rng.shuffle(ps)
            vpred[b, v, : len(ps)] = ps
            has_succ[ps] = True
        is_sink[b, :n] = ~has_succ
    q = rng.integers(0, 4, (B, L)).astype(np.int8)
    q[rng.random((B, L)) < n_frac] = 4
    nq = rng.integers(max(1, L // 2), L + 1, B).astype(np.int32)
    for b in range(B):
        q[b, nq[b]:] = 4
    return vcodes, vpred, is_sink, nv, q, nq


def _fan_probs(P: int) -> np.ndarray:
    """Fan-in distribution: mostly 1, some 2+, a few pred-less vertices."""
    w = np.array([0.05, 0.7] + [0.25 / (P - 1)] * (P - 1))
    return w / w.sum()


def random_local_batch(seed: int, B: int, V: int, P: int, L: int, far_frac: float = 0.2,
                       min_nv: Optional[int] = None):
    """Local POA problems (vcodes, vpred, nv, q, nq) from
    ``random_poa_batch`` (nv drawn from [``min_nv``, V]) with long local
    matches: each query but problem 0's holds a walk back along first
    predecessors with 5 % of its codes changed, at a random offset;
    problem 0's query is all N, so it has no positive cell."""
    vcodes, vpred, _sink, nv, q, nq = random_poa_batch(seed, B, V, P, L, far_frac=far_frac,
                                                       min_nv=min_nv)
    rng = np.random.default_rng(seed)
    for b in range(1, B):
        v, walk = int(rng.integers(nv[b] // 2, nv[b])), []
        while v >= 0 and len(walk) < nq[b]:
            walk.append(int(vcodes[b, v]))
            v = int(vpred[b, v, 0])
        codes = np.asarray(walk[::-1], dtype=np.int8)
        mut = rng.random(len(codes)) < 0.05
        codes[mut] = rng.integers(0, 5, int(mut.sum()))
        off = int(rng.integers(0, nq[b] - len(codes) + 1))
        q[b, off : off + len(codes)] = codes
    q[0] = 4
    return vcodes, vpred, nv, q, nq


def far_jump_local_batch(W: int, boundary: int, V: int, seed: int = 0):
    """Two local POA problems (vcodes, vpred, nv, q, nq; P 2) on a chain
    of V vertices whose best match run takes a far edge exactly where a
    row slice of ``boundary`` columns starts: the query matches vertices
    0..boundary-2 (its last match at column boundary - 1), then vertex u =
    boundary + 28 and the chain after it, and u's second predecessor is
    f = boundary - 2, 30 rows back.  In problem 0 four smaller vertices
    are read from far back too (v <- v - 30 for v = 40, 42, 44, 46),
    so f is the fifth far vertex and goes to the backing store; in
    problem 1 it is the only one, and pinned."""
    rng = np.random.default_rng(seed)
    L = W - 1
    f, u = boundary - 2, boundary + 28
    if boundary < 20 or u >= V or u + 1 > L:
        raise ValueError("the far jump needs 20 <= boundary < V - 28")
    seq = rng.integers(0, 4, V).astype(np.int8)
    vcodes = np.stack([seq, seq])
    vpred = np.full((2, V, 2), -1, dtype=np.int32)
    vpred[:, 1:, 0] = np.arange(V - 1)
    vpred[:, u, 1] = f
    for v in (40, 42, 44, 46):
        vpred[0, v, 1] = v - 30
    run = np.concatenate([seq[: boundary - 1], seq[u:]])[:L]
    q = rng.integers(0, 4, (2, L)).astype(np.int8)
    q[:, : len(run)] = run
    nv = np.full(2, V, dtype=np.int32)
    nq = np.full(2, L, dtype=np.int32)
    return vcodes, vpred, nv, q, nq


def far_rows_local_batch(V: int, W: int, seed: int = 0):
    """Two local POA problems (vcodes, vpred, nv, q, nq; P 2) on a chain
    of V vertices whose best match run takes a far edge in the last
    bitmap words: the query matches the 100 vertices up to f = V - 140,
    then u = f + 30 and the chain after it, and u's second predecessor is
    f.  In problem 0 every 37th vertex from 40 on, and 51, 52, 83 and 84,
    also read the vertex 20 rows back, so far vertices straddle the
    bitmap words at 31/32 and 63/64 and f's backing row ranks behind
    every one of them; in problem 1 f is the only far vertex, and pinned."""
    rng = np.random.default_rng(seed)
    L = W - 1
    f = V - 140
    u = f + 30
    if f < 100 or W < 201:
        raise ValueError("the far rows need V >= 240 and W >= 201")
    seq = rng.integers(0, 4, V).astype(np.int8)
    vcodes = np.stack([seq, seq])
    vpred = np.full((2, V, 2), -1, dtype=np.int32)
    vpred[:, 1:, 0] = np.arange(V - 1)
    for v in sorted({*range(40, V, 37), 51, 52, 83, 84} - {u}):
        vpred[0, v, 1] = v - 20
    vpred[:, u, 1] = f
    run = np.concatenate([seq[f - 99 : f + 1], seq[u : u + 100]])
    q = rng.integers(0, 4, (2, L)).astype(np.int8)
    q[:, : len(run)] = run
    nv = np.full(2, V, dtype=np.int32)
    nq = np.full(2, L, dtype=np.int32)
    return vcodes, vpred, nv, q, nq


def with_poa_edge_cases(arrs, empty: bool = True):
    """A global POA batch (``random_poa_batch``'s six arrays, at least 4
    problems of nv >= 8) with the rows a kernel that stops at each
    problem's own nv must get right: problem 1 reads a predecessor at its
    vertex and one past it, problem 2 has nv far below V (4 rows, vertex 3
    a sink) and, with ``empty``, problem 3 none at all (whose walk reads
    rows past its nv, which only the plain version computes)."""
    vcodes, vpred, is_sink, nv, q, nq = (np.array(a, copy=True) for a in arrs)
    v = int(nv[1]) // 2
    vpred[1, v, 0] = v
    vpred[1, v + 1, vpred.shape[2] - 1] = v + 3 if v + 3 < nv[1] else v + 1
    nv[2] = 4
    vcodes[2, 4:] = 4
    vpred[2, 4:] = -1
    is_sink[2, 4:] = 0
    is_sink[2, 3] = 1
    if empty:
        nv[3] = 0
        vcodes[3] = 4
        vpred[3] = -1
        is_sink[3] = 0
    return vcodes, vpred, is_sink, nv, q, nq


def with_local_edge_cases(arrs):
    """A local POA batch (at least 4 problems of nv >= 8) with the rows a
    kernel that stops at each problem's own nv must get right: problem 1
    reads a predecessor at its vertex and one past it, problem 2 has nv
    far below V (4 rows) and problem 3 none at all."""
    vcodes, vpred, nv, q, nq = arrs
    vcodes, vpred, _sink, nv, q, nq = with_poa_edge_cases(
        (vcodes, vpred, np.zeros(vcodes.shape, np.uint8), nv, q, nq))
    return vcodes, vpred, nv, q, nq


def run_ranks(job: str, size: int, workdir: str, *args, timeout: float = 240.0) -> list:
    """``job(mesh, *args)`` (a function of this module, by name) on
    ``size`` CPU ranks, each a spawned process in one gloo group over a
    ``file://`` rendezvous under ``workdir``: the ranks' results in rank
    order.  A rank's error, or no result within ``timeout`` seconds,
    stops every rank and raises."""
    import multiprocessing
    import queue
    import tempfile
    import time

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    rdv = os.path.join(tempfile.mkdtemp(prefix="ranks-", dir=workdir), "rendezvous")
    procs = [ctx.Process(target=_rank_entry, args=(job, r, size, rdv, args, results))
             for r in range(size)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + timeout
    try:
        while len(got) < size:  # drain the queue before joining its writers
            try:
                rank, ok, value = results.get(timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                raise TimeoutError(f"{job} on {size} ranks: no result from ranks "
                                   f"{sorted(set(range(size)) - set(got))} in {timeout} s")
            if not ok:
                raise RuntimeError(f"{job} failed on rank {rank}:\n{value}")
            got[rank] = value
    finally:
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5.0) if len(got) == size else 0.1)
            if p.is_alive():
                p.terminate()
                p.join()
    return [got[r] for r in range(size)]


def _rank_entry(job: str, rank: int, size: int, rendezvous: str, args, results) -> None:
    """A spawned rank of ``run_ranks``."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    from .parallel.mesh import make_mesh

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                                world_size=size, timeout=datetime.timedelta(seconds=120))
        try:
            results.put((rank, True, globals()[job](make_mesh(size), *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def _named_reads(reads):
    from .io.fastx import QuerySequence

    return [QuerySequence(name=f"read{i}", seq=s) for i, s in enumerate(reads)]


def rank_map_job(mesh, gfa: str, runs: list, gather_rows=None, merge_out=None) -> dict:
    """A rank's part of the sharded-map tests on the graph ``gfa`` (k 11):

      * ``shard``: this rank's rows of the offset-sharded position table;
      * ``gathered``: the sharded position gather of ``gather_rows[rank]``;
      * ``runs``: for each dict of ``reads``, ``mapper`` keywords and an
        optional ``engine`` (abpoa/rspoa), ``stream_map_align`` over the
        mesh at ``batch_size`` (default 8,192), giving the merged chains
        and alignments GAF on rank 0 (b"" elsewhere), the reads this rank
        sent to the host overflow route, and the collectives counted;
      * with ``merge_out``, ``merge_gaf_shards`` of this rank's slice of
        the first run's chains, written there by rank 0.
    """
    import torch

    from .graph import graph_from_gfa
    from .index import Index
    from .index.device_index import device_index
    from .models.mapper import Mapper
    from .models.poa_aligner import PoaAligner, PoaEngine
    from .models.stream import stream_map_align
    from .parallel import collective_counts, place_index, reset_collective_counts, shard_batch
    from .parallel.distributed import merge_gaf_shards

    graph = graph_from_gfa(gfa)
    index = Index.build(graph, 11, 100, 100)
    dindex = place_index(mesh, device_index(index, torch.device("cpu")), shard_positions=True)
    out = dict(shard=(dindex.fo_start.numpy(), dindex.fo_end.numpy()), runs=[])
    if gather_rows is not None:
        m = Mapper(index, mesh=mesh, shard_index=True)
        tb, te = m._sharded_gather(torch.from_numpy(gather_rows[mesh.rank]), None)
        out["gathered"] = (tb.numpy(), te.numpy())
    for run in runs:
        mapper = Mapper(index, mesh=mesh, **run["mapper"])
        overflow = []
        real_overflow = mapper._map_read_overflow

        def spy(query, real=real_overflow, seen=overflow):
            seen.append(query.name)
            return real(query)

        mapper._map_read_overflow = spy
        aligner = None
        if run.get("engine"):
            aligner = PoaAligner(index, mesh=mesh, engine=PoaEngine(run["engine"]),
                                 graph=graph)
        got = {"chains": [], "alignments": []}
        reset_collective_counts()
        stream_map_align(mapper, _named_reads(run["reads"]), aligner,
                         batch_size=run.get("batch_size", 8192),
                         on_chains=lambda b: got["chains"].append(b.blob),
                         on_alignments=lambda b: got["alignments"].append(b.blob),
                         mesh=mesh)
        out["runs"].append(dict(chains=b"".join(got["chains"]),
                                alignments=b"".join(got["alignments"]),
                                overflow=overflow, collectives=collective_counts()))
    if merge_out is not None:
        first = runs[0]
        mapper = Mapper(index, mesh=mesh, **first["mapper"])
        mine = shard_batch(mesh, _named_reads(first["reads"]))
        merged = merge_gaf_shards(mapper.chains_to_gaf(mapper.map_reads(mine)), merge_out)
        out["merged"] = None if merged is None else [r.to_string() for r in merged]
    return out


def rank_resume_job(mesh, cwd: str, argv: list, batch_size: int, stop_at: int):
    """A rank of ``map`` (the CLI's per-rank run, ``argv`` without
    ``-t``) from ``cwd`` in batches of ``batch_size`` reads, stopped on
    every rank at the same point (just before the ``stop_at``-th
    ``begin_map``, after some batches' rows are committed), then run
    again with ``--resume`` to the end.  Rank 0 returns the progress
    record the stopped run left."""
    import json

    import torch

    from . import cli
    from .models import stream
    from .models.mapper import Mapper

    stream.DEFAULT_BATCH = batch_size
    real, calls = Mapper.begin_map, []

    class Stop(Exception):
        pass

    def stopping(self, queries):
        calls.append(1)
        if len(calls) == stop_at:
            raise Stop
        return real(self, queries)

    Mapper.begin_map = stopping
    os.chdir(cwd)
    try:
        cli._map_run(cli._build_parser().parse_args(argv), torch.device("cpu"), mesh)
    except Stop:
        pass
    finally:
        Mapper.begin_map = real
    if len(calls) != stop_at:
        raise AssertionError(f"the run ended after {len(calls)} batches, before the stop")
    progress = None
    if mesh.rank == 0:
        with open("out.progress.json") as fh:
            progress = json.load(fh)
    cli._map_run(cli._build_parser().parse_args(argv + ["--resume"]), torch.device("cpu"), mesh)
    return progress
