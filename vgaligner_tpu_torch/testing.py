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
"""

from __future__ import annotations

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
                     n_frac: float = 0.03, far_frac: float = 0.2):
    """Random padded POA problems in topological order, the layout the
    native builder gives the DP: vcodes [B,V] int8 (4 = N/pad), vpred
    [B,V,P] int32 (-1 dead), is_sink [B,V] uint8, nv [B] int32, q [B,L]
    int8, nq [B] int32.  Vertices without predecessors restart from the
    virtual source, a few edges reach far back, and every vertex without
    a successor is a sink, so most problems have several sinks."""
    rng = np.random.default_rng(seed)
    vcodes = rng.integers(0, 4, (B, V)).astype(np.int8)
    vcodes[rng.random((B, V)) < n_frac] = 4
    vpred = np.full((B, V, P), -1, dtype=np.int32)
    is_sink = np.zeros((B, V), dtype=np.uint8)
    nv = rng.integers(max(1, V // 2), V + 1, B).astype(np.int32)
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
