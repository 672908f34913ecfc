"""The benchmark's one generator of graphs and reads, driven by data.

``write_graph`` writes a configuration's graph from its ``graph`` entry:
a frozen copy of the seeded synthetic generator the port's tests and
smoke run use (a random backbone cut by SNP bubbles and 1-6 bp indel
bubbles, node ids in topological order, haplotype P-lines that each pick
alleles), so later changes to the program's fixtures cannot move it.

``make_reads`` draws a traffic mix's reads from ``--seed``: each read
is a window of ``read_len`` bases of a random haplotype path at a random
offset, and each base is replaced by one of the three other bases with
probability ``sub_rate`` (vg sim's ``-e``).  Every read is drawn afresh,
numbered in order, and none is recycled within a run.  It is vectorised
over reads, so millions take seconds.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

_BASES = "ACGT"
_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _rand_seq(rng, n: int) -> str:
    return "".join(_BASES[c] for c in rng.integers(0, 4, n))


def write_graph(path: str, seed: int = 0, backbone_len: int = 22600,
                mean_spacing: float = 10.0, snp_frac: float = 0.55,
                n_haplotypes: int = 12, alt_freq: float = 0.35) -> dict:
    """Write the graph as GFA1 and return its shape."""
    rng = np.random.default_rng(seed)
    backbone = _rand_seq(rng, backbone_len)
    nodes: List[str] = []
    edges: List[tuple] = []
    sites = {}
    pos = 0
    prev_tail: List[int] = []

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
            prev_tail = [ref, seg]
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


def path_sequences(gfa_path: str) -> List[bytes]:
    """Each P-line's spelled sequence, in file order."""
    labels: Dict[str, str] = {}
    paths = []
    with open(gfa_path) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if f[0] == "S":
                labels[f[1]] = f[2]
            elif f[0] == "P":
                paths.append([s[:-1] for s in f[2].split(",") if s])
    return ["".join(labels[n] for n in p).encode("ascii") for p in paths]


def make_reads(gfa_path: str, n: int, read_len: int, sub_rate: float, seed: int) -> bytes:
    """``n`` reads of ``read_len`` bases, concatenated: read i is
    ``out[i * read_len:(i + 1) * read_len]``."""
    rng = np.random.default_rng([seed & (2 ** 64 - 1), 0x76676265])
    paths = [p for p in path_sequences(gfa_path) if len(p) >= read_len]
    if not paths:
        raise ValueError("no haplotype path is as long as a read")
    lens = np.asarray([len(p) for p in paths], dtype=np.int64)
    bases = np.frombuffer(b"".join(paths), dtype=np.uint8)
    codes = np.full(256, 0, dtype=np.uint8)
    codes[np.frombuffer(b"ACGT", dtype=np.uint8)] = np.arange(4, dtype=np.uint8)
    codes = codes[bases]
    off = np.concatenate([[0], np.cumsum(lens)[:-1]])
    out = np.empty((n, read_len), dtype=np.uint8)
    block = 1 << 16
    col = np.arange(read_len, dtype=np.int64)
    for s in range(0, n, block):
        m = min(block, n - s)
        p = rng.integers(0, len(paths), m)
        start = (rng.random(m) * (lens[p] - read_len + 1)).astype(np.int64)
        c = codes[(off[p] + start)[:, None] + col[None, :]]
        sub = rng.random((m, read_len)) < sub_rate
        shift = rng.integers(1, 4, (m, read_len), dtype=np.uint8)
        c = np.where(sub, (c + shift) % 4, c).astype(np.uint8)
        out[s : s + m] = _LUT[c]
    return out.tobytes()
