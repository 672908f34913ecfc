"""The graph and its k-mer index, worked out from the GFA text alone.

A forward-only GFA1 graph (every link ``+``/``+``, node ids 1..n) as
the benchmark's configurations write it.  Nodes are laid end to end in
id order (``node_starts``); a k-mer's position is the linear position
of its first base and one past its last base, over every forward walk
of k bases.  Neighbour lists keep the links' file order; the paths
(P-lines) keep theirs, numbered from 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

BASE_CODE = np.full(256, 4, dtype=np.int8)
for _i, _b in enumerate("ACGT"):
    BASE_CODE[ord(_b)] = _i
    BASE_CODE[ord(_b.lower())] = _i


def encode(seq: str) -> np.ndarray:
    """A=0, C=1, G=2, T=3, anything else 4."""
    return BASE_CODE[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]


@dataclass
class Graph:
    labels: List[str]  # labels[i] is node i + 1
    out: List[List[int]]  # out[i]: successor ids of node i + 1, file order
    inc: List[List[int]]  # inc[i]: predecessor ids of node i + 1, file order
    node_starts: np.ndarray  # int64 [n + 1]
    paths: List[List[int]]  # paths[p]: node ids of the p-th P-line, in order

    @property
    def n(self) -> int:
        return len(self.labels)

    def start(self, node: int) -> int:
        return int(self.node_starts[node - 1])

    def node_of(self, pos: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(node ids, offsets in the node) of linear positions."""
        ids = np.searchsorted(self.node_starts, pos, side="right")
        return ids, pos - self.node_starts[ids - 1]


def parse_gfa(path: str) -> Graph:
    labels: Dict[int, str] = {}
    links: List[Tuple[int, int]] = []
    paths: List[List[int]] = []
    with open(path) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if f[0] == "S":
                labels[int(f[1])] = f[2]
            elif f[0] == "L":
                if f[2] != "+" or f[4] != "+":
                    raise ValueError("the reference reads forward-only graphs")
                links.append((int(f[1]), int(f[3])))
            elif f[0] == "P":
                steps = f[2].split(",") if f[2] else []
                if any(st[-1] != "+" for st in steps):
                    raise ValueError("the reference reads forward-only paths")
                paths.append([int(st[:-1]) for st in steps])
    n = len(labels)
    if sorted(labels) != list(range(1, n + 1)):
        raise ValueError("node ids must be 1..n")
    out: List[List[int]] = [[] for _ in range(n)]
    inc: List[List[int]] = [[] for _ in range(n)]
    for a, b in links:
        out[a - 1].append(b)
        inc[b - 1].append(a)
    lab = [labels[i] for i in range(1, n + 1)]
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(s) for s in lab], out=starts[1:])
    return Graph(lab, out, inc, starts, paths)


class KmerIndex:
    """Every forward k-mer of the graph: code -> sorted unique (start,
    end) rows."""

    def __init__(self, graph: Graph, k: int):
        self.k = k
        rows: Dict[int, set] = {}
        mask = (1 << (2 * k)) - 1
        for node in range(1, graph.n + 1):
            lab = graph.labels[node - 1]
            base = graph.start(node)
            for off in range(len(lab)):
                # (code so far, bases so far, node, offset of the last base)
                stack = [(0, 0, node, off)]
                while stack:
                    code, m, nd, o = stack.pop()
                    s = graph.labels[nd - 1]
                    while o < len(s) and m < k:
                        c = int(BASE_CODE[ord(s[o])])
                        if c > 3:
                            break
                        code = ((code << 2) | c) & mask
                        m += 1
                        o += 1
                    else:
                        if m == k:
                            end = graph.start(nd) + o
                            rows.setdefault(code, set()).add((base + off, end))
                        else:
                            stack.extend((code, m, nx, 0) for nx in graph.out[nd - 1])
                        continue
        self.codes = np.asarray(sorted(rows), dtype=np.int64)
        groups = [sorted(rows[c]) for c in self.codes.tolist()]
        self.counts = np.asarray([len(g) for g in groups], dtype=np.int64)
        self.offsets = np.zeros(len(groups) + 1, dtype=np.int64)
        np.cumsum(self.counts, out=self.offsets[1:])
        flat = [r for g in groups for r in g]
        self.starts = np.asarray([r[0] for r in flat], dtype=np.int64)
        self.ends = np.asarray([r[1] for r in flat], dtype=np.int64)

    def groups_of(self, codes: np.ndarray) -> np.ndarray:
        """Group of each code, -1 where the graph has no such k-mer."""
        g = np.searchsorted(self.codes, codes)
        g = np.minimum(g, max(len(self.codes) - 1, 0))
        hit = (len(self.codes) > 0) & (self.codes[g] == codes) & (codes >= 0)
        return np.where(hit, g, -1)

    def anchors(self, seqs: List[str]):
        """Every anchor of every read in generation order (query k-mers in
        order, each k-mer's rows in group order): flat (read, qb, tb, te)
        and each read's first anchor (``off``, one past the last at the end)."""
        k = self.k
        lens = np.asarray([len(s) for s in seqs], dtype=np.int64)
        base = np.zeros(len(seqs) + 1, dtype=np.int64)
        np.cumsum(lens, out=base[1:])
        c = encode("".join(seqs)).astype(np.int64)
        nwin = max(len(c) - k + 1, 0)
        rid = np.repeat(np.arange(len(seqs)), lens)[:nwin]
        qpos = np.arange(nwin) - base[rid]
        ok = qpos + k <= lens[rid]
        if nwin:
            win = np.lib.stride_tricks.sliding_window_view(c, k)
            bad = (win > 3).any(axis=1)
            codes = (np.where(win > 3, 0, win) * (4 ** np.arange(k - 1, -1, -1))).sum(axis=1)
            g = self.groups_of(np.where(bad, -1, codes))
            ok &= g >= 0
        else:
            g = np.zeros(0, dtype=np.int64)
        g, rid, qpos = g[ok], rid[ok], qpos[ok]
        n = self.counts[g]
        first = np.repeat(self.offsets[g], n)
        within = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
        row = first + within
        arid = np.repeat(rid, n)
        off = np.searchsorted(arid, np.arange(len(seqs) + 1))
        return arid, np.repeat(qpos, n), self.starts[row], self.ends[row], off

    def n_anchors(self, seqs: List[str]) -> np.ndarray:
        return np.diff(self.anchors(seqs)[4])
