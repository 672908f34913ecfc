"""The yardstick of the kernels: the work a launch's problem needs, and
the least time one H100 could do it in.

A frozen, corrected copy of the arithmetic the port's smoke run used.
It counts what the problem needs, whatever implements it: each input
read once and each output written once, pairs inside the band among a
read's real anchors, DP cells below each problem's vertex count for its
real query length, and each vertex's real predecessors.  It counts no
intermediate an implementation keeps (traceback bits, backing rows, a
row ring) and no padding.

The operations per unit of work are counted from the recurrences' inner
loops (``OPS``).  The bound of a launch is the larger of its bytes over
the memory rate and its operations over the peak rate of their type.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

# one H100 SXM (NVIDIA's data sheet, dense, outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # int32 counted here too
F64_OPS_PER_S = 34e12

OPS = {
    "chain_pair": 40,  # a pair in the band: filters, lengths, gap cost, score, compare
    "poa_cell": 40,  # a global cell: h_pre, case, scan terms, F1/F2, H
    "poa_cell_pred": 10,  # a global cell and predecessor: two opens, two extends, maxima, M
    "poa_step": 30,  # a global traceback step: state machine, tape entry
    "local_cell": 10,  # a local cell: substitution, floor, best
    "local_cell_pred": 3,  # a local cell and predecessor: max, compare, select
    "local_step": 10,  # a local traceback step: predecessor, tape entry
}


def bound_s(nbytes: float, ops: float, ops_per_s: float) -> Tuple[float, str]:
    """(least seconds, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def band_pairs(n: np.ndarray, bandwidth: int) -> np.ndarray:
    """Pairs (j, i), i - bandwidth <= j < i, among n anchors."""
    n = np.asarray(n, dtype=np.int64)
    inside = np.minimum(n, bandwidth)
    # sum_{i < n} min(i, bw) = sum_{i < min(n, bw)} i + (n - bw)+ * bw
    return inside * (inside - 1) // 2 + np.maximum(n - bandwidth, 0) * bandwidth


def chain_work(n_anchors: Iterable[int], bandwidth: int, exact: bool) -> Tuple[int, int]:
    """(bytes, operations) of one chaining launch over reads with these
    real anchor counts: qb, tb, te and the valid flag of each anchor
    read once, its score and predecessor written once, each read's best
    score written once, and the f64 gap table read once in exact mode."""
    n = np.asarray(list(n_anchors), dtype=np.int64)
    n = n[n > 0]
    wide = 8 if exact else 4
    total = int(n.sum())
    nbytes = total * (4 + 2 * wide + 1) + total * (wide + 4) + len(n) * wide
    if exact:
        nbytes += 8 * 1001
    return nbytes, int(band_pairs(n, bandwidth).sum()) * OPS["chain_pair"]


def _real_preds(vpred: np.ndarray, nv: np.ndarray) -> np.ndarray:
    """Real predecessor entries of each problem's vertices below its nv."""
    V = vpred.shape[1]
    below = np.arange(V)[None, :] < nv[:, None]
    return ((vpred >= 0) & below[:, :, None]).sum(axis=(1, 2))


def global_work(vpred: np.ndarray, nv: np.ndarray, nq: np.ndarray,
                tlen: np.ndarray) -> Tuple[int, int]:
    """(bytes, operations) of one global POA launch (DP and traceback):
    each vertex's code, sink flag and real predecessor ids below nv, the
    query, nv and nq read once; the alignment (tlen steps) and the score
    written once; cells below nv over the query's length + 1."""
    nv, nq, tlen = (np.asarray(a, dtype=np.int64) for a in (nv, nq, tlen))
    preds = _real_preds(vpred, nv)
    W = nq + 1
    nbytes = int((nv * 2 + preds * 4 + nq + 8 + tlen * 4 + 8).sum())
    ops = int((W * (nv * OPS["poa_cell"] + preds * OPS["poa_cell_pred"])).sum()
              + (tlen * OPS["poa_step"]).sum())
    return nbytes, ops


def local_work(vpred: np.ndarray, nv: np.ndarray, nq: np.ndarray,
               tlen: np.ndarray) -> Tuple[int, int]:
    """(bytes, operations) of one local POA launch: each vertex's code
    and real predecessor ids below nv, the query, nv and nq read once;
    the alignment (tlen steps), best score, length and query end written
    once; cells below nv over the query's length + 1."""
    nv, nq, tlen = (np.asarray(a, dtype=np.int64) for a in (nv, nq, tlen))
    preds = _real_preds(vpred, nv)
    W = nq + 1
    nbytes = int((nv + preds * 4 + nq + 8 + tlen * 4 + 12).sum())
    ops = int((W * (nv * OPS["local_cell"] + preds * OPS["local_cell_pred"])).sum()
              + (tlen * OPS["local_step"]).sum())
    return nbytes, ops
