"""The frozen work counts on problems counted by hand."""

import numpy as np

from helpers import ROOT  # noqa: F401

from vgbench import work


def test_band_pairs():
    # n anchors, band 3: pairs (j, i) with i - 3 <= j < i
    assert work.band_pairs(np.array([0, 1, 2, 3, 4, 6]), 3).tolist() == [0, 0, 1, 3, 6, 12]


def test_chain_work_fast_and_exact():
    # reads of 3 and 5 anchors, band 2: pairs 0+1+2 and 0+1+2+2+2
    nbytes, ops = work.chain_work([3, 0, 5], 2, exact=False)
    assert ops == (3 + 7) * work.OPS["chain_pair"]
    assert nbytes == 8 * (4 + 8 + 1) + 8 * (4 + 4) + 2 * 4
    nbytes, ops = work.chain_work([3, 5], 2, exact=True)
    assert nbytes == 8 * (4 + 16 + 1) + 8 * (8 + 4) + 2 * 8 + 8 * 1001


def test_global_work_counts_cells_below_nv_and_real_preds():
    # two problems padded to V 4, P 2; the second has 2 vertices
    vpred = np.array([[[-1, -1], [0, -1], [1, 0], [2, -1]],
                      [[-1, -1], [0, -1], [7, 7], [7, 7]]])
    nv, nq, tlen = np.array([4, 2]), np.array([5, 3]), np.array([6, 4])
    nbytes, ops = work.global_work(vpred, nv, nq, tlen)
    preds = np.array([4, 1])
    cells_ops = (6 * (4 * 40 + 4 * 10)) + (4 * (2 * 40 + 1 * 10))
    assert ops == cells_ops + (6 + 4) * work.OPS["poa_step"]
    assert nbytes == int((nv * 2 + preds * 4 + nq + 8 + tlen * 4 + 8).sum())


def test_local_work():
    vpred = np.array([[[-1], [0], [1]]])
    nbytes, ops = work.local_work(vpred, np.array([3]), np.array([4]), np.array([2]))
    assert ops == 5 * (3 * 10 + 2 * 3) + 2 * work.OPS["local_step"]
    assert nbytes == 3 + 2 * 4 + 4 + 8 + 2 * 4 + 12


def test_bound_takes_the_larger_side():
    t, by = work.bound_s(3.35e12, 1.0, work.F32_OPS_PER_S)
    assert by == "bytes" and abs(t - 1.0) < 1e-12
    t, by = work.bound_s(1.0, 34e12, work.F64_OPS_PER_S)
    assert by == "operations" and abs(t - 1.0) < 1e-12
