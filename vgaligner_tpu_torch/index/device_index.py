"""The device-resident index: counterpart of ``Index.device()``.

The index is the only state the aligner carries onto the device, so
this is the port's "load the weights" step.  ``device_index`` builds it
from the host ``Index``; ``from_numpy`` takes the JAX package's
``DeviceIndex`` fields as numpy arrays, so the two can be checked
against each other.  Layout and padding follow the JAX package exactly
(``vgaligner_tpu/index/build.py`` ``Index.device``):

  * ``kmer_codes`` int64, padded to a power of two with int64-max
    sentinels (never equal to a real <= 62-bit code);
  * ``fo_offsets``/``fo_counts`` int32, zero-padded alike;
  * ``fo_start``/``fo_end`` int32 while 2 * seq_length fits, else int64,
    zero-padded to a power of two;
  * ``node_starts`` int64, padded with seq_length;
  * ``dense_lut`` int32 [4^k] code -> group (-1 absent) when
    4^k <= ``VGALIGNER_DENSE_LUT_MAX`` (default 2^24), else None.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch


class DeviceIndex(NamedTuple):
    kmer_codes: torch.Tensor
    fo_offsets: torch.Tensor
    fo_counts: torch.Tensor
    fo_start: torch.Tensor
    fo_end: torch.Tensor
    node_starts: torch.Tensor
    dense_lut: Optional[torch.Tensor] = None


def _p2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _lut_space(k: int) -> int:
    space = 4 ** k
    max_space = int(os.environ.get("VGALIGNER_DENSE_LUT_MAX", 1 << 24))
    return space if 0 < space <= max_space else 0


def device_index(index, device: torch.device) -> DeviceIndex:
    """Build the device index from a host ``Index`` (either package's)."""
    nk_pad = _p2(max(len(index.kmer_codes), 1))
    codes = np.full(nk_pad, np.iinfo(np.int64).max, dtype=np.int64)
    codes[: len(index.kmer_codes)] = index.kmer_codes
    fo_off = np.zeros(nk_pad, dtype=np.int32)
    fo_off[: len(index.fo_offsets)] = index.fo_offsets
    fo_cnt = np.zeros(nk_pad, dtype=np.int32)
    fo_cnt[: len(index.fo_counts)] = index.fo_counts

    np_pad = _p2(max(len(index.fo_positions), 1))
    pos_dt = np.int32 if 2 * index.seq_length + 2 < 2**31 else np.int64
    fo_start = np.zeros(np_pad, dtype=pos_dt)
    fo_end = np.zeros(np_pad, dtype=pos_dt)
    if len(index.fo_positions):
        fo_start[: len(index.fo_positions)] = index.fo_positions[:, 0]
        fo_end[: len(index.fo_positions)] = index.fo_positions[:, 1]

    starts = np.full(_p2(len(index.node_starts)), index.seq_length, dtype=np.int64)
    starts[: len(index.node_starts)] = index.node_starts

    lut = None
    space = _lut_space(index.kmer_length)
    if space and len(index.kmer_codes):
        lut = np.full(space, -1, dtype=np.int32)
        lut[index.kmer_codes] = np.arange(len(index.kmer_codes), dtype=np.int32)

    return from_numpy(
        dict(kmer_codes=codes, fo_offsets=fo_off, fo_counts=fo_cnt,
             fo_start=fo_start, fo_end=fo_end, node_starts=starts,
             dense_lut=lut),
        device,
    )


def from_numpy(fields: dict, device: torch.device) -> DeviceIndex:
    """``DeviceIndex`` fields as numpy arrays (e.g. the JAX package's
    ``{k: np.asarray(v) for k, v in dindex._asdict().items()}``) ->
    tensors on ``device``; dtypes and shapes are kept."""

    def t(a):
        if a is None:
            return None
        return torch.from_numpy(np.array(a)).to(device)  # a writable copy

    return DeviceIndex(**{name: t(fields.get(name)) for name in DeviceIndex._fields})
