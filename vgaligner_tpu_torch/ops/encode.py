"""Read encoding and sliding-window k-mer codes.

Counterpart of ``vgaligner_tpu/ops/encode.py``: every overlapping window
of length k becomes an int64 2-bit code by one shift-or per base offset;
windows holding N/pad or overrunning the read are flagged invalid.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..utils.dna import encode_seq


def encode_reads_host(seqs: List[str], pad_to: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pack reads into a [B, pad_to] int8 code batch (pad/invalid = 4)."""
    batch = np.full((len(seqs), pad_to), 4, dtype=np.int8)
    lens = np.zeros(len(seqs), dtype=np.int32)
    for i, s in enumerate(seqs):
        codes = encode_seq(s)
        batch[i, : len(codes)] = codes
        lens[i] = len(codes)
    return batch, lens


def window_kmer_codes(codes: torch.Tensor, lens: torch.Tensor, k: int):
    """codes [B, L] int8 (0..3 bases, 4 = N/pad), lens [B] ->
    (wcodes [B, W] int64, valid [B, W] bool) with W = L - k + 1."""
    B, L = codes.shape
    W = L - k + 1
    if W <= 0:
        return (
            torch.zeros((B, 0), dtype=torch.int64, device=codes.device),
            torch.zeros((B, 0), dtype=torch.bool, device=codes.device),
        )
    wcodes = torch.zeros((B, W), dtype=torch.int64, device=codes.device)
    ok = torch.ones((B, W), dtype=torch.bool, device=codes.device)
    for j in range(k):
        base = codes[:, j : j + W].to(torch.int64)
        is_base = base < 4
        ok &= is_base
        wcodes = (wcodes << 2) | torch.where(is_base, base, 0)
    pos = torch.arange(W, dtype=torch.int32, device=codes.device)
    in_read = pos[None, :] + k <= lens[:, None]
    return wcodes, ok & in_read
