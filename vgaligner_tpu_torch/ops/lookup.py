"""k-mer lookup and anchor materialisation (plain PyTorch).

Counterpart of ``vgaligner_tpu/ops/lookup.py``, which has no Pallas
kernel (XLA ops there).  One gather per window from the dense LUT, or a
binary search of the sorted code table, then one gather from the
forward-only position table.  Anchor order is the reference's:
ascending query k-mer, then table order; the anchor id is its slot.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..index.device_index import DeviceIndex


class AnchorBatch(NamedTuple):
    qb: torch.Tensor  # [B, A] int32 query begin
    tb: torch.Tensor  # [B, A] target begin (fo_start dtype)
    te: torch.Tensor  # [B, A] target end (exclusive)
    valid: torch.Tensor  # [B, A] bool
    n_anchors: torch.Tensor  # [B] int32 true anchor count (pre-truncation)


def lookup_and_materialize_anchors(index: DeviceIndex, wcodes: torch.Tensor,
                                   wvalid: torch.Tensor, a_max: int,
                                   position_gather=None) -> AnchorBatch:
    """wcodes/wvalid [B, W >= 1] from window_kmer_codes -> anchors padded
    to a_max.

    position_gather: optional (table_row [B, A] int64, valid [B, A] bool)
    -> (tb, te) in place of the position-table gather; the offset-sharded
    index (``parallel/mesh.py`` ``place_index``) resolves rows against
    every rank's shard of the table there."""
    n_kmers = index.kmer_codes.shape[0]
    if index.dense_lut is not None:
        space = index.dense_lut.shape[0]
        g_clip = index.dense_lut[wcodes.clamp(0, space - 1)]
        found = wvalid & (g_clip >= 0)
        g_clip = g_clip.clamp_min(0)
    else:
        g = torch.searchsorted(index.kmer_codes, wcodes)
        g_clip = g.clamp_max(n_kmers - 1)
        found = wvalid & (g < n_kmers) & (index.kmer_codes[g_clip] == wcodes)
    counts = torch.where(found, index.fo_counts[g_clip], 0).to(torch.int32)
    offsets = index.fo_offsets[g_clip]

    B, W = counts.shape
    cum = torch.cumsum(counts, dim=1, dtype=torch.int32)
    total = cum[:, -1]

    # slot s belongs to the window w with cum[w-1] <= s < cum[w]: the
    # count of windows with cum[w] <= s, which (cum non-decreasing) is a
    # right-sided binary search — no [B, W, A] compare tensor
    slots = torch.arange(a_max, dtype=torch.int32, device=wcodes.device)
    w_of = torch.searchsorted(cum, slots.expand(B, a_max).contiguous(), right=True)

    valid = slots[None, :] < total[:, None]
    w_clip = w_of.clamp_max(W - 1)
    row_base = offsets.to(torch.int32) - (cum - counts)
    table_row = torch.gather(row_base, 1, w_clip) + slots[None, :]
    table_row = torch.where(valid, table_row, 0).to(torch.int64)
    if position_gather is not None:
        tb, te = position_gather(table_row, valid)
    else:
        tb = index.fo_start[table_row]
        te = index.fo_end[table_row]
    return AnchorBatch(qb=w_clip.to(torch.int32), tb=tb, te=te, valid=valid,
                       n_anchors=total)
