"""Data-parallel mapping over devices: one process a device.

Counterpart of ``vgaligner_tpu/parallel/mesh.py``, with the same names.
The JAX package drives every device of a 1-D ``data`` mesh from one
process; the port runs one process a device in a ``torch.distributed``
process group (NCCL between CUDA ranks, gloo between CPU ranks), and a
``Mesh`` is that group seen from one rank:

  * the read batch is sharded along reads: each rank maps and aligns its
    own contiguous slice (``shard_batch``), so concatenating the ranks'
    GAF rows in rank order gives input order;
  * the index is replicated, or with ``shard_positions`` its position
    table (``fo_start``/``fo_end``) is split by row into one equal
    contiguous range a rank (``place_index``); the mapper then gathers
    anchor positions with one all-gather and one reduce-scatter a launch.

Every collective goes through a ``Mesh`` method, which counts it in
``COLLECTIVES`` (as ``kernels.LAUNCHES`` counts launches).  Every rank
must call the same collectives in the same order with the same shapes,
from its main thread.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device

COLLECTIVES = {"all_reduce": 0, "all_gather_into_tensor": 0, "reduce_scatter_tensor": 0,
               "broadcast": 0}

# the same calls under the names that newer torch releases prefer
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def reset_collective_counts() -> None:
    for name in COLLECTIVES:
        COLLECTIVES[name] = 0


def collective_counts() -> dict:
    return dict(COLLECTIVES)


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the process group: rank, size and the device
    its tensors (and the collectives' buffers) live on."""

    rank: int
    size: int
    device: torch.device

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        COLLECTIVES["all_reduce"] += 1
        t = t.to(self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[n, ...] on every rank -> [size * n, ...], rank r's rows at
        [r * n, (r + 1) * n)."""
        COLLECTIVES["all_gather_into_tensor"] += 1
        t = t.to(self.device).contiguous()
        out = torch.empty((self.size * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                          device=self.device)
        _all_gather(out, t)
        return out

    def reduce_scatter_sum(self, t: torch.Tensor) -> torch.Tensor:
        """[size * n, ...] on every rank -> [n, ...]: rank r gets the sum
        over ranks of rows [r * n, (r + 1) * n)."""
        COLLECTIVES["reduce_scatter_tensor"] += 1
        t = t.to(self.device).contiguous()
        out = torch.empty((t.shape[0] // self.size, *t.shape[1:]), dtype=t.dtype,
                          device=self.device)
        _reduce_scatter(out, t, op=dist.ReduceOp.SUM)
        return out

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        COLLECTIVES["broadcast"] += 1
        t = t.to(self.device).contiguous()
        dist.broadcast(t, src)
        return t

    def gather_bytes(self, blob: bytes, n_items: int = 0) -> Optional[Tuple[int, bytes]]:
        """Every rank's blob, concatenated in rank order, and the sum of
        the ranks' ``n_items``, on rank 0 (None elsewhere).  Lengths are
        gathered first, then the blobs padded to the longest (the
        collectives need one shape on every rank); no object is pickled."""
        head = torch.tensor([[len(blob), n_items]], dtype=torch.int64)
        heads = self.all_gather(head).cpu()
        width = max(int(heads[:, 0].max()), 1)
        buf = torch.zeros((1, width), dtype=torch.uint8)
        if blob:
            buf[0, : len(blob)] = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
        rows = self.all_gather(buf).cpu().numpy()
        if self.rank != 0:
            return None
        return (int(heads[:, 1].sum()),
                b"".join(rows[r, : int(heads[r, 0])].tobytes() for r in range(self.size)))


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """The initialised default process group as a ``Mesh``.  A rank's
    device is ``devices[rank]`` when given, else the current CUDA device
    under NCCL (``torch.cuda.set_device`` before ``init_process_group``)
    and the CPU under gloo.  ``n_devices``, when given, must be the
    group's size: one process drives one device."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group "
                           "(parallel.distributed.initialize)")
    rank, size = dist.get_rank(), dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} devices needs {n_devices} ranks, not {size}")
    if devices is not None:
        device = torch.device(devices[rank])
    elif dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    return Mesh(rank=rank, size=size, device=device)


def rank_device(mesh: Optional[Mesh], device) -> torch.device:
    """The device a model object runs on: ``device`` (the card when it is
    None; ``device.resolve_device`` raises RuntimeError without one), or
    with a mesh the rank's own device (a ``device`` of another type is an
    error)."""
    if mesh is None:
        return resolve_device("cuda" if device is None else device)
    if device is not None and torch.device(device).type != mesh.device.type:
        raise ValueError(f"device {device} given with a mesh on {mesh.device}")
    return mesh.device


def host_shard(n_items: int, process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> slice:
    """A process's contiguous slice of an ``n_items``-long list (this
    process's, in the initialised group, by default): the first
    processes take ceil(n / count) items each, so concatenating the
    slices in process order restores the list."""
    up = dist.is_initialized()
    rank = process_index if process_index is not None else (dist.get_rank() if up else 0)
    size = process_count if process_count is not None else (dist.get_world_size() if up else 1)
    per = (n_items + size - 1) // size
    return slice(min(rank * per, n_items), min((rank + 1) * per, n_items))


def shard_batch(mesh: Mesh, *arrays):
    """This rank's contiguous rows (axis 0) of each array or list."""
    out = tuple(a[host_shard(len(a), mesh.rank, mesh.size)] for a in arrays)
    return out if len(out) > 1 else out[0]


def replicate(mesh: Mesh, tree):
    """A tensor, or a NamedTuple of tensors (e.g. DeviceIndex), on this
    rank's device: every rank holds the whole of it."""
    if isinstance(tree, torch.Tensor):
        return tree.to(mesh.device)
    return type(tree)(*(None if a is None else a.to(mesh.device) for a in tree))


def place_index(mesh: Mesh, dindex, shard_positions: bool = False):
    """A DeviceIndex on this rank.

    shard_positions=False replicates everything.  shard_positions=True
    keeps only this rank's rows of the position table (fo_start/fo_end,
    the index's dominant memory at pangenome scale), padded with zeros
    to a multiple of the size so that every rank owns an equal contiguous
    range; the code table, counts, offsets, node starts and LUT stay
    whole.  Consumed by ``Mapper``'s sharded position gather."""
    if not shard_positions:
        return replicate(mesh, dindex)
    n = dindex.fo_start.shape[0]
    n_pad = pad_batch_to_multiple(max(n, mesh.size), mesh.size)
    shard = n_pad // mesh.size
    lo = mesh.rank * shard

    def rows(a):
        a = torch.nn.functional.pad(a.cpu(), (0, n_pad - n))
        return a[lo : lo + shard].to(mesh.device, copy=True)  # not a view of the whole

    whole = dindex._replace(fo_start=None, fo_end=None)
    return replicate(mesh, whole)._replace(fo_start=rows(dindex.fo_start),
                                           fo_end=rows(dindex.fo_end))


def pad_batch_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple
