"""Multi-host orchestration: process init, read sharding, GAF merge.

Counterpart of ``vgaligner_tpu/parallel/distributed.py``, with the same
names and environment variables.  N processes (one a device, on one or
more hosts) each map one contiguous shard of the read stream, and the
shards' GAF records are merged in input order:

    initialize()                              # torch.distributed, one rank a device
    shard = read_seqs_sharded(path)           # this process's reads
    ... map + align the shard ...
    all_gaf = merge_gaf_shards(records, out)  # process 0 writes

The CLI's ``-t N`` needs none of this: it starts its own ranks on one
host (``cli.py``) and merges each batch as it goes (``models/stream.py``).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import host_shard, make_mesh

log = logging.getLogger(__name__)

__all__ = ["initialize", "host_shard", "read_seqs_sharded", "merge_gaf_shards"]

# a rank that falls out of step fails after this long instead of hanging
TIMEOUT = datetime.timedelta(seconds=600)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: str = "cuda") -> Tuple[int, int]:
    """``torch.distributed.init_process_group`` over
    ``tcp://<coordinator>``, with the environment's
    ``VGALIGNER_COORDINATOR``, ``VGALIGNER_NUM_PROCESSES`` and
    ``VGALIGNER_PROCESS_ID`` as fallbacks; returns (rank, size).  A
    no-op single-process setup without a coordinator.

    ``device`` "cuda" joins over NCCL and puts process p on card
    p mod (the host's card count), so hosts run equal, contiguous runs
    of ranks; "cpu" joins over gloo."""
    coordinator_address = coordinator_address or os.environ.get("VGALIGNER_COORDINATOR")
    if coordinator_address and not dist.is_initialized():
        size = num_processes or int(os.environ.get("VGALIGNER_NUM_PROCESSES", "1"))
        rank = process_id if process_id is not None else int(
            os.environ.get("VGALIGNER_PROCESS_ID", "0"))
        backend = "gloo"
        if torch.device(device).type == "cuda":
            backend = "nccl"
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                rank=rank, world_size=size, timeout=TIMEOUT)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def read_seqs_sharded(filename: str, process_index: Optional[int] = None,
                      process_count: Optional[int] = None):
    """Each process parses the FASTA/FASTQ file and keeps only its
    contiguous shard of reads."""
    from ..io.fastx import read_seqs_from_file

    seqs = read_seqs_from_file(filename)
    return seqs[host_shard(len(seqs), process_index, process_count)]


def merge_gaf_shards(records: Sequence, out_path: Optional[str] = None,
                     process_index: Optional[int] = None,
                     process_count: Optional[int] = None) -> Optional[List]:
    """Every process's GAF records on process 0, in process order (input
    order, since shards are contiguous slices); process 0 writes them to
    ``out_path`` when given and returns them, the others return None.

    The rows cross as one uint8 blob a process, lengths first, then the
    blobs padded to the longest (``Mesh.gather_bytes``); GAF rows are
    newline-terminated with no newline inside, so splitting the merged
    text recovers them, and ``GAFAlignment.from_string`` returns records
    that print the same bytes."""
    from ..io.gaf import GAFAlignment, write_gaf_to_file

    pc = process_count if process_count is not None else (
        dist.get_world_size() if dist.is_initialized() else 1)
    pi = process_index if process_index is not None else (
        dist.get_rank() if dist.is_initialized() else 0)
    if pc == 1:
        merged = list(records)
    else:
        got = make_mesh().gather_bytes("".join(r.to_string() for r in records).encode())
        if got is None:
            return None
        merged = [GAFAlignment.from_string(line) for line in got[1].decode().splitlines()]
    if out_path is not None and pi == 0:
        write_gaf_to_file(merged, out_path)
        log.info("merged GAF written to %s", out_path)
    return merged
