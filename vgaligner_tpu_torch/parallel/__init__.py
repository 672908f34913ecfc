"""Multi-device and multi-host mapping over torch.distributed, one
process a device (``mesh.py``), and the multi-host process layer
(``distributed.py``)."""

from .mesh import (COLLECTIVES, Mesh, collective_counts, host_shard, make_mesh,  # noqa: F401
                   pad_batch_to_multiple, place_index, replicate, reset_collective_counts,
                   shard_batch)
