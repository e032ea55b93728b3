"""Parallelism layer: the data-parallel mesh over ``torch.distributed``,
parameter partitions and the multi-process bootstrap (the port of
``tpu_pipelines/parallel``), and plain attention.

One process per device joins a process group (``distributed.py``); the
mesh's ``data`` axis is that group (``mesh.py``); fsdp's partitions and
its gather are in ``partition.py``.  The reference's ``shard_map`` (its
``compat.py``) has no counterpart: each process runs its own rows.
Sequence, tensor, expert and pipeline parallelism wait for ROADMAP.md A6.
"""

from tpu_pipelines_torch.parallel.mesh import (  # noqa: F401
    VALID_MASK_KEY,
    DeviceMesh,
    MeshConfig,
    make_mesh,
    masked_mean,
    shard_batch,
)
