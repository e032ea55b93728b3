"""Parallelism layer: the mesh over ``torch.distributed``, parameter
partitions, the multi-process bootstrap, sequence-parallel attention and
the GPipe schedule (the port of ``tpu_pipelines/parallel``).

One process per device joins a process group (``distributed.py``); the
mesh lays the processes out on its axes, one group per axis
(``mesh.py``); the partitions of fsdp, the experts, tensor parallelism
and pipeline stages are in ``partition.py``; the differentiable exchanges
over an axis (Megatron's *f* and *g* among them) in ``collectives.py``;
ring and Ulysses attention over ``seq`` in ``ring_attention.py``; GPipe
over ``pipe`` in ``pipeline_parallel.py``.  The reference's ``shard_map``
(its ``compat.py``) has no counterpart: each process runs its own part.
"""

from tpu_pipelines_torch.parallel.mesh import (  # noqa: F401
    VALID_MASK_KEY,
    DeviceMesh,
    MeshConfig,
    make_mesh,
    masked_mean,
    shard_batch,
)
from tpu_pipelines_torch.parallel.pipeline_parallel import gpipe  # noqa: F401
