"""Multi-process bootstrap, the port of
``tpu_pipelines/parallel/distributed.py``.

The reference joins JAX's coordination service; here every process joins
one ``torch.distributed`` process group, one process per GPU (the PyTorch
idiom for the reference's SPMD mesh): NCCL for CUDA devices, gloo for the
CPU (the tests, which spawn N processes on localhost).  The topology comes
from the reference's environment variables (``TPP_COORDINATOR_ADDRESS``,
``TPP_NUM_PROCESSES``, ``TPP_PROCESS_ID``, JobSet's
``JOB_COMPLETION_INDEX``), or from torchrun's (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) when the ``TPP_*`` ones
are absent.  The reference's ``cpu_devices_per_process`` has no
counterpart: one process is one device.

The runner's collectives (``broadcast_int``, ``broadcast_json``,
``allgather_int``, ``barrier``) are the counterparts of the reference's
``multihost_utils`` calls under ``spmd_sync``: they run over the default
process group, on CPU tensors for gloo and, for NCCL, on the card the
process joined the group on (recorded then: the runner issues them from a
worker thread, whose current device is not the process's).  One card runs
two ranks over gloo only (NCCL refuses a second rank on a device), so the
NCCL branch is held by reading and by a CPU test with a stand-in group,
not by a run.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import logging
import os
import threading
from typing import Any, Dict, List, Optional

log = logging.getLogger("tpu_pipelines_torch.distributed")

ENV_COORDINATOR = "TPP_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "TPP_NUM_PROCESSES"
ENV_PROCESS_ID = "TPP_PROCESS_ID"
# JobSet injects the worker index here; used when TPP_PROCESS_ID is absent.
ENV_JOB_COMPLETION_INDEX = "JOB_COMPLETION_INDEX"
# torchrun's equivalents, read when TPP_NUM_PROCESSES is unset.
ENV_RANK = "RANK"
ENV_WORLD_SIZE = "WORLD_SIZE"
ENV_LOCAL_RANK = "LOCAL_RANK"
ENV_MASTER_ADDR = "MASTER_ADDR"
ENV_MASTER_PORT = "MASTER_PORT"
DEFAULT_PORT = 8476


@dataclasses.dataclass
class DistributedConfig:
    coordinator_address: str
    num_processes: int
    process_id: int
    # This process's GPU on its host (torchrun's LOCAL_RANK); None = not
    # given, see :func:`local_device_index`.
    local_rank: Optional[int] = None

    @classmethod
    def from_env(cls, env=os.environ) -> Optional["DistributedConfig"]:
        """None when the env describes a single-process run."""
        if ENV_NUM_PROCESSES in env:
            n = int(env.get(ENV_NUM_PROCESSES, "1"))
            if n <= 1:
                return None
            coordinator = env.get(ENV_COORDINATOR, "")
            if not coordinator:
                raise ValueError(
                    f"{ENV_NUM_PROCESSES}={n} but {ENV_COORDINATOR} is unset"
                )
            pid_s = env.get(ENV_PROCESS_ID, env.get(ENV_JOB_COMPLETION_INDEX))
            if pid_s is None:
                raise ValueError(
                    f"{ENV_NUM_PROCESSES}={n} but neither {ENV_PROCESS_ID} nor "
                    f"{ENV_JOB_COMPLETION_INDEX} is set"
                )
            local = env.get(ENV_LOCAL_RANK)
            return cls(coordinator, n, int(pid_s),
                       None if local is None else int(local))
        n = int(env.get(ENV_WORLD_SIZE, "1"))
        if n <= 1:
            return None
        if ENV_RANK not in env or ENV_MASTER_ADDR not in env:
            raise ValueError(
                f"{ENV_WORLD_SIZE}={n} but {ENV_RANK} or {ENV_MASTER_ADDR} "
                "is unset"
            )
        coordinator = (f"{env[ENV_MASTER_ADDR]}:"
                       f"{env.get(ENV_MASTER_PORT, DEFAULT_PORT)}")
        local = env.get(ENV_LOCAL_RANK)
        return cls(coordinator, n, int(env[ENV_RANK]),
                   None if local is None else int(local))

    def env_vars(self) -> dict:
        out = {
            ENV_COORDINATOR: self.coordinator_address,
            ENV_NUM_PROCESSES: str(self.num_processes),
            ENV_PROCESS_ID: str(self.process_id),
        }
        if self.local_rank is not None:
            out[ENV_LOCAL_RANK] = str(self.local_rank)
        return out

    def init_method(self) -> str:
        """``tcp://host:port`` of the coordinator (DEFAULT_PORT when the
        address names none)."""
        address = self.coordinator_address
        if ":" not in address.rsplit("]", 1)[-1]:
            address = f"{address}:{DEFAULT_PORT}"
        return f"tcp://{address}"


def survivor_configs(
    num_processes: int,
    lost_process_ids,
    coordinator_address: str = "",
) -> list:
    """Re-form the process topology after losing processes: the elastic
    resume's bootstrap.

    A process group cannot shrink in place: the job restarts on the
    survivors with a re-derived topology.  Survivors keep their relative
    order but are re-indexed densely 0..n-1 (rank 0's duties, checkpoints
    and TensorBoard, fall to the lowest surviving rank), and the
    coordinator moves to the new rank 0's address unless one is passed.
    Each survivor then resumes from the last durable checkpoint with a
    per-host shard assignment re-derived from the new (index, count)
    (``per_host_input_config`` / ``assigned_shard_files``).

    Returns ``[(old_process_id, DistributedConfig), ...]`` in new-rank
    order; raises when nothing survives.
    """
    lost = {int(p) for p in lost_process_ids}
    bad = lost - set(range(num_processes))
    if bad:
        raise ValueError(
            f"lost process ids {sorted(bad)} not in 0..{num_processes - 1}"
        )
    survivors = [p for p in range(num_processes) if p not in lost]
    if not survivors:
        raise ValueError(
            f"all {num_processes} processes lost: nothing to re-form"
        )
    return [
        (
            old_id,
            DistributedConfig(
                coordinator_address=coordinator_address,
                num_processes=len(survivors),
                process_id=new_id,
            ),
        )
        for new_id, old_id in enumerate(survivors)
    ]


def local_process_id(env=os.environ) -> int:
    """This process's rank in a multi-process run; 0 for single-process.

    Reads the environment only: safe before any process group exists."""
    cfg = DistributedConfig.from_env(env)
    return 0 if cfg is None else cfg.process_id


def process_topology() -> "tuple[int, int]":
    """``(rank, world size)`` of the default process group; ``(0, 1)``
    when there is none."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def maybe_join_process_group(device="cuda", env=os.environ) -> "tuple[int, int]":
    """For a ``run_fn``: join the process group the env describes (unless
    one exists already) and return ``(rank, world size)``; ``(0, 1)`` in a
    run of one process."""
    maybe_initialize_from_env(device=device, env=env)
    return process_topology()


def local_device_index(cfg: Optional[DistributedConfig]) -> int:
    """The GPU this process drives: ``LOCAL_RANK`` when given, else the
    rank modulo the GPUs of this host (one host: the rank)."""
    if cfg is None:
        return 0
    if cfg.local_rank is not None:
        return cfg.local_rank
    import torch

    return cfg.process_id % max(1, torch.cuda.device_count())


def maybe_initialize_from_env(
    *, device="cuda", env=os.environ, timeout_s: float = 600.0
) -> Optional[DistributedConfig]:
    """Join the process group the env describes; else a no-op returning
    None.

    ``device`` picks the backend: NCCL for CUDA (the process then drives
    ``cuda:<local rank>``), gloo for the CPU.  A process group already
    made (by the caller, or an earlier call) is kept and checked against
    the env.  Raises when the group's world size differs from the env's
    process count."""
    cfg = DistributedConfig.from_env(env)
    if cfg is None:
        return None
    import torch
    import torch.distributed as dist

    global _JOINED_CUDA_INDEX
    on_cuda = torch.device(device).type == "cuda"
    if not dist.is_initialized():
        if on_cuda:
            torch.cuda.set_device(local_device_index(cfg))
        dist.init_process_group(
            "nccl" if on_cuda else "gloo",
            init_method=cfg.init_method(),
            world_size=cfg.num_processes,
            rank=cfg.process_id,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
    if dist.get_world_size() != cfg.num_processes:
        raise RuntimeError(
            f"distributed init: expected {cfg.num_processes} processes, "
            f"the process group has {dist.get_world_size()}"
        )
    if dist.get_rank() != cfg.process_id:
        raise RuntimeError(
            f"distributed init: the env names rank {cfg.process_id}, the "
            f"process group's rank is {dist.get_rank()}"
        )
    if on_cuda:
        # The calling thread's device: the one set above, or the caller's
        # when it made the group.  The runner's worker threads start on
        # device 0, so the collectives read this and not theirs.
        _JOINED_CUDA_INDEX = torch.cuda.current_device()
    log.info(
        "joined process group %s as rank %d/%d (%s)",
        cfg.coordinator_address, cfg.process_id, cfg.num_processes,
        dist.get_backend(),
    )
    return cfg


# ---------------------------------------------------- runner collectives

# The card this process drives, recorded when it joins the group on CUDA.
_JOINED_CUDA_INDEX: Optional[int] = None

_COLLECTIVES: Dict[str, int] = {"broadcast": 0, "allgather": 0, "barrier": 0}
_COLLECTIVES_LOCK = threading.Lock()


def _issued(kind: str) -> None:
    with _COLLECTIVES_LOCK:
        _COLLECTIVES[kind] += 1


def collectives_issued() -> Dict[str, int]:
    """The runner collectives this process issued since the last reset
    (``broadcast_json`` is two broadcasts)."""
    with _COLLECTIVES_LOCK:
        return dict(_COLLECTIVES)


def reset_collectives_issued() -> None:
    with _COLLECTIVES_LOCK:
        for kind in _COLLECTIVES:
            _COLLECTIVES[kind] = 0


def process_index() -> int:
    """This process's global rank in the default group; 0 without one."""
    return process_topology()[0]


def _collective_device():
    """Where the default group's backend takes its tensors: for NCCL the
    card this process joined the group on (held by reading: one card runs
    two ranks over gloo only), the CPU otherwise.  Not the calling thread's
    current device: the runner issues its collectives from a worker thread,
    which starts on device 0 whatever the process drives."""
    import torch
    import torch.distributed as dist

    if dist.get_backend() != "nccl":
        return torch.device("cpu")
    if _JOINED_CUDA_INDEX is not None:
        return torch.device("cuda", _JOINED_CUDA_INDEX)
    # A group the caller made without maybe_initialize_from_env: the env's
    # local rank, else the rank modulo the host's cards.
    local = os.environ.get(ENV_LOCAL_RANK)
    return torch.device("cuda", int(local) if local is not None else
                        dist.get_rank() % max(1, torch.cuda.device_count()))


def broadcast_int(value: int) -> int:
    """Process 0's ``value`` on every process (one broadcast)."""
    import torch
    import torch.distributed as dist

    t = torch.tensor([int(value)], dtype=torch.int64,
                     device=_collective_device())
    dist.broadcast(t, src=0)
    _issued("broadcast")
    return int(t.item())


def broadcast_json(obj: Any) -> Any:
    """Process 0's JSON-serializable ``obj`` on every process: its length,
    then the bytes padded to it (workers do not know the size up front)."""
    import torch
    import torch.distributed as dist

    data = json.dumps(obj).encode()
    n = broadcast_int(len(data))
    buf = torch.zeros(n, dtype=torch.uint8)
    own = torch.frombuffer(bytearray(data), dtype=torch.uint8) if data else buf
    buf[: min(n, len(data))] = own[:n]
    buf = buf.to(_collective_device())
    dist.broadcast(buf, src=0)
    _issued("broadcast")
    return json.loads(bytes(buf.cpu().numpy()).decode())


def allgather_int(value: int) -> List[int]:
    """Every process's ``value``, in rank order."""
    import torch
    import torch.distributed as dist

    device = _collective_device()
    mine = torch.tensor([int(value)], dtype=torch.int64, device=device)
    out = [torch.zeros_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(out, mine)
    _issued("allgather")
    return [int(t.item()) for t in out]


def barrier() -> None:
    """Every process of the default group reaches this point before any
    leaves it (an all-reduce of one element, on the backend's device)."""
    import torch
    import torch.distributed as dist

    dist.all_reduce(torch.zeros(1, device=_collective_device()))
    _issued("barrier")
