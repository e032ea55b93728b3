"""ShardPlan: how many shards the data plane fans out to, and a thread map.

The port's trimmed copy of ``tpu_pipelines/data/shard_plan.py``:

  * **How many shards?**  ``ShardPlan.resolve(param)``: an explicit component
    parameter wins, then the ``TPP_DATA_SHARDS`` env var, then ``host_cpus``
    (capped at ``MAX_DEFAULT_SHARDS``).
  * **How to run per-shard work?**  ``thread_map``: a thread pool, order
    preserved (numpy reductions and file IO release the GIL).

The reference's process pools (``map_shards``, ``map_shards_resilient``
with per-shard retry and quarantine), its fault hooks and its metric
federation wait (``ROADMAP.md`` A21); ``map_shards`` raises, naming it.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, TypeVar

ENV_SHARDS = "TPP_DATA_SHARDS"
# Worker-count override (testing / oversubscribed hosts).
ENV_POOL_WORKERS = "TPP_DATA_POOL_WORKERS"
MAX_DEFAULT_SHARDS = 8

T = TypeVar("T")
R = TypeVar("R")


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Resolved shard count for one component execution.

    ``source`` records which rung of the precedence ladder decided
    (``param`` > ``env`` > ``host_cpus``).
    """

    num_shards: int
    source: str = "host_cpus"

    def __post_init__(self):
        if self.num_shards < 1:
            raise ValueError(
                f"num_shards must be >= 1, got {self.num_shards}"
            )

    @classmethod
    def resolve(cls, param: Optional[int] = None) -> "ShardPlan":
        """Precedence: explicit component parameter > TPP_DATA_SHARDS env >
        host CPU count (capped at MAX_DEFAULT_SHARDS)."""
        if param is not None:
            return cls(int(param), "param")
        env = os.environ.get(ENV_SHARDS, "").strip()
        if env:
            return cls(int(env), "env")
        return cls(
            min(os.cpu_count() or 1, MAX_DEFAULT_SHARDS), "host_cpus"
        )


def _pool_workers(n_tasks: int, workers: Optional[int]) -> int:
    """Effective worker count: TPP_DATA_POOL_WORKERS overrides everything,
    then the caller's cap, then min(tasks, host cpus)."""
    env = os.environ.get(ENV_POOL_WORKERS, "").strip()
    if env:
        return max(1, min(int(env), n_tasks))
    if workers is not None:
        return max(1, min(workers, n_tasks))
    return max(1, min(n_tasks, os.cpu_count() or 1))


def thread_map(
    fn: Callable[[T], R],
    tasks: Sequence[T],
    workers: Optional[int] = None,
) -> List[R]:
    """``[fn(t) for t in tasks]`` through a thread pool, order preserved."""
    workers = _pool_workers(len(tasks), workers)
    if len(tasks) <= 1 or workers <= 1:
        return [fn(t) for t in tasks]
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(fn, tasks))


def map_shards(fn, tasks, workers=None):
    raise NotImplementedError(
        "process-pool shard maps are not ported yet (ROADMAP.md A21); "
        "use thread_map"
    )
