"""Serving fleet: multi-replica, multi-version serving over one card.

The port of ``tpu_pipelines/serving/fleet/``.  On top of the single
``ModelServer``'s payloads and REST surface:

  - :class:`ModelVersionManager` — N model versions resident at once,
    atomic canary-gated hot-swap (load outside the lock, swap under it,
    the old version drained, then evicted);
  - :class:`Replica` — one micro-batcher + model runner per replica, on
    its own CUDA stream, with per-replica queue-depth and EWMA-p99
    telemetry (``serving_replica_*`` gauges);
  - :class:`LatencyAwareRouter` — picks the replica with the least
    estimated work (queue depth x EWMA p99);
  - :class:`ReplicaPool` — the replicas behind the router; ``close``
    drains every replica batcher in parallel against one timeout;
  - :class:`ServingFleet` — the facade ``ModelServer`` routes through
    (``replicas`` / ``max_versions`` / ``model_type`` knobs); its canary
    gate captures each version's predict buckets (``serving/aot.py``) and
    engine steps as CUDA graphs before the version is eligible;
  - :class:`ReplicaSupervisor` — opt-in self-healing: heartbeat and
    queue-age probes drive HEALTHY/DEGRADED/EJECTED per replica, a
    circuit breaker gates routing, ejected replicas rebuild in place, and
    all-replicas-down is :class:`FleetUnavailable` (HTTP 503).
"""

from tpu_pipelines_torch.serving.fleet.fleet import ServingFleet  # noqa: F401
from tpu_pipelines_torch.serving.fleet.pool import ReplicaPool  # noqa: F401
from tpu_pipelines_torch.serving.fleet.replica import (  # noqa: F401
    LatencyTracker,
    Replica,
)
from tpu_pipelines_torch.serving.fleet.router import (  # noqa: F401
    LatencyAwareRouter,
)
from tpu_pipelines_torch.serving.fleet.supervisor import (  # noqa: F401
    CircuitBreaker,
    FleetUnavailable,
    ReplicaSupervisor,
)
from tpu_pipelines_torch.serving.fleet.versions import (  # noqa: F401
    CanaryRefused,
    ModelVersionManager,
)
