"""ReplicaPool: the replica set behind the router, with bounded shutdown.

The port of ``tpu_pipelines/serving/fleet/pool.py``.  ``close(timeout_s=)``
sends every replica batcher its close sentinel first, so all of them drain
at once, then joins them against one shared deadline: a fleet's shutdown
is bounded by ``timeout_s`` in all, not per replica.  With a supervisor,
request outcomes feed its breakers and a transient failure fails over once
to a healthy replica.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np

from tpu_pipelines_torch.robustness.errors import PERMANENT, classify_error
from tpu_pipelines_torch.serving.fleet.replica import Replica
from tpu_pipelines_torch.serving.fleet.router import LatencyAwareRouter


class ReplicaPool:
    def __init__(self, replicas: List[Replica], router=None):
        if not replicas:
            raise ValueError("ReplicaPool needs at least one replica")
        self.replicas = list(replicas)
        self.router = router or LatencyAwareRouter()
        self._closed = False
        # Set by the fleet when the supervisor is on; both None = no
        # breaker feed and no failover.
        self.supervisor = None
        self.on_failover = None

    def __len__(self) -> int:
        return len(self.replicas)

    def queue_depth(self) -> int:
        """Fleet-wide queued + in-flight work (admission control input)."""
        return sum(r.queue_depth() for r in self.replicas)

    def submit(
        self, batch: Dict[str, Any], n_rows: int, timeout_s: float = 300.0,
        ctx=None,
    ) -> np.ndarray:
        if ctx is None:
            replica = self.router.pick(self.replicas)
        else:
            # A traced request records the route decision: the chosen
            # replica and what every replica cost at that instant.
            replica, costs = self.router.pick_with_costs(self.replicas)
            ctx.instant("route", replica=replica.name, costs=costs)
        sup = self.supervisor
        if sup is None:
            return replica.submit(batch, n_rows, timeout_s=timeout_s, ctx=ctx)
        try:
            out = replica.submit(batch, n_rows, timeout_s=timeout_s, ctx=ctx)
        except Exception as e:  # noqa: BLE001 — classified below
            sup.on_request_error(replica, e)
            if classify_error(e) == PERMANENT:
                # The request's own fault: a failover would reproduce it.
                raise
            survivors = [
                r for r in self.replicas if r is not replica and sup.allow(r)
            ]
            if not survivors:
                from tpu_pipelines_torch.serving.fleet.supervisor import (
                    FleetUnavailable,
                )

                raise FleetUnavailable(
                    "request failed and no healthy replica remains"
                ) from e
            # Predict is idempotent: retry exactly once on a survivor; a
            # second failure surfaces (one failover absorbs a dying
            # replica, it must not mask an outage).
            retry = self.router.pick(survivors)
            if self.on_failover is not None:
                self.on_failover()
            if ctx is not None:
                ctx.instant(
                    "failover", from_replica=replica.name,
                    to_replica=retry.name, error=f"{type(e).__name__}: {e}",
                )
            out = retry.submit(batch, n_rows, timeout_s=timeout_s, ctx=ctx)
            sup.on_request_success(retry)
            return out
        sup.on_request_success(replica)
        return out

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self, timeout_s: float = 5.0) -> None:
        """Parallel drain: sentinel every batcher, then join all against a
        shared deadline; engines share the deadline too."""
        self._closed = True
        for r in self.replicas:
            r.batcher.request_close()
        deadline = time.monotonic() + timeout_s
        for r in self.replicas:
            r.batcher.join_close(max(0.0, deadline - time.monotonic()))
        for r in self.replicas:
            r.close_engines(max(0.0, deadline - time.monotonic()))
