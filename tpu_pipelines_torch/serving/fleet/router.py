"""Latency-aware replica selection.

The port of ``tpu_pipelines/serving/fleet/router.py``: each replica is
scored by its estimated wait, observed queue depth x EWMA p99 latency
(:meth:`Replica.routing_cost`), and the request goes to the cheapest one,
with a rotating tie-break so equal replicas share load instead of herding
onto index 0.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

from tpu_pipelines_torch.serving.fleet.replica import Replica


class LatencyAwareRouter:
    """Pick-min-cost over the replica set; thread-safe, stateless apart
    from the tie-break rotation.

    ``gate`` is the supervision hook: with a :class:`ReplicaSupervisor`,
    its ``allow`` is installed here so an ejected replica or an open
    circuit breaker sheds routing before its queue grows.  ``gate=None``
    routes every replica."""

    def __init__(self, gate=None):
        self._rr = 0
        self._lock = threading.Lock()
        self.gate = gate

    def pick(self, replicas: Sequence[Replica]) -> Replica:
        if not replicas:
            raise RuntimeError("replica pool is empty")
        if len(replicas) == 1:
            if self.gate is not None and not self.gate(replicas[0]):
                from tpu_pipelines_torch.serving.fleet.supervisor import (
                    FleetUnavailable,
                )

                raise FleetUnavailable(
                    "the only replica is ejected or breaker-open"
                )
            return replicas[0]
        return self.pick_with_costs(replicas)[0]

    def pick_with_costs(
        self, replicas: Sequence[Replica]
    ) -> Tuple[Replica, Dict[str, Optional[float]]]:
        """The pick plus every replica's routing cost at decision time
        (None for a replica the gate shed)."""
        if not replicas:
            raise RuntimeError("replica pool is empty")
        with self._lock:
            start = self._rr % len(replicas)
            self._rr += 1
        best = None
        best_cost = float("inf")
        costs: Dict[str, Optional[float]] = {}
        for off in range(len(replicas)):
            r = replicas[(start + off) % len(replicas)]
            if self.gate is not None and not self.gate(r):
                # Shed, not costed: an open breaker's stale cost must not win.
                costs[r.name] = None
                continue
            cost = r.routing_cost()
            costs[r.name] = round(cost, 6)
            if cost < best_cost:
                best, best_cost = r, cost
        if best is None:
            from tpu_pipelines_torch.serving.fleet.supervisor import (
                FleetUnavailable,
            )

            raise FleetUnavailable("every replica is ejected or breaker-open")
        return best, costs
