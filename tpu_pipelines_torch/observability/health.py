"""Health watchdogs: NaN and loss-spike detection on the train loop's
heartbeat.

The port's copy of ``HealthMonitor`` from
``tpu_pipelines/observability/health.py``, trimmed to what the port's
train loop uses: the loop calls :meth:`HealthMonitor.heartbeat` with every
step it has a host loss for, and a non-finite loss or one above
``loss_spike_factor`` times the trailing-window mean fires an alert.  Every
alert increments ``watchdog_alerts_total{monitor,kind}`` in the metrics
registry, logs a warning and calls the optional ``on_alert(kind, detail)``
callback.

The stall watchdog thread, trace instants and the ``/healthz`` status
payload wait for a later slice (``ROADMAP.md`` A11); this monitor starts
no thread and opens nothing.
"""

from __future__ import annotations

import logging
import math
import threading
from collections import deque
from typing import Callable, List, Optional

from tpu_pipelines_torch.observability.metrics import (
    MetricsRegistry,
    default_registry,
)

log = logging.getLogger("tpu_pipelines_torch.health")


class HealthMonitor:
    """NaN and loss-spike watchdogs for one loop."""

    def __init__(
        self,
        name: str = "train",
        *,
        loss_spike_factor: float = 10.0,
        loss_window: int = 20,
        on_alert: Optional[Callable[[str, str], None]] = None,
        registry: Optional[MetricsRegistry] = None,
    ):
        self.name = name
        self.loss_spike_factor = float(loss_spike_factor)
        self.on_alert = on_alert
        self._lock = threading.Lock()
        self._losses: deque = deque(maxlen=max(1, int(loss_window)))
        self._alerts_total = (registry or default_registry()).counter(
            "watchdog_alerts_total",
            "Health watchdog alerts fired, by monitor and kind.",
            labels=("monitor", "kind"),
        )

    def heartbeat(
        self, step: Optional[int] = None, loss: Optional[float] = None
    ) -> None:
        """Run the NaN/spike checks on step ``step``'s host loss."""
        fire: List[tuple] = []
        with self._lock:
            if loss is not None:
                loss = float(loss)
                if math.isnan(loss) or math.isinf(loss):
                    fire.append((
                        "nan",
                        f"non-finite loss {loss!r} at step {step}",
                    ))
                else:
                    if len(self._losses) == self._losses.maxlen:
                        mean = sum(self._losses) / len(self._losses)
                        if (
                            mean > 0
                            and loss > self.loss_spike_factor * mean
                        ):
                            fire.append((
                                "loss_spike",
                                f"loss {loss:.6g} exceeds "
                                f"{self.loss_spike_factor:g}x trailing "
                                f"mean {mean:.6g} at step {step}",
                            ))
                    self._losses.append(loss)
        for kind, detail in fire:
            self._fire(kind, detail)

    def _fire(self, kind: str, detail: str) -> None:
        self._alerts_total.labels(monitor=self.name, kind=kind).inc()
        log.warning("health[%s]: %s alert: %s", self.name, kind, detail)
        if self.on_alert is not None:
            try:
                self.on_alert(kind, detail)
            except Exception:  # noqa: BLE001 — a bad pager hook must not
                log.exception("health[%s]: on_alert callback failed",
                              self.name)  # kill the monitored loop
