"""Health watchdogs: heartbeat liveness, stall/NaN/loss-spike detection.

The port's copy of ``tpu_pipelines/observability/health.py``.  A
:class:`HealthMonitor` turns a silent stall (a wedged input pipeline, a
hung device) or a silent divergence (a NaN loss, a loss spike) into an
event:

  * the train loop calls :meth:`HealthMonitor.heartbeat` for every step
    it has a host loss for (two attribute writes under a lock);
  * a background watchdog thread (started only when a stall timeout is
    configured: ``TPP_STALL_TIMEOUT_S`` or the constructor argument)
    fires when no heartbeat lands within the timeout;
  * every alert increments ``watchdog_alerts_total{monitor,kind}`` in the
    metrics registry, emits a ``health/watchdog_alert`` instant into the
    active run trace (a no-op outside a traced run), logs a warning and
    calls the optional ``on_alert(kind, detail)`` callback.

Alerts are edge-triggered per episode: a stall fires once and re-arms on
the next heartbeat; NaN fires once per NaN observation; a loss spike
fires when the loss exceeds ``loss_spike_factor`` times the trailing
mean.  :meth:`status` is the ``/healthz`` payload (healthy = no active
stall and no NaN seen); the runner's telemetry server (``_RunTelemetry``,
``TPP_METRICS_PORT``) serves the status of every open monitor
(:func:`open_monitors`) in its ``/healthz``.

On the card the train loop learns of its steps once per window (one host
fetch a window), so its heartbeats land at window cadence: a stall
timeout must exceed a window's wall time, the capture of the first
window included, or a healthy run pages.

Zero footprint when idle: no thread without a stall timeout, no files,
no sockets.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from tpu_pipelines_torch.observability import trace as _trace
from tpu_pipelines_torch.observability.metrics import (
    MetricsRegistry,
    default_registry,
)

log = logging.getLogger("tpu_pipelines_torch.health")

ENV_STALL_TIMEOUT = "TPP_STALL_TIMEOUT_S"

# The monitors open in this process (registered at construction, removed
# at close), whose status the runner's /healthz serves.
_open: "List[HealthMonitor]" = []
_open_lock = threading.Lock()


def open_monitors() -> "List[HealthMonitor]":
    """The monitors constructed and not yet closed, oldest first."""
    with _open_lock:
        return list(_open)


def stall_timeout_from_env(default: float = 0.0) -> float:
    """``TPP_STALL_TIMEOUT_S`` as a float, 0/unset/garbage = disabled."""
    raw = os.environ.get(ENV_STALL_TIMEOUT, "").strip()
    if not raw:
        return default
    try:
        return max(0.0, float(raw))
    except ValueError:
        log.warning("ignoring non-numeric %s=%r", ENV_STALL_TIMEOUT, raw)
        return default


class HealthMonitor:
    """Heartbeat tracker + stall/NaN/loss-spike watchdogs for one loop.

    ``stall_timeout_s=None`` reads ``TPP_STALL_TIMEOUT_S`` (0 = the
    stall watchdog thread is never started; NaN/spike checks still run
    inline on whatever losses are reported).
    """

    def __init__(
        self,
        name: str = "train",
        *,
        stall_timeout_s: Optional[float] = None,
        loss_spike_factor: float = 10.0,
        loss_window: int = 20,
        on_alert: Optional[Callable[[str, str], None]] = None,
        registry: Optional[MetricsRegistry] = None,
    ):
        self.name = name
        self.stall_timeout_s = (
            stall_timeout_from_env() if stall_timeout_s is None
            else max(0.0, float(stall_timeout_s))
        )
        self.loss_spike_factor = float(loss_spike_factor)
        self.on_alert = on_alert
        self._lock = threading.Lock()
        self._losses: deque = deque(maxlen=max(1, int(loss_window)))
        self._last_beat: Optional[float] = None  # monotonic
        self._last_step: Optional[int] = None
        self._stalled = False
        self._nan_seen = False
        self._alerts: List[Dict[str, Any]] = []
        self._closed = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._alerts_total = (registry or default_registry()).counter(
            "watchdog_alerts_total",
            "Health watchdog alerts fired, by monitor and kind.",
            labels=("monitor", "kind"),
        )
        with _open_lock:
            _open.append(self)

    # ------------------------------------------------------------ heartbeat

    def heartbeat(
        self, step: Optional[int] = None, loss: Optional[float] = None
    ) -> None:
        """Record liveness (every step) and optionally a host loss
        value (log cadence) for the NaN/spike checks."""
        fire: List[tuple] = []
        with self._lock:
            self._last_beat = time.monotonic()
            if step is not None:
                self._last_step = int(step)
            if self._stalled:
                self._stalled = False  # re-arm: progress resumed
            if loss is not None:
                loss = float(loss)
                if math.isnan(loss) or math.isinf(loss):
                    self._nan_seen = True
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
        # Lazy thread start: the first heartbeat proves the monitored
        # loop actually runs, so a configured-but-never-entered loop
        # costs no thread.
        if (
            self.stall_timeout_s > 0
            and self._thread is None
            and not self._closed.is_set()
        ):
            self._start_watchdog()

    # ------------------------------------------------------------- watchdog

    def _start_watchdog(self) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._watch,
                name=f"tpp-health-{self.name}",
                daemon=True,
            )
            self._thread.start()

    def _watch(self) -> None:
        poll = max(0.01, min(1.0, self.stall_timeout_s / 4.0))
        while not self._closed.wait(poll):
            with self._lock:
                beat = self._last_beat
                stalled = self._stalled
            if beat is None or stalled:
                continue
            age = time.monotonic() - beat
            if age > self.stall_timeout_s:
                with self._lock:
                    self._stalled = True
                self._fire(
                    "stall",
                    f"no heartbeat for {age:.1f}s "
                    f"(timeout {self.stall_timeout_s:g}s, last step "
                    f"{self._last_step})",
                )

    def _fire(self, kind: str, detail: str) -> None:
        self._alerts_total.labels(monitor=self.name, kind=kind).inc()
        with self._lock:
            self._alerts.append({
                "kind": kind,
                "detail": detail,
                "ts": time.time(),
                "step": self._last_step,
            })
        _trace.instant(
            "watchdog_alert", cat="health",
            args={"monitor": self.name, "kind": kind, "detail": detail,
                  "step": self._last_step},
        )
        log.warning("health[%s]: %s alert: %s", self.name, kind, detail)
        if self.on_alert is not None:
            try:
                self.on_alert(kind, detail)
            except Exception:  # noqa: BLE001 — a bad pager hook must not
                log.exception("health[%s]: on_alert callback failed",
                              self.name)  # kill the monitored loop

    # --------------------------------------------------------------- status

    def status(self) -> Dict[str, Any]:
        """The ``/healthz`` payload: liveness + alert history."""
        with self._lock:
            beat = self._last_beat
            return {
                "monitor": self.name,
                "healthy": not (self._stalled or self._nan_seen),
                "stalled": self._stalled,
                "nan_seen": self._nan_seen,
                "last_step": self._last_step,
                "last_heartbeat_age_s": (
                    round(time.monotonic() - beat, 3)
                    if beat is not None else None
                ),
                "stall_timeout_s": self.stall_timeout_s,
                "alerts": list(self._alerts),
            }

    @property
    def alerts(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._alerts)

    def close(self) -> None:
        with _open_lock:
            if self in _open:
                _open.remove(self)
        self._closed.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
