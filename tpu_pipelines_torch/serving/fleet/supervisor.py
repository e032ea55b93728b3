"""Replica supervision: health probes, circuit breaking, self-healing.

The port of ``tpu_pipelines/serving/fleet/supervisor.py``.  The router
costs replicas by queue depth x EWMA latency — a *load* signal.  It has
no *health* signal: a replica whose device died or whose batcher worker
wedged keeps its (stale, attractive) cost and keeps receiving traffic
forever.  This module closes that gap:

  - :class:`ReplicaSupervisor` probes every replica each interval — a
    tiny device op on the replica's stream as heartbeat, batcher queue-age
    wedge detection, and the replica's own request outcomes — and drives
    a HEALTHY -> DEGRADED -> EJECTED state machine.  An EJECTED replica
    is rebuilt in place (new private batcher, engines re-created and
    re-captured from the version manager's resident versions) and
    re-admitted through its breaker's half-open probe.
  - :class:`CircuitBreaker` (per replica, closed/open/half-open with
    single-probe re-admission) is consulted by the router's pick via
    :meth:`ReplicaSupervisor.allow`, so an open breaker sheds routing
    *before* queues grow — requests never wait out a timeout against a
    replica the supervisor already knows is dead.
  - :class:`FleetUnavailable` makes all-replicas-down a structured
    failure (HTTP 503 + Retry-After) instead of a hang against a closed
    set.

Everything here is opt-in: a fleet built without supervisor knobs has no
supervisor, no breaker gate on the router, and none of the metric
families below.

  ====================================  ==================================
  serving_replica_state{replica}        0 healthy / 1 degraded / 2 ejected
  serving_breaker_transitions_total{replica}  breaker state changes
  ====================================  ==================================

(The fleet-level ``serving_failovers_total``,
``serving_fleet_unavailable_total`` and
``serving_decode_sessions_recovered_total`` counters live on
:class:`ServingFleet`, which owns the failover and recovery paths.)
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional, Tuple

logger = logging.getLogger(__name__)

# Replica states, in gauge order (serving_replica_state values).
HEALTHY = "healthy"
DEGRADED = "degraded"
EJECTED = "ejected"
_STATE_GAUGE = {HEALTHY: 0, DEGRADED: 1, EJECTED: 2}

# Breaker states.
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class FleetUnavailable(RuntimeError):
    """Every replica is ejected or breaker-open: the fleet cannot serve
    this request *now*, but capacity is being rebuilt — the client should
    retry after a beat (HTTP 503 + Retry-After), not queue into a dead
    set."""

    retry_after_s = 1


class CircuitBreaker:
    """Per-replica circuit breaker: closed / open / half-open.

    ``threshold`` consecutive failures open the breaker; after
    ``open_s`` the next :meth:`allow` admits exactly ONE probe request
    (half-open).  The probe's outcome decides: success closes the
    breaker, failure re-opens it for another ``open_s``.  ``clock`` is
    injectable so the open->half-open timing is table-testable."""

    def __init__(
        self,
        threshold: int = 3,
        open_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Optional[Callable[[str, str], None]] = None,
    ):
        self.threshold = max(1, int(threshold))
        self.open_s = float(open_s)
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False

    def _transition(self, to: str) -> None:
        frm, self._state = self._state, to
        if frm != to and self._on_transition is not None:
            self._on_transition(frm, to)

    @property
    def state(self) -> str:
        with self._lock:
            if (
                self._state == OPEN
                and self._clock() - self._opened_at >= self.open_s
            ):
                self._transition(HALF_OPEN)
            return self._state

    def allow(self) -> bool:
        """May a request be routed through?  In half-open, admits exactly
        one in-flight probe; its recorded outcome re-arms admission."""
        state = self.state  # side effect: OPEN -> HALF_OPEN on timeout
        with self._lock:
            if state == CLOSED:
                return True
            if self._state == HALF_OPEN and not self._probe_inflight:
                self._probe_inflight = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_inflight = False
            if self._state != CLOSED:
                self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            half_open_probe = self._probe_inflight
            self._probe_inflight = False
            if self._state == HALF_OPEN or (
                self._state == CLOSED and self._failures >= self.threshold
            ):
                self._opened_at = self._clock()
                self._transition(OPEN)
            elif self._state == OPEN and half_open_probe:
                self._opened_at = self._clock()

    def trip(self) -> None:
        """Force-open (replica ejected): nothing routes until the replica
        is rebuilt and a probe succeeds."""
        with self._lock:
            self._opened_at = self._clock()
            if self._state != OPEN:
                self._transition(OPEN)


class ReplicaSupervisor:
    """Probe every replica, keep a per-replica state machine + breaker,
    rebuild ejected replicas in place.

    ``probe_once()`` runs one full supervision pass synchronously (what
    the background thread calls each ``interval_s``), so tests drive the
    state machine deterministically without sleeping."""

    def __init__(
        self,
        pool,
        *,
        interval_s: float = 0.25,
        queue_age_s: float = 2.0,
        eject_failures: int = 2,
        breaker_failures: int = 3,
        breaker_open_s: float = 0.0,
        registry=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.pool = pool
        self.interval_s = float(interval_s)
        self.queue_age_s = float(queue_age_s)
        self.eject_failures = max(1, int(eject_failures))
        self._clock = clock
        self._lock = threading.Lock()
        self._states: Dict[str, str] = {}
        self._consecutive: Dict[str, int] = {}
        self._m_state = None
        self._m_transitions = None
        if registry is not None:
            self._m_state = registry.gauge(
                "serving_replica_state",
                "Supervisor verdict for this replica: 0 healthy, "
                "1 degraded, 2 ejected.",
                labels=("replica",),
            )
            self._m_transitions = registry.counter(
                "serving_breaker_transitions_total",
                "Circuit-breaker state changes on this replica "
                "(closed<->open<->half_open).",
                labels=("replica",),
            )
        self.breakers: Dict[str, CircuitBreaker] = {}
        open_s = breaker_open_s if breaker_open_s > 0 else max(
            2 * self.interval_s, 0.1
        )
        for replica in pool.replicas:
            name = replica.name
            self._states[name] = HEALTHY
            self._consecutive[name] = 0
            self.breakers[name] = CircuitBreaker(
                threshold=breaker_failures,
                open_s=open_s,
                clock=clock,
                on_transition=self._transition_cb(name),
            )
            self._set_state(name, HEALTHY)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _transition_cb(self, name: str):
        def cb(frm: str, to: str) -> None:
            if self._m_transitions is not None:
                self._m_transitions.labels(name).inc()
            logger.info("replica %s breaker %s -> %s", name, frm, to)
        return cb

    def _set_state(self, name: str, state: str) -> None:
        self._states[name] = state
        if self._m_state is not None:
            self._m_state.labels(name).set(_STATE_GAUGE[state])

    # ------------------------------------------------------------ routing

    def state(self, replica) -> str:
        return self._states.get(getattr(replica, "name", replica), HEALTHY)

    def allow(self, replica) -> bool:
        """The router's gate: an EJECTED replica never serves; otherwise
        the breaker decides (half-open admits its single probe)."""
        name = replica.name
        if self._states.get(name) == EJECTED:
            return False
        breaker = self.breakers.get(name)
        return True if breaker is None else breaker.allow()

    # --------------------------------------------------- request outcomes

    def on_request_error(self, replica, exc: BaseException) -> None:
        """A request failed on this replica: feed the breaker so repeated
        failures shed routing *between* probe intervals."""
        self.breakers[replica.name].record_failure()

    def on_request_success(self, replica) -> None:
        self.breakers[replica.name].record_success()

    # ------------------------------------------------------------- probes

    def _probe(self, replica) -> Tuple[bool, str]:
        """One health verdict: queue-age wedge check, then the
        device-committed heartbeat (which also trips on an injected or
        latched replica kill)."""
        try:
            age = replica.batcher.oldest_work_age_s()
        except Exception:  # pragma: no cover - defensive
            age = 0.0
        if self.queue_age_s > 0 and age > self.queue_age_s:
            return False, f"wedged: oldest work {age:.2f}s in queue"
        try:
            replica.heartbeat()
        except Exception as e:  # noqa: BLE001 — any failure = unhealthy
            return False, f"heartbeat: {type(e).__name__}: {e}"
        return True, "ok"

    def probe_once(self) -> Dict[str, Tuple[str, str]]:
        """One supervision pass over the fleet.  Returns
        ``{replica_name: (state, reason)}`` for observability/tests."""
        report: Dict[str, Tuple[str, str]] = {}
        for replica in self.pool.replicas:
            name = replica.name
            with self._lock:
                state = self._states[name]
                if state == EJECTED:
                    # Rebuild-in-place, then fall through to a probe: a
                    # healthy rebuild re-admits within ONE pass.
                    try:
                        replica.rebuild()
                    except Exception as e:  # noqa: BLE001
                        logger.warning(
                            "replica %s rebuild failed: %s", name, e
                        )
                        report[name] = (EJECTED, f"rebuild failed: {e}")
                        continue
                ok, reason = self._probe(replica)
                breaker = self.breakers[name]
                if ok:
                    self._consecutive[name] = 0
                    breaker.record_success()
                    if state != HEALTHY:
                        logger.info(
                            "replica %s %s -> healthy", name, state
                        )
                    self._set_state(name, HEALTHY)
                    report[name] = (HEALTHY, reason)
                else:
                    self._consecutive[name] += 1
                    breaker.record_failure()
                    if (
                        state != EJECTED
                        and self._consecutive[name] >= self.eject_failures
                    ):
                        logger.warning(
                            "replica %s ejected (%s)", name, reason
                        )
                        breaker.trip()
                        self._set_state(name, EJECTED)
                        report[name] = (EJECTED, reason)
                    else:
                        if state == HEALTHY:
                            logger.warning(
                                "replica %s degraded (%s)", name, reason
                            )
                        self._set_state(
                            name,
                            EJECTED if state == EJECTED else DEGRADED,
                        )
                        report[name] = (self._states[name], reason)
        return report

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="replica-supervisor", daemon=True
        )
        self._thread.start()

    def stop(self, timeout_s: float = 2.0) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout_s)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.probe_once()
            except Exception:  # pragma: no cover - supervisor never dies
                logger.exception("supervisor probe pass failed")
