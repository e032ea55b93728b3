"""Fault injection: prove the runner's and the serving fleet's failure
semantics.

The port of ``tpu_pipelines/testing/faults.py``: the failure modes a
preemptible fleet produces, injected at the exact point where they occur.

  ==================== =====================================================
  kind                 fires at
  ==================== =====================================================
  RAISE                inside the executor attempt (a transient executor bug)
  RAISE_AFTER          inside the executor attempt, once the executor
                       returned (a process of a multi-process node that
                       fails after its collectives, writing its outputs)
  HANG                 inside the executor attempt; blocks on the runner's
                       cancel event (a stuck ``urlopen``), released by the
                       deadline watchdog, so a hang leaves no thread behind
  CRASH_BEFORE_PUBLISH after the executor succeeded, before the publisher's
                       store write (a RUNNING execution and written payload
                       dirs left behind: the state a resume must fence)
  CRASH_AFTER_PUBLISH  right after the COMPLETE publish landed (the state a
                       resume must adopt as it is)
  KILL_ORCHESTRATOR    at node dispatch, in the scheduler thread (eviction,
                       OOM, Ctrl-C mid-run)
  TRANSIENT_EXECUTOR_  inside the executor attempt: a ``TransientError``,
  ERROR                ``times`` times, then clean (classified-retry bait)
  KILL_SHARD_WORKER    inside a shard-pool fork child (key ``SHARD_KEY``):
                       ``os._exit``, the preempted-worker shape the pool's
                       replacement-worker path must absorb
  STORE_CONTENTION     inside a store write transaction (key
                       ``STORE_KEY``): a transient StoreUnavailableError,
                       ``times`` times (multi-writer SQLITE_BUSY shape)
  RELOAD_DURING_HAMMER per serving request (key ``SERVING_KEY``): after the
                       ``after``-th request, hot-reload the model in a
                       background thread mid-storm
  KILL_REPLICA         per replica call (key ``REPLICA_KEY``): after the
                       ``after``-th call fleet-wide, the targeted replica's
                       current generation is latched dead until a rebuild
  WEDGE_PREDICT        per replica call: ``times`` calls park on the
                       fault's ``release`` event (queue age grows)
  DEVICE_ERROR         per replica call: ``times`` calls raise a transient
                       device error (failover bait)
  ==================== =====================================================

The crash kinds raise :class:`SimulatedCrash`, a ``BaseException`` no
``except Exception`` can swallow, so the metadata store is left as a
SIGKILL would leave it.  Each node fault fires once per plan (``times``
for the counted kinds), so the node runs clean on resume.

Usage::

    plan = FaultPlan({"Trainer": NodeFault(CRASH_BEFORE_PUBLISH)})
    with plan.activate():
        with pytest.raises(SimulatedCrash):
            LocalDagRunner(device="cpu").run(pipeline)
    LocalDagRunner(device="cpu").run(pipeline, resume_from="latest")

The hooks cost one module-global read when no plan is active.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import threading
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

RAISE = "raise"
RAISE_AFTER = "raise_after"
HANG = "hang"
CRASH_BEFORE_PUBLISH = "crash_before_publish"
CRASH_AFTER_PUBLISH = "crash_after_publish"
KILL_ORCHESTRATOR = "kill_orchestrator"
TRANSIENT_EXECUTOR_ERROR = "transient_executor_error"  # classified-retry bait
RELOAD_DURING_HAMMER = "reload_during_hammer"  # hot-swap mid-request-storm
KILL_REPLICA = "kill_replica"      # latched death until rebuild (generation)
WEDGE_PREDICT = "wedge_predict"    # predict parks, queue age grows
DEVICE_ERROR = "device_error"      # transient device fault, `times` times
KILL_SHARD_WORKER = "kill_shard_worker"    # SIGKILL-equivalent in a fork child
STORE_CONTENTION = "store_contention"      # transient StoreUnavailableError

# Plan keys of the faults, which are tied to no pipeline node.
STORE_KEY = "__store__"
SHARD_KEY = "__shards__"
SERVING_KEY = "__serving__"
REPLICA_KEY = "__replica__"

# kind -> the hook that triggers it.
_KIND_TO_POINT = {
    RAISE: "in_executor",
    RAISE_AFTER: "after_executor",
    HANG: "in_executor",
    TRANSIENT_EXECUTOR_ERROR: "in_executor",
    CRASH_BEFORE_PUBLISH: "before_publish",
    CRASH_AFTER_PUBLISH: "after_publish",
    KILL_ORCHESTRATOR: "at_dispatch",
    KILL_SHARD_WORKER: "in_shard",
    STORE_CONTENTION: "store_op",
    RELOAD_DURING_HAMMER: "serving_request",
    KILL_REPLICA: "replica_predict",
    WEDGE_PREDICT: "replica_predict",
    DEVICE_ERROR: "replica_predict",
}


class SimulatedCrash(BaseException):
    """Stand-in for orchestrator or process death at a precise runner
    phase.  A ``BaseException`` on purpose: a real SIGKILL cannot be
    caught, so no ``except Exception`` in an executor, worker or retry loop
    may turn it into an ordinary node failure."""

    def __init__(self, node_id: str, point: str):
        super().__init__(f"simulated crash at {point} of node {node_id!r}")
        self.node_id = node_id
        self.point = point


class InjectedFault(RuntimeError):
    """The exception RAISE, HANG and the replica faults surface."""


@dataclasses.dataclass
class NodeFault:
    kind: str
    message: str = "injected fault"
    # HANG / WEDGE_PREDICT safety ceiling: the hang gives up after this
    # long even if nothing releases it, so a test can never hang forever.
    max_hang_s: float = 60.0
    # How many times the fault fires before going inert (RAISE /
    # TRANSIENT_EXECUTOR_ERROR: fail N attempts, then succeed).
    times: int = 1
    # RELOAD_DURING_HAMMER / KILL_REPLICA: fire once the Nth request (call)
    # has arrived, so the traffic is demonstrably in flight.
    after: int = 1
    # KILL_SHARD_WORKER: which shard index of the fanned-out pool dies.
    shard: int = 0
    # Which replica name a replica fault applies to; "" = the first
    # replica the fault observes (then latched to it).
    replica: str = ""
    # WEDGE_PREDICT release valve: tests set() it to un-wedge early.
    release: threading.Event = dataclasses.field(
        default_factory=threading.Event, compare=False
    )
    # KILL_SHARD_WORKER cross-process once-token: fork children inherit a
    # COPY of the plan's fired counts, so in-memory once-semantics cannot
    # span the pool; the first child to create this file atomically is the
    # one that dies.  Assigned at activate() when left empty.
    once_file: str = ""

    def __post_init__(self):
        if self.kind not in _KIND_TO_POINT:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; "
                f"expected one of {sorted(_KIND_TO_POINT)}"
            )
        if self.times < 1:
            raise ValueError(f"times must be >= 1, got {self.times}")


class FaultPlan:
    """Faults by plan key (a node id, or one of the ``*_KEY`` sentinels),
    each fired at most ``times`` times.  ``log`` records ``(key, event)``
    tuples for tests to assert on: that a hang was released by the
    watchdog's cancel event rather than by its ceiling, for one."""

    def __init__(self, faults: Dict[str, NodeFault]):
        self.faults = dict(faults)
        self._fired: Dict[str, int] = {}
        self._requests = 0        # serving_request arrivals
        self._replica_calls = 0   # replica_predict arrivals (KILL_REPLICA)
        # KILL_REPLICA latch: replica name -> the generation that died.
        # Every call from that (replica, generation) fails; the rebuild
        # bumps the generation, so the rebuilt incarnation runs clean.
        self._killed: Dict[str, int] = {}
        self._pid: Optional[int] = None  # set at activate(): spots fork children
        self._lock = threading.Lock()
        self.log: List[Tuple[str, str]] = []

    def _take(self, key: str, point: str) -> Optional[NodeFault]:
        """Claim one firing of the fault under ``key`` at hook ``point``;
        None once its ``times`` budget is spent."""
        fault = self.faults.get(key)
        if fault is None or _KIND_TO_POINT[fault.kind] != point:
            return None
        with self._lock:
            fired = self._fired.get(key, 0)
            if fired >= fault.times:
                return None
            self._fired[key] = fired + 1
        return fault

    def record(self, key: str, event: str) -> None:
        with self._lock:
            self.log.append((key, event))

    @contextmanager
    def activate(self):
        """Install this plan for the duration of the block (test-only)."""
        global _ACTIVE
        prev = _ACTIVE
        self._pid = os.getpid()
        tokens: List[str] = []
        for fault in self.faults.values():
            if fault.kind == KILL_SHARD_WORKER and not fault.once_file:
                # Reserve a name only: the first shard child to create it
                # wins the kill; the parent removes it afterwards.
                fault.once_file = os.path.join(
                    tempfile.gettempdir(),
                    f"tpp-fault-{os.getpid()}-{id(fault)}.token",
                )
                tokens.append(fault.once_file)
        _ACTIVE = self
        try:
            yield self
        finally:
            _ACTIVE = prev
            for token in tokens:
                try:
                    os.unlink(token)
                except OSError:
                    pass


_ACTIVE: Optional[FaultPlan] = None


# ------------------------------------------------------------ runner hooks


def at_dispatch(node_id: str) -> None:
    """Scheduler thread, before the node's driver phase runs."""
    plan = _ACTIVE
    if plan is None:
        return
    if plan._take(node_id, "at_dispatch") is not None:
        plan.record(node_id, "kill_orchestrator")
        raise SimulatedCrash(node_id, "at_dispatch")


def in_executor(node_id: str, cancel_event: Optional[threading.Event]) -> None:
    """Worker thread, inside the executor attempt (before the real fn)."""
    plan = _ACTIVE
    if plan is None:
        return
    fault = plan._take(node_id, "in_executor")
    if fault is None:
        return
    if fault.kind == TRANSIENT_EXECUTOR_ERROR:
        from tpu_pipelines_torch.robustness.errors import TransientError

        plan.record(node_id, "transient_executor_error")
        raise TransientError(fault.message)
    if fault.kind == RAISE:
        plan.record(node_id, "raise")
        raise InjectedFault(fault.message)
    # HANG: parks until the deadline watchdog's cancel event (or the
    # safety ceiling) releases it.
    plan.record(node_id, "hang_start")
    released = (cancel_event or threading.Event()).wait(fault.max_hang_s)
    plan.record(node_id, "hang_released" if released else "hang_ceiling")
    raise InjectedFault(
        f"{fault.message} (hang "
        f"{'cancelled by watchdog' if released else 'hit safety ceiling'})"
    )


def after_executor(node_id: str) -> None:
    """Worker thread, inside the executor attempt, after the real fn."""
    plan = _ACTIVE
    if plan is None:
        return
    fault = plan._take(node_id, "after_executor")
    if fault is not None:
        plan.record(node_id, "raise_after")
        raise InjectedFault(fault.message)


def before_publish(node_id: str) -> None:
    """Worker thread: the executor succeeded, the publisher has not written."""
    plan = _ACTIVE
    if plan is None:
        return
    if plan._take(node_id, "before_publish") is not None:
        plan.record(node_id, "crash_before_publish")
        raise SimulatedCrash(node_id, "before_publish")


def after_publish(node_id: str) -> None:
    """Worker thread: the COMPLETE publish committed."""
    plan = _ACTIVE
    if plan is None:
        return
    if plan._take(node_id, "after_publish") is not None:
        plan.record(node_id, "crash_after_publish")
        raise SimulatedCrash(node_id, "after_publish")


def in_shard(shard_index: int) -> None:
    """Inside a shard-pool worker, before the real per-shard fn.

    KILL_SHARD_WORKER (key ``SHARD_KEY``): the matching shard's worker
    dies with ``os._exit``, a SIGKILL-equivalent the pool observes as
    ``BrokenProcessPool``, forcing the replacement-worker path.  The
    fault's ``once_file`` token carries the once-semantics across the
    pool's processes.  In a same-process pool (threads or sequential) the
    fault raises a ``TransientError`` instead: killing the interpreter
    would take the whole run with it."""
    plan = _ACTIVE
    if plan is None:
        return
    fault = plan.faults.get(SHARD_KEY)
    if fault is None or fault.kind != KILL_SHARD_WORKER:
        return
    if shard_index != fault.shard or not fault.once_file:
        return
    try:
        fd = os.open(fault.once_file, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        os.close(fd)
    except OSError:
        return  # another worker (or an earlier attempt) already fired
    if plan._pid is not None and os.getpid() != plan._pid:
        os._exit(3)  # a fork child: die as a preempted worker does
    from tpu_pipelines_torch.robustness.errors import TransientError

    plan.record(SHARD_KEY, "kill_shard_worker_inline")
    raise TransientError(
        f"{fault.message} (same-process pool: raised instead of killed)"
    )


def store_op(op: str) -> None:
    """Inside a MetadataStore write transaction, before the commit.

    STORE_CONTENTION (key ``STORE_KEY``): raises a transient
    ``StoreUnavailableError`` ``times`` times, the shape a contended
    multi-writer store produces, which the store's publish retry must
    absorb."""
    plan = _ACTIVE
    if plan is None:
        return
    fault = plan._take(STORE_KEY, "store_op")
    if fault is None:
        return
    plan.record(STORE_KEY, f"store_contention:{op}")
    from tpu_pipelines_torch.metadata.store import StoreUnavailableError

    raise StoreUnavailableError(fault.message)


# ----------------------------------------------------------- serving hooks


def serving_request(server, endpoint: str) -> None:
    """Per request on the ModelServer's hot endpoints.

    RELOAD_DURING_HAMMER (key ``SERVING_KEY``): once the ``after``-th
    request has arrived, a background thread calls ``server.reload()``, so
    the zero-5xx reload-under-load guarantee is exercised mid-storm."""
    plan = _ACTIVE
    if plan is None:
        return
    fault = plan.faults.get(SERVING_KEY)
    if fault is None or fault.kind != RELOAD_DURING_HAMMER:
        return
    with plan._lock:
        plan._requests += 1
        n = plan._requests
    if n < max(1, fault.after):
        return
    if plan._take(SERVING_KEY, "serving_request") is None:
        return
    plan.record(SERVING_KEY, f"reload_during_hammer:{endpoint}")
    threading.Thread(
        target=server.reload, name="tpp-fault-reload", daemon=True
    ).start()


def replica_predict(replica_name: str, generation: int = 0) -> None:
    """Per call on a fleet replica's hot paths (batched predict, the
    supervisor heartbeat, the generative engine's worker loop), keyed by
    ``REPLICA_KEY``.

    KILL_REPLICA: after the ``after``-th call fleet-wide, the targeted
    replica's current generation is latched dead: every later call from
    that (replica, generation) raises, like a device that fell off the
    bus, until a rebuild bumps the generation.

    WEDGE_PREDICT: ``times`` calls park on the fault's ``release`` event
    (bounded by ``max_hang_s``), the wedged-device shape the supervisor's
    queue-age probe must catch.

    DEVICE_ERROR: ``times`` calls raise a transient device error (the
    transfer-failure shape ``classify_error`` marks retriable)."""
    plan = _ACTIVE
    if plan is None:
        return
    fault = plan.faults.get(REPLICA_KEY)
    if fault is None or _KIND_TO_POINT.get(fault.kind) != "replica_predict":
        return
    if fault.kind == KILL_REPLICA:
        with plan._lock:
            latched = plan._killed.get(replica_name)
            if latched is not None:
                if latched != generation:
                    return  # rebuilt: the new generation runs clean
            else:
                if fault.replica and fault.replica != replica_name:
                    return
                plan._replica_calls += 1
                if plan._replica_calls < max(1, fault.after):
                    return
                if plan._fired.get(REPLICA_KEY, 0) >= 1:
                    return  # only one replica dies per plan
                plan._fired[REPLICA_KEY] = 1
                plan._killed[replica_name] = generation
                plan.log.append((REPLICA_KEY, f"kill_replica:{replica_name}"))
        raise InjectedFault(f"{fault.message} (replica {replica_name} dead)")
    if fault.replica and fault.replica != replica_name:
        return
    if plan._take(REPLICA_KEY, "replica_predict") is None:
        return
    if fault.kind == WEDGE_PREDICT:
        plan.record(REPLICA_KEY, f"wedge_predict:{replica_name}")
        released = fault.release.wait(fault.max_hang_s)
        plan.record(
            REPLICA_KEY, "wedge_released" if released else "wedge_ceiling"
        )
        raise InjectedFault(f"{fault.message} (predict wedged)")
    plan.record(REPLICA_KEY, f"device_error:{replica_name}")
    raise RuntimeError(
        f"{fault.message}: failed to transfer buffer to device "
        f"(injected device error on replica {replica_name})"
    )
