"""ShardPlan: how many shards the data plane fans out to, and worker pools.

The port of ``tpu_pipelines/data/shard_plan.py``.  The sharded Examples
layout (``examples_io``: ``Split-<name>/data-00000-of-N.npz``) gives every
hot data component a unit of intra-component parallelism.  This module
owns the two decisions every sharding component would otherwise re-make:

  * **How many shards?**  ``ShardPlan.resolve(param)``: an explicit component
    parameter wins, then the ``TPP_DATA_SHARDS`` env var, then ``host_cpus``
    (capped at ``MAX_DEFAULT_SHARDS``).
  * **How to run per-shard work?**  ``map_shards`` / ``map_shards_resilient``
    (a ``fork`` process pool: the CPU-bound statistics reductions hold the
    GIL) and ``thread_map`` (a thread pool, for per-shard work that cannot
    leave the process).  ``TPP_DATA_POOL`` picks ``process`` (default),
    ``thread`` or ``none``; ``TPP_DATA_POOL_WORKERS`` caps the workers.

The resilient pool retries transient shard failures, quarantines poison
shards, replaces a pool whose worker died (``KILL_SHARD_WORKER`` in
``testing/faults.py`` injects one), and counts it all in
``shards_quarantined_total``, ``shard_worker_deaths_total`` and
``shard_pool_fallbacks_total``.  When a run trace is active each task is
one ``shard`` span (cat ``data``), with the child's pid when forked.

Fork after CUDA: the runner's process holds a CUDA context and live
threads.  The children run numpy only (``data/statistics.py``'s
``accumulate_split_shard``); a child that touched CUDA would die with
"Cannot re-initialize CUDA in forked subprocess", surfacing as a shard
failure, never as a quiet switch to threads.  A lock another parent
thread held at the fork stays held in the child: the trace recorder
takes a fresh one in a child, and the node's deadline bounds any other
wedge (``cancel=``, the runner's ``ctx.extras["cancel_event"]``, which
its deadline watchdog and its drain set, kills the round's workers).
Without a node deadline a wedged child waits unbounded, as any hung
executor does in the reference.
"""

from __future__ import annotations

import dataclasses
import logging
import multiprocessing
import os
import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor, wait
from concurrent.futures.process import BrokenProcessPool
from typing import (
    Any,
    Callable,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
    TypeVar,
)

from tpu_pipelines_torch.observability import trace as _obs
from tpu_pipelines_torch.robustness import (
    NO_RETRY,
    RetryPolicy,
    classify_error,
    record_retry,
)
from tpu_pipelines_torch.testing import faults as _faults

log = logging.getLogger("tpu_pipelines_torch.data.shard_plan")

ENV_SHARDS = "TPP_DATA_SHARDS"
# Pool backend override: "process" (default), "thread", or "none"
# (sequential — the debugging escape hatch).
ENV_POOL = "TPP_DATA_POOL"
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


def fork_unsafe_reason(value) -> Optional[str]:
    """Why ``value`` must not ride into a ``map_shards`` fork, or None.

    This is the pickle/fork half of the per-shard worker contract
    (module-level function + plain-data args): locks deadlock in the child
    (the owning thread does not exist there), open handles alias the
    parent's file offsets, database connections and sockets share kernel
    state, and CUDA tensors live in the parent's device context, which a
    forked child cannot re-initialize.  The TPP202 lint rule
    (``tpu_pipelines_torch/analysis``) reports captures of these before a
    run ever forks.
    """
    import io
    import socket
    import sqlite3
    import threading

    lock_types = (
        type(threading.Lock()), type(threading.RLock()),
        threading.Event, threading.Condition, threading.Semaphore,
        threading.BoundedSemaphore, threading.Barrier,
    )
    if isinstance(value, lock_types):
        return "thread synchronization primitive"
    if isinstance(value, io.IOBase):
        return "open file handle"
    if isinstance(value, sqlite3.Connection):
        return "sqlite connection"
    if isinstance(value, socket.socket):
        return "socket"
    # Device tensors, ducked so this module never imports torch (the
    # pool's children run numpy only): a CPU tensor forks fine, copy on
    # write; one on the card belongs to the parent's CUDA context.
    mod = type(value).__module__ or ""
    if mod.split(".")[0] == "torch" and getattr(value, "is_cuda", False):
        return "device tensor"
    return None


def _pool_workers(n_tasks: int, workers: Optional[int]) -> int:
    """Effective worker count: TPP_DATA_POOL_WORKERS overrides everything
    (the test/oversubscribed-host knob), then the caller's cap, then
    min(tasks, host cpus)."""
    env = os.environ.get(ENV_POOL_WORKERS, "").strip()
    if env:
        return max(1, min(int(env), n_tasks))
    if workers is not None:
        return max(1, min(workers, n_tasks))
    return max(1, min(n_tasks, os.cpu_count() or 1))


class _TracedShardFn:
    """Picklable per-shard wrapper: one ``data.shard`` span per task plus
    the kill-shard-worker fault hook.

    Process-pool children inherit the active recorder across fork and
    reopen the event log on first emit, so the per-shard spans land in
    the run trace with the CHILD's pid.  The span is a no-op null context
    when no recorder is active (the resilient pool always indexes its
    tasks); ``thread_map`` wraps only when a recorder is active and the
    wrap is idempotent, so fallbacks never double-wrap.  (The reference's
    wrapper also federates a child's metric deltas to the parent's
    scrape; federation waits with ``ROADMAP.md`` A8b.)
    """

    __slots__ = ("fn", "label", "pool")

    def __init__(self, fn: Callable, label: str, pool: str):
        self.fn = fn
        self.label = label
        self.pool = pool

    def __call__(self, indexed):
        i, task = indexed
        # Fault hook (testing/faults.py KILL_SHARD_WORKER): one module-
        # global read when no plan is active.
        _faults.in_shard(i)
        with _obs.span(
            "shard", cat="data",
            args={"label": self.label, "shard": i, "pool": self.pool},
        ):
            return self.fn(task)


@dataclasses.dataclass
class ShardResult:
    """Structured outcome of a resilient shard fan-out.

    ``results`` is order-preserving (``None`` at failed indices);
    ``errors`` maps every given-up shard index to its LAST exception;
    ``quarantined`` lists the shards that struck out (every retry spent,
    or a permanent-classified failure) — in partial-salvage mode the
    caller proceeds over the surviving shards and records these.
    """

    results: List[Any]
    errors: Dict[int, BaseException] = dataclasses.field(
        default_factory=dict
    )
    quarantined: List[int] = dataclasses.field(default_factory=list)
    retries: int = 0
    pool_replacements: int = 0
    pool: str = "process"

    @property
    def ok(self) -> bool:
        return not self.errors

    @property
    def failed_shards(self) -> List[int]:
        return sorted(self.errors)

    def failure_summary(self) -> Dict[int, str]:
        return {
            i: f"{type(e).__name__}: {e}"
            for i, e in sorted(self.errors.items())
        }

    def raise_on_failure(self) -> "ShardResult":
        if self.errors:
            raise self.errors[min(self.errors)]
        return self


def _quarantine_counter():
    from tpu_pipelines_torch.observability.metrics import default_registry

    return default_registry().counter(
        "shards_quarantined_total",
        "Shards struck out of a resilient fan-out (salvaged or fatal).",
        labels=("label",),
    )


def _worker_death_counter():
    from tpu_pipelines_torch.observability.metrics import default_registry

    return default_registry().counter(
        "shard_worker_deaths_total",
        "Fork pool workers that died mid-task (pool replaced).",
        labels=("label",),
    )


def _fallback_counter():
    from tpu_pipelines_torch.observability.metrics import default_registry

    return default_registry().counter(
        "shard_pool_fallbacks_total",
        "Process-pool starts that degraded to the thread pool.",
        labels=("reason",),
    )


@dataclasses.dataclass
class _TaskState:
    index: int
    task: Any
    attempts: int = 0       # executor-exception strikes
    deaths: int = 0         # pool-death strikes (worker died while queued)


# A worker death observed while the task ran ISOLATED (pool of one) is
# attributable; this many attributable deaths quarantine the shard.  In a
# shared pool a death may be collateral (another task's worker), so the
# shared-pool cap is looser.
_ISOLATED_DEATHS_LIMIT = 2
_SHARED_DEATHS_LIMIT = 4


def map_shards_resilient(
    fn: Callable[[T], R],
    tasks: Sequence[T],
    workers: Optional[int] = None,
    *,
    retry_policy: Optional[RetryPolicy] = None,
    label: str = "map_shards",
    cancel: Optional[threading.Event] = None,
) -> ShardResult:
    """Fan ``fn`` over ``tasks`` with per-shard retries, poison-shard
    quarantine, and replacement workers.

    Failure semantics, per shard:

      * an exception the taxonomy classifies TRANSIENT is retried under
        ``retry_policy`` (default: env ``TPP_RETRY_*``, else no retries),
        with the policy's jittered backoff between rounds;
      * a PERMANENT-classified exception strikes the shard out
        immediately — retrying a poisoned input re-fails forever;
      * a dead fork worker (preemption, OOM kill — surfaces as
        ``BrokenProcessPool``) replaces the pool and resubmits the
        unfinished shards; after two pool deaths the remaining shards run
        ISOLATED (one per single-worker pool) so the true poison shard
        accrues attributable strikes instead of taking hostages;
      * once ``cancel`` is set (the node's deadline expired, or the run
        is draining) a fork round's workers are killed and every shard
        not yet done strikes out as cancelled, with no retry.  A child
        forked while another thread of the parent held a lock it needs
        can wedge; the node's deadline bounds the wait.  The policy's
        ``deadline_s`` only stops retries, as in the reference.

    Struck-out shards land in ``ShardResult.errors`` + ``quarantined``;
    the caller chooses partial salvage (merge survivors, record the
    quarantined ids) or ``raise_on_failure()``.  Retries/quarantines/
    deaths are counted on the process metrics registry
    (``retry_attempts_total{site="shard:<label>"}``,
    ``shards_quarantined_total``, ``shard_worker_deaths_total``).
    """
    n_tasks = len(tasks)
    policy = retry_policy or RetryPolicy.from_env() or NO_RETRY
    workers = _pool_workers(n_tasks, workers)
    mode = os.environ.get(ENV_POOL, "process").strip() or "process"
    call = (
        fn if isinstance(fn, _TracedShardFn)
        else _TracedShardFn(fn, label, mode)
    )
    out = ShardResult(results=[None] * n_tasks, pool=mode)
    with _obs.span(
        label, cat="data",
        args={"tasks": n_tasks, "workers": workers, "pool": mode},
    ):
        if n_tasks == 0:
            return out
        _run_resilient(
            call, list(tasks), workers, policy, label, out, mode, cancel
        )
    return out


def _settle_failure(
    state: _TaskState,
    exc: BaseException,
    policy: RetryPolicy,
    label: str,
    out: ShardResult,
    retry_t0: float,
) -> bool:
    """Record one executor-exception strike; True when the shard should be
    requeued for another attempt, False when it is struck out."""
    state.attempts += 1
    verdict = classify_error(exc)
    budget_left = (
        policy.deadline_s <= 0
        or (time.monotonic() - retry_t0) < policy.deadline_s
    )
    if (
        verdict == "transient"
        and state.attempts < policy.max_attempts
        and budget_left
    ):
        out.retries += 1
        record_retry(f"shard:{label}")
        log.warning(
            "%s shard %d attempt %d/%d failed (%s: %s); retrying",
            label, state.index, state.attempts, policy.max_attempts,
            type(exc).__name__, exc,
        )
        return True
    out.errors[state.index] = exc
    out.quarantined.append(state.index)
    _quarantine_counter().labels(label).inc()
    log.error(
        "%s shard %d struck out after %d attempt(s) (%s, %s): %s",
        label, state.index, state.attempts, verdict,
        "budget spent" if not budget_left else "no retries left", exc,
    )
    return False


def _run_resilient(
    call: Callable[[Tuple[int, Any]], Any],
    tasks: List[Any],
    workers: int,
    policy: RetryPolicy,
    label: str,
    out: ShardResult,
    mode: str,
    cancel: Optional[threading.Event] = None,
) -> None:
    """Round-based scheduler behind :func:`map_shards_resilient`.

    Each round submits every pending shard to a fresh-or-healthy pool and
    drains it; shards failing transiently are requeued for the next round
    (after the policy's backoff), a broken pool is replaced, and — after
    two pool deaths — rounds shrink to one isolated shard each so strikes
    attribute to the true poison.
    """
    pending: List[_TaskState] = [
        _TaskState(i, t) for i, t in enumerate(tasks)
    ]
    use_process = mode == "process" and len(tasks) > 1 and workers > 1
    retry_t0 = time.monotonic()
    pool_deaths = 0
    while pending:
        if cancel is not None and cancel.is_set():
            for state in pending:
                _strike_cancelled(state, label, out)
            return
        isolate = pool_deaths >= 2
        batch = pending[:1] if isolate and len(pending) > 1 else pending
        rest = pending[len(batch):]
        requeue: List[_TaskState] = []
        if not use_process:
            # Thread pool (TPP_DATA_POOL=thread) or plain sequential
            # ("none" / one task / one worker): no worker processes can
            # die, so only the exception path of the strike ledger
            # applies.
            sequential = (
                mode == "none" or len(batch) <= 1 or workers <= 1
            )
            results = _drain_threaded(call, batch, workers, sequential)
            for state, (ok, value) in zip(batch, results):
                if ok:
                    out.results[state.index] = value
                elif _settle_failure(
                    state, value, policy, label, out, retry_t0
                ):
                    requeue.append(state)
        else:
            broken = _drain_process_pool(
                call, batch, 1 if isolate else workers, policy, label,
                out, retry_t0, requeue, cancel,
            )
            if broken:
                pool_deaths += 1
                out.pool_replacements += 1
                _worker_death_counter().labels(label).inc()
                death_cap = (
                    _ISOLATED_DEATHS_LIMIT if isolate
                    else _SHARED_DEATHS_LIMIT
                )
                for state in list(requeue):
                    if state.deaths >= death_cap:
                        requeue.remove(state)
                        exc = RuntimeError(
                            f"shard {state.index} killed its worker "
                            f"{state.deaths} time(s)"
                        )
                        out.errors[state.index] = exc
                        out.quarantined.append(state.index)
                        _quarantine_counter().labels(label).inc()
                        log.error(
                            "%s shard %d quarantined: %s",
                            label, state.index, exc,
                        )
        pending = requeue + rest
        if pending and requeue:
            # One jittered backoff per round (the per-shard budget is the
            # attempt ledger; sleeping per shard would serialize rounds).
            delay = policy.backoff_s(
                max(s.attempts for s in requeue) or 1
            )
            if delay > 0:
                if cancel is not None:
                    cancel.wait(delay)
                else:
                    time.sleep(delay)


def _drain_threaded(
    call: Callable[[Tuple[int, Any]], Any],
    batch: List[_TaskState],
    workers: int,
    sequential: bool,
) -> List[Tuple[bool, Any]]:
    """Run one round in-process; returns (ok, result-or-exception) per
    task, order aligned with ``batch``."""
    out: List[Tuple[bool, Any]] = []
    if sequential or len(batch) <= 1 or workers <= 1:
        for state in batch:
            try:
                out.append((True, call((state.index, state.task))))
            except Exception as exc:  # noqa: BLE001 — strike ledger decides
                out.append((False, exc))
        return out
    with ThreadPoolExecutor(max_workers=min(workers, len(batch))) as pool:
        futures = [
            pool.submit(call, (s.index, s.task)) for s in batch
        ]
        for fut in futures:
            try:
                out.append((True, fut.result()))
            except Exception as exc:  # noqa: BLE001
                out.append((False, exc))
    return out


def _strike_cancelled(state: _TaskState, label: str, out: ShardResult):
    """Strike out a shard the node's cancel event stopped (no retry)."""
    exc = RuntimeError(
        f"shard {state.index} cancelled: the node's deadline expired or "
        "the run is draining"
    )
    out.errors[state.index] = exc
    out.quarantined.append(state.index)
    log.warning("%s %s", label, exc)


# How often a fork round looks at its node's cancel event.
_CANCEL_POLL_S = 0.1


def _await_future(fut, cancel: Optional[threading.Event]) -> bool:
    """Wait for ``fut``; False when ``cancel`` is set while it still runs
    (True at once without one: the caller's ``result()`` blocks)."""
    if cancel is None:
        return True
    while not fut.done():
        if cancel.is_set():
            return False
        wait([fut], timeout=_CANCEL_POLL_S)
    return True


def _kill_workers(pool: ProcessPoolExecutor) -> None:
    """SIGKILL a pool's worker processes (a wedged round's)."""
    for proc in list((getattr(pool, "_processes", None) or {}).values()):
        try:
            proc.kill()
        except (OSError, AttributeError):
            pass


def _drain_process_pool(
    call, batch, workers, policy, label, out, retry_t0, requeue,
    cancel=None,
) -> bool:
    """One fork-pool round; returns True when the pool died (caller
    replaces it).  Completed/failed shards settle; shards whose futures
    report BrokenProcessPool take a death mark and requeue; shards still
    running when ``cancel`` is set have their workers killed and strike
    out."""
    try:
        # fork, explicitly: spawn would re-import the framework and torch
        # in every worker (seconds of startup against millisecond tasks).
        # The children run numpy only; none touches the parent's CUDA
        # context, which a forked process cannot re-initialize.
        ctx = multiprocessing.get_context("fork")
        pool = ProcessPoolExecutor(
            max_workers=min(workers, len(batch)), mp_context=ctx
        )
    except (ValueError, OSError) as exc:
        # Worker-pool degradation is logged and counted, never silent.
        log.warning(
            "%s: process pool unavailable for %d shard(s) (%s: %s); "
            "degrading to threads",
            label, len(batch), type(exc).__name__, exc,
        )
        _fallback_counter().labels(type(exc).__name__).inc()
        results = _drain_threaded(call, batch, workers, sequential=False)
        for state, (ok, value) in zip(batch, results):
            if ok:
                out.results[state.index] = value
            elif _settle_failure(state, value, policy, label, out, retry_t0):
                requeue.append(state)
        return False
    broken = False
    futures = {}
    try:
        try:
            for state in batch:
                futures[pool.submit(call, (state.index, state.task))] = state
        except BrokenProcessPool:
            broken = True  # died during submission; futures dict is partial
        done_states = set()
        cancelled = False
        for fut, state in futures.items():
            if not cancelled and not _await_future(fut, cancel):
                cancelled = True
                _kill_workers(pool)
            if cancelled:
                # A shard done before the kill keeps its result; every
                # other one (its worker killed) strikes out, no retry.
                try:
                    out.results[state.index] = fut.result()
                except Exception:  # noqa: BLE001 — cancelled either way
                    _strike_cancelled(state, label, out)
                done_states.add(id(state))
                continue
            try:
                out.results[state.index] = fut.result()
                done_states.add(id(state))
            except BrokenProcessPool as exc:
                broken = True
                state.deaths += 1
                log.warning(
                    "%s shard %d lost its worker (death %d): %s",
                    label, state.index, state.deaths, exc,
                )
                requeue.append(state)
                done_states.add(id(state))
            except Exception as exc:  # noqa: BLE001 — strike ledger decides
                if _settle_failure(
                    state, exc, policy, label, out, retry_t0
                ):
                    requeue.append(state)
                done_states.add(id(state))
        if broken:
            # Shards never submitted (pool died mid-submission): requeue
            # with a death mark, same as a lost future.
            for state in batch:
                if id(state) not in done_states:
                    state.deaths += 1
                    requeue.append(state)
    finally:
        # wait=True is instant here (every future above is settled) and
        # deregisters the executor from the interpreter's atexit hooks —
        # an abandoned broken pool would spew Bad-file-descriptor noise
        # at shutdown otherwise.
        pool.shutdown(wait=True, cancel_futures=True)
    return broken


def map_shards(
    fn: Callable[[T], R],
    tasks: Sequence[T],
    workers: Optional[int] = None,
    retry_policy: Optional[RetryPolicy] = None,
) -> List[R]:
    """``[fn(t) for t in tasks]`` through a process pool, order preserved.

    ``fn`` and each task must be picklable (module-level function +
    plain-data args — the per-shard statistics worker contract) and must
    not touch CUDA.  Falls
    back to a thread pool when fork isn't available (now logged and
    counted, never silent), and to sequential when the pool is pointless
    (one task / one worker) or ``TPP_DATA_POOL`` says so.

    Built on :func:`map_shards_resilient`: transient per-shard failures
    retry under ``retry_policy`` (default env ``TPP_RETRY_*``, else none)
    and a dead fork worker is replaced instead of sinking the fan-out;
    any shard that still strikes out re-raises its exception here.
    Callers that want partial salvage use ``map_shards_resilient``
    directly and keep the surviving shards.
    """
    return map_shards_resilient(
        fn, tasks, workers, retry_policy=retry_policy
    ).raise_on_failure().results


def thread_map(
    fn: Callable[[T], R],
    tasks: Sequence[T],
    workers: Optional[int] = None,
) -> List[R]:
    """``[fn(t) for t in tasks]`` through a thread pool, order preserved.

    For per-shard work whose closures cannot cross a process boundary or
    that runs on the card (Transform's device graph, BulkInferrer's
    predict): file IO and large-array numpy release the GIL, so threads
    still overlap the IO-heavy parts even though pure-Python stretches
    serialize.
    """
    workers = _pool_workers(len(tasks), workers)
    if _obs.active_recorder() is not None and not isinstance(
        fn, _TracedShardFn
    ):
        fn = _TracedShardFn(fn, "thread_map", "thread")
        tasks = list(enumerate(tasks))
    if len(tasks) <= 1 or workers <= 1:
        return [fn(t) for t in tasks]
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(fn, tasks))
