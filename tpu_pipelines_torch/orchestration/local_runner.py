"""Local DAG runner: ready-set scheduling with an execution cache and
classified retries, on one device.

The port of ``tpu_pipelines/orchestration/local_runner.py`` (TFX's
``LocalDagRunner`` and launcher stack):

    run(pipeline)
    └─ compile DSL → IR
    └─ ready-set scheduler (worker pool of ``max_parallel_nodes``):
       a node is dispatched once every upstream has PUBLISHED; at most one
       "tpu" resource-class node (Transform, Trainer, Evaluator: the nodes
       that hold the accelerator, here the GPU) runs at a time while "host"
       nodes overlap freely.  Per dispatched node:
       ├─ DRIVER: resolve input artifacts; compute the content cache key;
       │          cache hit ⇒ publish a CACHED execution reusing outputs.
       │          Runs in the scheduler thread, so execution ids (and the
       │          output URIs embedding them) are assigned in dispatch order.
       ├─ LAUNCHER: allocate output artifact dirs; invoke the executor in a
       │            worker thread, with per-node classified retries
       └─ PUBLISHER: fingerprint outputs, mark LIVE, record the execution,
                     its lineage events and contexts, every store write
                     under one run-level publish lock.

The device is resolved once, in the constructor (``device="cuda"`` unless
the caller asks for the CPU; without CUDA it raises, naming the device),
and reaches every executor as ``ctx.extras["device"]``.

Every run is traced as the reference's is (``observability/trace.py``):
``<pipeline_root>/.runs/<run_id>/trace/events.jsonl`` gets the run's
``run_start`` / ``run_end``, a ``node`` span per node (status, queue and
device-gate waits, upstreams, execution id), the ``driver``,
``executor``, ``fingerprint`` and ``publish`` spans, ``cache_hit`` /
``cache_miss`` and ``retry`` instants, the metadata store's spans, the
data plane's shard spans and the train loop's summaries; ``TPP_TRACE=0``
turns all of it off and creates no file.  Log records carry the run and
node ids.  :class:`_RunTelemetry` publishes the ``pipeline_nodes_*``
gauges, per-node heartbeats and ``pipeline_run_info`` into the process
registry, and with ``TPP_METRICS_PORT`` serves ``/metrics`` and
``/healthz`` for the run's length.

Resolver nodes run in the driver with no executor and are never cached
or retried: they query the store and publish an execution whose outputs
are the existing artifacts (possibly none; an optional input wired to an
empty output resolves to an empty list).  A node whose ``Cond`` predicate
fails, or whose upstream was condition-skipped, settles ``COND_SKIPPED``
with a CANCELED execution recording the verdict; the run still succeeds.

Crash safety, as the reference's:
  - ``run(..., resume_from="latest"|run_id)`` rebuilds a prior run from
    the metadata store: COMPLETE and CACHED executions are adopted as they
    are (same execution ids, same artifact URIs), a Cond CANCELED record
    as ``COND_SKIPPED``; executions still RUNNING at the crash are fenced
    (ABANDONED, their allocated output dirs removed) and re-dispatched
    with everything downstream.  The DAG fingerprint recorded on the run
    context refuses a resume whose compiled IR changed; the run id
    continues, so the run context is not forked.
  - a node deadline (component ``execution_timeout_s`` >
    ``Pipeline(node_timeout_s=...)`` > env ``TPP_NODE_TIMEOUT_S``) is
    enforced by a watchdog in the scheduler thread: on expiry the node is
    published FAILED with ``timeout``, its cancel event (handed to the
    executor as ``ctx.extras["cancel_event"]``) is set, the device gate is
    released and the run drains; the worker's late publish is fenced out.
    An expiry is terminal: it uses up the node's retry budget.  A wedged
    device node's thread cannot be reaped (nor its CUDA work): the node
    admitted after it shares the card with it until it returns.
  - fault hooks (``testing/faults.py``) sit at dispatch, in the executor
    attempt and on both sides of the publisher; no-ops unless a test
    installs a plan.

Partial runs (TFX's partial-run workflow): ``run(from_nodes=[...],
to_nodes=[...])`` executes only the nodes between the bounds; every other
node settles ``SKIPPED`` with its newest LIVE outputs from prior runs
(``_resolve_prior_outputs``; a resolver's newest execution is
authoritative even when it resolved nothing), or ``COND_SKIPPED`` when
its newest decisive execution was a Cond skip (``_latest_is_cond_skip``).
Unknown bounds raise ``ValueError``, and so do bounds with
``resume_from``.

The lint pre-flight (``run(lint="error"|"warn")`` or env ``TPP_LINT``)
runs the port's analyzer (``analysis/``) on the compiled IR and every
executor and module entry point before the metadata store is opened, so
a refused run leaves nothing behind (``LintGateError``).

With ``TPP_METRICS_PORT`` and ``TPP_FEDERATION_DIR`` both set, the runner's
port serves the federated scrape: its own registry merged with every
spooled snapshot (fork-pool workers, trainers, fleet replicas), labelled
by host, replica and tenant (``observability/federation.py``).

Multi-process runs (``spmd_sync=True``, what ``run_node`` uses when the env
describes a process group): every process runs the one selected node, and
each store-derived decision is process 0's, broadcast over the default
process group (``parallel/distributed.py``): input resolution, the cache
verdict, a replayed or fresh Cond verdict, a resolver's answer and the
execution id in the output URIs (process 0 wipes stale output dirs before
that broadcast).  After the executor a status all-gather is the barrier
before process 0 fingerprints and publishes; a failure on any process fails
the node on every process, and the workers return without publishing (their
store is a scratch copy).  Under ``spmd_sync`` the runner refuses in-runner
retries (``max_retries``, IR-carried policies), ``resume_from`` and a
selection of more than one node, runs no lint pre-flight and no run trace,
keeps one worker and enforces no deadline (the substrate's does).  "Process
0" is the global rank 0 of the default group.  The reference's XLA compile
cache has no counterpart: the port's kernels build once per checkout.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import queue as queue_mod
import shutil
import tempfile
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

from tpu_pipelines_torch.dsl.compiler import (
    Compiler,
    NodeIR,
    PipelineIR,
    resolve_property,
)
from tpu_pipelines_torch.dsl.component import ExecutorContext
from tpu_pipelines_torch.dsl.pipeline import Pipeline
from tpu_pipelines_torch.metadata import open_store
from tpu_pipelines_torch.metadata.store import MetadataStore, StoreUnavailableError
from tpu_pipelines_torch.observability import trace as _trace
from tpu_pipelines_torch.parallel import distributed as _dist
from tpu_pipelines_torch.metadata.types import (
    Artifact,
    ArtifactState,
    Context,
    EventType,
    Execution,
    ExecutionState,
)
from tpu_pipelines_torch.robustness import (
    TRANSIENT,
    RetryPolicy,
    classify_error,
    record_retry,
)
from tpu_pipelines_torch.testing import faults as _faults
from tpu_pipelines_torch.utils.device import resolve_device
from tpu_pipelines_torch.utils.fingerprint import (
    execution_cache_key,
    fingerprint_dir,
)
from tpu_pipelines_torch.utils.span import has_span_pattern, resolve_span_pattern

log = logging.getLogger("tpu_pipelines_torch.runner")


class PipelineRunError(RuntimeError):
    def __init__(self, message: str, result: "RunResult"):
        super().__init__(message)
        self.result = result


class _RunTelemetry:
    """Live run-progress telemetry for one pipeline run.

    Publishes nodes pending/running/done/failed gauges, per-node dispatch
    heartbeats and a run info metric into the process metrics registry,
    and with ``TPP_METRICS_PORT`` serves them (``/metrics`` and
    ``/healthz``) for the run's length.  Best-effort: a taken port logs a
    warning and the run proceeds unobserved.
    """

    def __init__(self, pipeline_name: str, run_id: str):
        from tpu_pipelines_torch.observability.metrics import default_registry

        reg = default_registry()
        self._g_pending = reg.gauge(
            "pipeline_nodes_pending", "Nodes not yet dispatched.",
        )
        self._g_running = reg.gauge(
            "pipeline_nodes_running", "Nodes currently executing.",
        )
        self._g_done = reg.gauge(
            "pipeline_nodes_done",
            "Nodes settled successfully (COMPLETE/CACHED/skips).",
        )
        self._g_failed = reg.gauge(
            "pipeline_nodes_failed", "Nodes settled FAILED.",
        )
        self._g_heartbeat = reg.gauge(
            "pipeline_node_heartbeat_ts",
            "Wall-clock (epoch s) of the node's last scheduler event "
            "(dispatch or settle).",
            labels=("node",),
        )
        self._c_dispatch = reg.counter(
            "pipeline_node_dispatch_total",
            "Executor dispatches per node (retries re-count).",
            labels=("node",),
        )
        reg.gauge(
            "pipeline_run_info",
            "1 for the currently running pipeline run.",
            labels=("pipeline", "run_id"),
        ).labels(pipeline_name, run_id).set(1)
        self._failed = 0
        self._server = None
        self._info = {"pipeline": pipeline_name, "run_id": run_id}
        port = os.environ.get("TPP_METRICS_PORT", "").strip()
        if port and port != "0":
            from tpu_pipelines_torch.observability.federation import (
                FederatedRegistry,
                federation_dir,
            )
            from tpu_pipelines_torch.observability.metrics import (
                start_http_server,
            )

            # With TPP_FEDERATION_DIR set the port is the one federated
            # scrape; without it, the plain process registry.
            serve_reg = FederatedRegistry(reg) if federation_dir() else reg
            try:
                self._server = start_http_server(
                    serve_reg, port=int(port), health_fn=self._health
                )
                log.info(
                    "metrics server on :%d (/metrics, /healthz)",
                    self._server.port,
                )
            except (OSError, ValueError) as e:
                log.warning(
                    "TPP_METRICS_PORT=%s: metrics server not started: %s",
                    port, e,
                )

    def _health(self) -> Dict[str, Any]:
        """The run's health, with the status of every open
        ``HealthMonitor`` (a training node's stall/NaN watchdogs) while one
        is open: a stalled or NaN-seen monitor makes the run unhealthy
        (503)."""
        from tpu_pipelines_torch.observability.health import open_monitors

        health = {"healthy": self._failed == 0, **self._info,
                  "nodes_failed": self._failed}
        monitors = [m.status() for m in open_monitors()]
        if monitors:  # the reference's payload when no loop is training
            health["monitors"] = monitors
            health["healthy"] = health["healthy"] and all(
                m["healthy"] for m in monitors)
        return health

    def progress(self, pending: int, running: int, result: "RunResult") -> None:
        failed = sum(
            1 for nr in result.nodes.values() if nr.status == "FAILED"
        )
        self._failed = failed
        self._g_pending.set(pending)
        self._g_running.set(running)
        self._g_done.set(len(result.nodes) - failed)
        self._g_failed.set(failed)

    def heartbeat(self, node_id: str, dispatched: bool = False) -> None:
        self._g_heartbeat.labels(node_id).set(time.time())
        if dispatched:
            self._c_dispatch.labels(node_id).inc()

    def close(self) -> None:
        if self._server is not None:
            self._server.close()
            self._server = None


@dataclasses.dataclass
class NodeResult:
    node_id: str
    status: str   # COMPLETE | CACHED | FAILED | SKIPPED | COND_SKIPPED
    execution_id: int = 0
    outputs: Dict[str, List[Artifact]] = dataclasses.field(default_factory=dict)
    error: str = ""
    wall_clock_s: float = 0.0
    retries: int = 0
    # True when resume_from stitched this node in from a prior run's
    # published execution instead of executing it again.
    adopted: bool = False


@dataclasses.dataclass
class RunResult:
    pipeline_name: str
    run_id: str
    nodes: Dict[str, NodeResult] = dataclasses.field(default_factory=dict)
    # Effective scheduler pool size this run executed with.
    max_parallel_nodes: int = 1

    @property
    def succeeded(self) -> bool:
        return all(
            n.status in ("COMPLETE", "CACHED", "SKIPPED", "COND_SKIPPED")
            for n in self.nodes.values()
        )

    def outputs_of(self, node_id: str, key: str) -> List[Artifact]:
        return self.nodes[node_id].outputs.get(key, [])


@dataclasses.dataclass
class _LaunchPlan:
    """Driver-phase output for a node that must execute: everything the
    worker-thread launcher/publisher phase needs.  The RUNNING execution is
    already registered."""

    node: NodeIR
    component: Any
    inputs: Dict[str, List[Artifact]]
    props: Dict[str, Any]
    external_fps: Dict[str, str]
    execution: Execution
    outputs: Dict[str, List[Artifact]]
    all_ctx: List[Context]
    t0: float
    # Deadline watchdog state (0 = no deadline).  ``cancel`` is handed to
    # the executor (extras["cancel_event"]); ``fenced`` is set by the
    # scheduler when the deadline expires (the worker must not publish
    # afterwards); ``published`` by the worker under the publish lock (the
    # scheduler must not fence afterwards): exactly one publish wins.
    deadline_s: float = 0.0
    retry_policy: Optional[RetryPolicy] = None
    cancel: threading.Event = dataclasses.field(
        default_factory=threading.Event
    )
    fenced: threading.Event = dataclasses.field(
        default_factory=threading.Event
    )
    published: threading.Event = dataclasses.field(
        default_factory=threading.Event
    )


def _spmd_sync_inputs(
    inputs: Dict[str, List[Artifact]],
) -> Dict[str, List[Artifact]]:
    """Every process's resolved inputs replaced by process 0's.

    Input resolution reads the metadata store, and workers hold a
    point-in-time snapshot of it: an upstream published between the
    snapshot and process 0's read would otherwise feed the processes
    different artifact URIs for the same training step."""
    payload = {
        key: [
            {
                "type_name": a.type_name,
                "uri": a.uri,
                "id": a.id,
                "fingerprint": a.fingerprint,
                "properties": a.properties,
            }
            for a in arts
        ]
        for key, arts in inputs.items()
    }
    synced = _dist.broadcast_json(payload)
    return {
        key: [
            Artifact(
                type_name=d["type_name"],
                uri=d["uri"],
                id=d["id"],
                state=ArtifactState.LIVE,
                properties=d["properties"],
                fingerprint=d["fingerprint"],
            )
            for d in arts
        ]
        for key, arts in synced.items()
    }


class LocalDagRunner:
    """In-process topological pipeline runner on one device.

    Per-node retries follow the reference's :class:`RetryPolicy`
    precedence: ``@component(retry_policy=...)`` >
    ``Pipeline(retry_policy=...)`` > env ``TPP_RETRY_*`` > the
    ``max_retries`` constructor knob (``RetryPolicy(max_attempts=
    max_retries+1, base_delay_s=0)``).  Only failures the shared taxonomy
    classifies TRANSIENT are retried.

    ``max_parallel_nodes`` bounds the scheduler's worker pool: None = env
    ``TPP_MAX_PARALLEL_NODES`` if set, else the DAG's root count; "tpu"
    resource-class nodes are serialized against each other regardless.

    ``spmd_sync`` runs one node on every process of the default process
    group, with process 0's store-derived decisions (module docstring).
    """

    def __init__(
        self,
        max_retries: int = 0,
        max_parallel_nodes: Optional[int] = None,
        device: Any = "cuda",
        spmd_sync: bool = False,
    ):
        self.spmd_sync = spmd_sync
        if spmd_sync and max_retries:
            raise ValueError(
                "spmd_sync is incompatible with in-runner retries: process 0's"
                " clean-slate wipe would race workers still in the previous"
                " attempt; use substrate-level retries (Argo retryStrategy /"
                " JobSet restarts) instead"
            )
        self.max_retries = max_retries
        self.max_parallel_nodes = max_parallel_nodes
        self.device = resolve_device(device)

    def run(
        self,
        pipeline: Pipeline,
        runtime_parameters: Optional[Dict[str, Any]] = None,
        run_id: Optional[str] = None,
        raise_on_failure: bool = True,
        extras: Optional[Dict[str, Any]] = None,
        from_nodes: Optional[Sequence[str]] = None,
        to_nodes: Optional[Sequence[str]] = None,
        resume_from: Optional[str] = None,
        lint: Optional[str] = None,
    ) -> RunResult:
        """Execute the pipeline.

        ``lint`` opts into the static-analysis pre-flight gate: "error"
        refuses to run on any ERROR finding, "warn" on any finding at all;
        env ``TPP_LINT`` is the default when the argument is None, and
        "off" or unset skips the analyzer.  The gate runs before the
        metadata store is opened, so a refused run leaves no trace.

        ``from_nodes``/``to_nodes`` bound a partial run: nodes outside the
        range are not executed; their outputs are resolved from the latest
        LIVE artifacts already in the metadata store.

        ``resume_from`` ("latest" or a prior run id) continues a run whose
        orchestrator died: published COMPLETE/CACHED executions are adopted
        as they are, RUNNING-at-crash executions are fenced (ABANDONED,
        orphan output dirs removed), and only unfinished nodes and their
        descendants execute.  Refused when the compiled DAG's fingerprint no
        longer matches the one recorded for that run.
        """
        if resume_from and self.spmd_sync:
            raise ValueError(
                "resume_from is incompatible with spmd_sync: resume "
                "decisions are store-derived and per-process; use "
                "substrate-level restart (Argo retry) for multi-process nodes"
            )
        if resume_from and (from_nodes or to_nodes):
            raise ValueError(
                "resume_from is incompatible with from_nodes/to_nodes: a "
                "resume re-runs exactly the unfinished frontier of the "
                "prior run"
            )
        if resume_from and run_id:
            raise ValueError(
                "pass either resume_from (continues the prior run's id) or "
                "run_id, not both"
            )
        ir = Compiler().compile(pipeline)
        if self.spmd_sync:
            # An in-runner retry would wipe the shared output dirs while
            # peers are still inside the previous attempt's collectives
            # (lint rule TPP108).  Only IR-carried policies are refused: the
            # env rung is ignored under spmd_sync (_node_retry_policy).
            ir.spmd_sync = True
            retrying = sorted(
                n.id for n in ir.nodes
                if (
                    p := RetryPolicy.from_json(
                        getattr(n, "retry_policy", None)
                    ) or RetryPolicy.from_json(
                        getattr(ir, "default_retry_policy", None)
                    )
                ) is not None and p.max_attempts > 1 and not n.is_resolver
            )
            if retrying:
                raise ValueError(
                    f"spmd_sync is incompatible with in-runner retry "
                    f"policies (configured on {retrying}); use "
                    "substrate-level retries (Argo retryStrategy / JobSet "
                    "restarts) instead"
                )
        lint_level = None
        if not self.spmd_sync:
            # Under spmd_sync every process would lint redundantly; the
            # cluster runner gated the IR when it emitted the manifests.
            from tpu_pipelines_torch.analysis import resolve_lint_level

            lint_level = resolve_lint_level(lint)
        if lint_level:
            from tpu_pipelines_torch.analysis import (
                analyze_pipeline,
                gate_or_raise,
            )

            gate_or_raise(
                analyze_pipeline(pipeline, ir=ir), lint_level,
                f"LocalDagRunner pre-flight ({pipeline.name})",
            )
        selected = self._select_nodes(ir, from_nodes, to_nodes)
        if self.spmd_sync and len(selected) != 1:
            # Every process must issue the same collectives in the same
            # order; a failed-upstream skip issues none, so divergent
            # outcomes over several nodes would leave peers waiting.
            raise ValueError(
                "spmd_sync requires a single-node partial run "
                f"(from_nodes=to_nodes=[node]); selected {sorted(selected)}"
            )
        if self.spmd_sync and any(
            self._node_timeout_s(n, ir) > 0 for n in ir.nodes
        ):
            log.warning(
                "execution_timeout_s is not enforced under spmd_sync (the "
                "schedule must stay collective-deterministic); rely on the "
                "substrate deadline (activeDeadlineSeconds)"
            )
        executors = {c.id: c for c in pipeline.components}
        store = open_store(pipeline.metadata_path)
        dag_fp = ir.fingerprint()
        adopted: Dict[str, NodeResult] = {}
        try:
            if resume_from:
                run_id, adopted = self._prepare_resume(
                    store, ir, pipeline.name, resume_from, dag_fp
                )
            run_id = run_id or f"{pipeline.name}-{int(time.time() * 1000)}"
            pipeline_ctx = Context("pipeline", pipeline.name)
            run_ctx = Context(
                "pipeline_run", f"{pipeline.name}.{run_id}",
                properties={"run_id": run_id, "dag_fingerprint": dag_fp},
            )
            store.put_context(pipeline_ctx)
            store.put_context(run_ctx)
            # No run trace under spmd_sync: every process would append to
            # the same shared file.
            recorder = None
            if not self.spmd_sync:
                _trace.install_log_correlation()
                _trace.set_run_id(run_id)
                recorder = _trace.TraceRecorder.maybe_create(
                    _trace.run_trace_dir(ir.pipeline_root, run_id), run_id
                )
            result = RunResult(pipeline_name=pipeline.name, run_id=run_id)
            # The adopted nodes, in topo order; they settle before the first
            # dispatch (_run_nodes).
            for node in ir.nodes:
                if node.id in adopted and recorder:
                    nr = adopted[node.id]
                    recorder.instant(
                        "resume_adopt", cat="run", node=node.id,
                        args={
                            "status": nr.status,
                            "execution_id": nr.execution_id,
                        },
                    )
            result.max_parallel_nodes = self._effective_parallelism(ir)
            node_extras = dict(extras or {})
            node_extras["device"] = str(self.device)
            telemetry = _RunTelemetry(pipeline.name, run_id)
            if recorder:
                recorder.instant(
                    "run_start", cat="run",
                    args={
                        "pipeline": pipeline.name,
                        "max_parallel_nodes": result.max_parallel_nodes,
                        "resume_from": resume_from or "",
                        "adopted": sorted(adopted),
                        "dag_fingerprint": dag_fp,
                    },
                )
            try:
                with _trace.activate(recorder):
                    self._run_nodes(
                        store=store, ir=ir, executors=executors,
                        result=result,
                        runtime_parameters=dict(runtime_parameters or {}),
                        contexts=[pipeline_ctx, run_ctx], extras=node_extras,
                        enable_cache=pipeline.enable_cache,
                        telemetry=telemetry,
                        max_workers=result.max_parallel_nodes,
                        adopted=adopted, selected=selected,
                    )
                if recorder:
                    recorder.instant(
                        "run_end", cat="run",
                        args={"succeeded": result.succeeded},
                    )
            finally:
                telemetry.close()
                if recorder:
                    recorder.close()
        finally:
            store.close()
        if raise_on_failure and not result.succeeded:
            bad = [n for n in result.nodes.values() if n.status == "FAILED"]
            raise PipelineRunError(
                f"Pipeline {pipeline.name!r} run {run_id} failed at: "
                + ", ".join(
                    f"{n.node_id} ({n.error.splitlines()[-1] if n.error else ''})"
                    for n in bad),
                result,
            )
        return result

    # ------------------------------------------------------------ internals

    def _effective_parallelism(self, ir: PipelineIR) -> int:
        """Scheduler pool size: explicit arg > env > DAG roots; always 1
        under spmd_sync, whose schedule must not depend on local timing."""
        if self.spmd_sync:
            return 1
        if self.max_parallel_nodes is not None:
            return max(1, int(self.max_parallel_nodes))
        env = os.environ.get("TPP_MAX_PARALLEL_NODES", "")
        if env:
            return max(1, int(env))
        return max(1, ir.n_roots())

    @staticmethod
    def _node_timeout_s(node: NodeIR, ir: PipelineIR) -> float:
        """The node's execution deadline (0 = none): component override >
        pipeline default > env ``TPP_NODE_TIMEOUT_S``."""
        if node.execution_timeout_s and node.execution_timeout_s > 0:
            return float(node.execution_timeout_s)
        if ir.default_node_timeout_s and ir.default_node_timeout_s > 0:
            return float(ir.default_node_timeout_s)
        env = os.environ.get("TPP_NODE_TIMEOUT_S", "")
        if env:
            try:
                return max(0.0, float(env))
            except ValueError:
                log.warning("ignoring non-numeric TPP_NODE_TIMEOUT_S=%r", env)
        return 0.0

    def _node_retry_policy(
        self, node: NodeIR, ir: PipelineIR
    ) -> Optional[RetryPolicy]:
        """Effective executor retry policy (None = single attempt); never
        one under spmd_sync, whose retries are the substrate's (an env
        ``TPP_RETRY_*`` default must not arm one across processes)."""
        if self.spmd_sync:
            return None
        policy = RetryPolicy.from_json(getattr(node, "retry_policy", None))
        if policy is None:
            policy = RetryPolicy.from_json(
                getattr(ir, "default_retry_policy", None)
            )
        if policy is None:
            policy = RetryPolicy.from_env()
        if policy is None and self.max_retries:
            policy = RetryPolicy(
                max_attempts=self.max_retries + 1,
                base_delay_s=0.0,
                jitter=False,
            )
        return policy

    # -------------------------------------------------------------- resume

    def _prepare_resume(
        self,
        store: MetadataStore,
        ir: PipelineIR,
        pipeline_name: str,
        resume_from: str,
        dag_fp: str,
    ) -> Tuple[str, Dict[str, NodeResult]]:
        """Rebuild a crashed run's state from the metadata store.

        Returns ``(run_id, adopted)``: NodeResults for every node whose
        prior execution can be trusted, COMPLETE/CACHED with every output
        still LIVE (and every upstream itself adopted), or a Cond CANCELED
        skip record.  First the stale-execution sweep fences everything
        still RUNNING at the crash: ABANDONED in the store, its allocated
        output dirs removed, so the re-dispatch starts from a clean slate.
        """
        prefix = f"{pipeline_name}."
        candidates = [
            c for c in store.get_contexts("pipeline_run")
            if c.name.startswith(prefix)
        ]
        if resume_from != "latest":
            candidates = [
                c for c in candidates
                if c.properties.get("run_id") == resume_from
                or c.name == prefix + resume_from
            ]
        if not candidates:
            raise ValueError(
                f"resume_from={resume_from!r}: no prior run of pipeline "
                f"{pipeline_name!r} in {store.db_path!r}"
            )
        run_ctx = max(candidates, key=lambda c: c.id)
        prior_fp = run_ctx.properties.get("dag_fingerprint", "")
        if prior_fp != dag_fp:
            detail = (
                "was recorded before DAG fingerprinting existed"
                if not prior_fp
                else "was compiled from a different DAG (nodes, wiring, "
                     "exec-properties, or executor code changed)"
            )
            raise ValueError(
                f"resume refused: run {run_ctx.name!r} {detail}; start a "
                "fresh run instead (the execution cache still reuses any "
                "node whose inputs and code are unchanged)"
            )
        run_id = run_ctx.properties.get("run_id") or run_ctx.name[len(prefix):]

        by_id = {n.id: n for n in ir.nodes}
        fenced = store.sweep_stale_executions(run_ctx.id)
        for ex in fenced:
            node = by_id.get(ex.node_id)
            if node is None:
                continue
            for key in node.outputs:
                stale = os.path.join(ir.pipeline_root, node.id, key, str(ex.id))
                if os.path.isdir(stale):
                    shutil.rmtree(stale)

        # The newest decisive execution per node within the crashed run.
        decisive: Dict[str, Execution] = {}
        for ex in store.get_executions_by_context(run_ctx.id):  # id order
            if ex.state in (
                ExecutionState.COMPLETE, ExecutionState.CACHED,
                ExecutionState.FAILED, ExecutionState.ABANDONED,
            ) or (
                ex.state == ExecutionState.CANCELED
                and ex.properties.get("cond_skipped")
            ):
                decisive[ex.node_id] = ex

        adopted: Dict[str, NodeResult] = {}
        for node in ir.nodes:  # topo order: upstream adoption settles first
            ex = decisive.get(node.id)
            if ex is None or any(u not in adopted for u in node.upstream):
                # Nothing decisive, or an upstream re-runs: its recorded
                # outputs may not match what the re-run produces (the
                # execution cache still short-circuits identical work).
                continue
            if ex.state in (ExecutionState.COMPLETE, ExecutionState.CACHED):
                outputs = self._outputs_of_execution(store, node, ex)
                if outputs is None:
                    continue  # an output artifact went non-LIVE: re-run
                adopted[node.id] = NodeResult(
                    node_id=node.id, status=ex.state.value,
                    execution_id=ex.id, outputs=outputs, adopted=True,
                )
            elif ex.state == ExecutionState.CANCELED:
                adopted[node.id] = NodeResult(
                    node_id=node.id, status="COND_SKIPPED", adopted=True
                )
            # FAILED / ABANDONED: re-dispatched.
        rerun = sorted(n.id for n in ir.nodes if n.id not in adopted)
        log.info(
            "resume %s: adopting %d node(s), fenced %d stale execution(s), "
            "re-running %s",
            run_id, len(adopted), len(fenced), rerun or "nothing",
        )
        return run_id, adopted

    @staticmethod
    def _outputs_of_execution(
        store: MetadataStore, node: NodeIR, ex: Execution
    ) -> Optional[Dict[str, List[Artifact]]]:
        """One execution's outputs in event-index order, or None when any
        output artifact is no longer LIVE (adoption must be refused)."""
        candidate: Dict[str, List[tuple]] = {}
        for ev in store.get_events_by_execution(ex.id):
            if ev.type != EventType.OUTPUT:
                continue
            art = store.get_artifact(ev.artifact_id)
            if art is None or art.state != ArtifactState.LIVE:
                return None
            candidate.setdefault(ev.path, []).append((ev.index, art))
        if not candidate and node.outputs and not node.is_resolver:
            # Declared outputs but no OUTPUT events: corrupt state (an
            # interrupted publish), the same rule as the cache lookup.
            return None
        outputs: Dict[str, List[Artifact]] = (
            {key: [] for key in node.outputs} if node.is_resolver else {}
        )
        outputs.update({
            path: [a for _, a in sorted(pairs, key=lambda p: p[0])]
            for path, pairs in candidate.items()
        })
        return outputs

    # -------------------------------------------------------- partial runs

    @staticmethod
    def _select_nodes(
        ir: PipelineIR,
        from_nodes: Optional[Sequence[str]],
        to_nodes: Optional[Sequence[str]],
    ) -> set:
        """The node ids a partial run executes: downstream of (or equal
        to) any ``from_nodes`` and upstream of (or equal to) any
        ``to_nodes``; every node when both are empty."""
        all_ids = {n.id for n in ir.nodes}
        for nid in list(from_nodes or []) + list(to_nodes or []):
            if nid not in all_ids:
                raise ValueError(f"Unknown node in partial-run bounds: {nid!r}")
        selected = set(all_ids)
        if from_nodes:
            keep = set(from_nodes)
            changed = True
            while changed:
                changed = False
                for n in ir.nodes:
                    if n.id not in keep and any(u in keep for u in n.upstream):
                        keep.add(n.id)
                        changed = True
            selected &= keep
        if to_nodes:
            by_id = {n.id: n for n in ir.nodes}
            keep = set()
            stack = list(to_nodes)
            while stack:
                nid = stack.pop()
                if nid in keep:
                    continue
                keep.add(nid)
                stack.extend(by_id[nid].upstream)
            selected &= keep
        return selected

    def _partial_run_outcome(
        self, store: MetadataStore, node: NodeIR
    ) -> "NodeResult":
        """Verdict for a node outside a partial run's bounds: its newest
        Cond skip replays as ``COND_SKIPPED`` (directly gated or cascaded:
        both publish the CANCELED record), anything else settles
        ``SKIPPED`` with its latest LIVE outputs from prior runs.  Under
        spmd_sync the replayed skip is process 0's."""
        replay_skip = self._latest_is_cond_skip(store, node)
        if self.spmd_sync:
            replay_skip = bool(_dist.broadcast_int(1 if replay_skip else 0))
        if replay_skip:
            return NodeResult(node_id=node.id, status="COND_SKIPPED")
        return NodeResult(
            node_id=node.id, status="SKIPPED",
            outputs=self._resolve_prior_outputs(store, node),
        )

    @staticmethod
    def _latest_is_cond_skip(store: MetadataStore, node: NodeIR) -> bool:
        """True when the node's newest decisive execution (COMPLETE,
        CACHED, or a Cond CANCELED record) was a condition skip."""
        for ex in reversed(store.get_executions(node_id=node.id)):
            if ex.state in (ExecutionState.COMPLETE, ExecutionState.CACHED):
                return False
            if (
                ex.state == ExecutionState.CANCELED
                and ex.properties.get("cond_skipped")
            ):
                return True
        return False

    @staticmethod
    def _resolve_prior_outputs(
        store: MetadataStore, node: NodeIR
    ) -> Dict[str, List[Artifact]]:
        """Latest LIVE outputs of a node from prior runs, in event-index
        order (the order a cache hit hands downstream)."""
        outputs: Dict[str, List[Artifact]] = {}
        for ex in reversed(store.get_executions(node_id=node.id)):
            if ex.state not in (ExecutionState.COMPLETE, ExecutionState.CACHED):
                continue
            candidate: Dict[str, List[tuple]] = {}
            live = True
            for ev in store.get_events_by_execution(ex.id):
                if ev.type != EventType.OUTPUT:
                    continue
                art = store.get_artifact(ev.artifact_id)
                if art is None or art.state != ArtifactState.LIVE:
                    live = False
                    break
                candidate.setdefault(ev.path, []).append((ev.index, art))
            if node.is_resolver:
                # The newest resolver execution is authoritative: resolved
                # empty is a valid state, and a resolved artifact gone
                # non-LIVE means empty now.  An older execution would
                # resurrect a baseline the latest resolution rejected.
                outputs = {key: [] for key in node.outputs}
                if live:
                    outputs.update({
                        path: [a for _, a in sorted(pairs, key=lambda p: p[0])]
                        for path, pairs in candidate.items()
                    })
                break
            if live and candidate:
                outputs = {
                    path: [a for _, a in sorted(pairs, key=lambda p: p[0])]
                    for path, pairs in candidate.items()
                }
                break
        return outputs

    @staticmethod
    def _cond_outcome(
        store: MetadataStore,
        node: NodeIR,
        produced: Dict[str, Dict[str, List[Artifact]]],
        cond_skipped: set,
        runtime_parameters: Dict[str, Any],
        contexts: List[Context],
        publish_lock: threading.Lock,
        spmd_sync: bool = False,
    ) -> Optional["NodeResult"]:
        """Cond verdict for a node whose upstreams all settled without
        failure: COND_SKIPPED when a predicate fails or an upstream was
        condition-skipped (not a failure: the run still succeeds), FAILED
        when a predicate cannot be evaluated, None to dispatch.  A skip is
        recorded as a CANCELED execution carrying ``cond_skipped``, the
        verdict a partial run replays (``_latest_is_cond_skip``)."""
        from tpu_pipelines_torch.dsl.cond import (
            ConditionUnresolvedError,
            evaluate_condition,
        )

        cascade = any(u in cond_skipped for u in node.upstream)
        unmet: List[Any] = []
        cond_error: Optional[str] = None
        if node.conditions and not cascade:
            try:
                unmet = [
                    c for c in node.conditions
                    if not evaluate_condition(c, produced, runtime_parameters)
                ]
            except ConditionUnresolvedError as e:
                cond_error = str(e)
        skip = cascade or bool(unmet)
        if spmd_sync and (node.conditions or cascade):
            # Process 0's verdict is authoritative, or divergent snapshots
            # would leave some processes in the executor's collectives
            # while others skipped.
            verdict = _dist.broadcast_int(
                2 if cond_error else (1 if skip else 0))
            skip = verdict == 1
            if verdict == 2 and cond_error is None:
                cond_error = ("condition unresolved on process 0 (producer "
                              "has no published outputs)")
            elif verdict != 2:
                cond_error = None
        if cond_error:
            return NodeResult(node_id=node.id, status="FAILED",
                              error=cond_error)
        if not skip:
            return None
        log.info(
            "node %s: condition not met%s; skipping",
            node.id, "" if cascade else f" ({unmet})",
        )
        if not spmd_sync or _dist.process_index() == 0:
            ex = Execution(
                type_name=node.component_type,
                node_id=node.id,
                state=ExecutionState.CANCELED,
                properties={"cond_skipped": True, "unmet_conditions": unmet},
            )
            with publish_lock:
                store.publish_execution(ex, {}, {}, contexts)
        return NodeResult(node_id=node.id, status="COND_SKIPPED")

    def _run_nodes(
        self, *, store, ir, executors, result, runtime_parameters, contexts,
        extras, enable_cache, telemetry, max_workers: int,
        adopted: Dict[str, NodeResult], selected: set,
    ) -> None:
        """Ready-set scheduler: dispatch any node whose upstreams have all
        settled, lowest topo index first; executors run in a worker pool
        while the driver (and so execution-id/URI assignment) stays in this
        thread.  At most one "tpu" node is in flight at a time.  A failing
        node marks its descendants FAILED without cancelling in-flight or
        independent work.  Each node's ``node`` span runs from its dispatch
        to its settle; queue wait is dispatch less the moment it became
        ready, gate wait the time it waited for the device.

        The scheduler's wait is the deadline watchdog: it blocks until a
        completion arrives or the nearest in-flight deadline expires; an
        expired node settles FAILED at once and its worker's eventual
        result is discarded (a zombie).  Adopted (resumed) nodes settle
        before the first dispatch; a node outside a partial run's bounds
        settles from the store (``_partial_run_outcome``)."""
        publish_lock = threading.Lock()
        by_id = {n.id: n for n in ir.nodes}
        produced: Dict[str, Dict[str, List[Artifact]]] = {}
        failed: set = set()
        cond_skipped: set = set()
        settled: set = set()
        in_flight: set = set()
        in_flight_plans: Dict[str, _LaunchPlan] = {}
        tpu_in_flight: Optional[str] = None
        done_q: "queue_mod.Queue" = queue_mod.Queue()
        rec = _trace.active_recorder()
        ready_at: Dict[str, tuple] = {}         # nid -> (wall, mono)
        gate_blocked_at: Dict[str, float] = {}  # nid -> mono
        dispatch_info: Dict[str, tuple] = {}    # nid -> (wall, mono, qw, gw)
        # nid -> absolute monotonic deadline of an in-flight timed node.
        deadlines: Dict[str, float] = {}
        # Nodes settled FAILED(timeout) whose worker has not returned yet.
        zombies: set = set()

        def emit_node(nr: NodeResult, t0: tuple, queue_wait: float,
                      gate_wait: float) -> None:
            telemetry.heartbeat(nr.node_id)  # settle heartbeat
            if rec is None:
                return
            wall0, mono0 = t0
            rec.complete(
                "node", "scheduler", nr.node_id, wall0, mono0,
                time.monotonic() - mono0,
                args={
                    "status": nr.status,
                    "execution_id": nr.execution_id,
                    "retries": nr.retries,
                    "queue_wait_s": round(queue_wait, 6),
                    "gate_wait_s": round(gate_wait, 6),
                    "upstream": list(by_id[nr.node_id].upstream),
                },
            )

        def settle(nr: NodeResult) -> None:
            result.nodes[nr.node_id] = nr
            settled.add(nr.node_id)
            if nr.status in ("COMPLETE", "CACHED", "SKIPPED"):
                produced[nr.node_id] = nr.outputs
            elif nr.status == "COND_SKIPPED":
                cond_skipped.add(nr.node_id)
                produced[nr.node_id] = {}
            else:
                failed.add(nr.node_id)

        def finish(nr: NodeResult) -> None:
            """Settle an executed (or expired) node and emit its span."""
            nonlocal tpu_in_flight
            in_flight.discard(nr.node_id)
            in_flight_plans.pop(nr.node_id, None)
            deadlines.pop(nr.node_id, None)
            if tpu_in_flight == nr.node_id:
                tpu_in_flight = None  # release the device gate
            settle(nr)
            dw, dm, qw, gw = dispatch_info.pop(nr.node_id)
            emit_node(nr, (dw, dm), qw, gw)

        def worker(plan: _LaunchPlan, node_extras: Dict[str, Any]) -> None:
            try:
                # Worker threads have fresh contextvar contexts: stamp the
                # run/node ids so this thread's log records are attributable.
                with _trace.node_log_context(
                    plan.node.id, rec.run_id if rec else ""
                ):
                    nr = self._execute_and_publish(
                        store, plan, node_extras, publish_lock)
            except _faults.SimulatedCrash as crash:
                # Forward the injected orchestrator death to the scheduler
                # thread, which re-raises it (the whole process "dies").
                done_q.put(crash)
                return
            except Exception:
                # Runner-internal failure: settle the node as FAILED instead
                # of deadlocking the scheduler on a completion that never
                # arrives.
                nr = NodeResult(
                    node_id=plan.node.id, status="FAILED",
                    error=traceback.format_exc(),
                )
            done_q.put(nr)

        for node in ir.nodes:
            if node.id in adopted:
                settle(adopted[node.id])
        unprocessed = [n.id for n in ir.nodes if n.id not in settled]
        pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="tpp-node"
        )
        try:
            while unprocessed or in_flight:
                telemetry.progress(len(unprocessed), len(in_flight), result)
                progressed = False
                # With a single worker, hold back later nodes until the
                # in-flight one settles (the sequential loop's order).
                scan = (
                    [] if (max_workers == 1 and in_flight)
                    else list(unprocessed)
                )
                for nid in scan:
                    node = by_id[nid]
                    if any(u not in settled for u in node.upstream):
                        continue
                    if nid not in ready_at:
                        ready_at[nid] = (time.time(), time.monotonic())
                    try:
                        if nid not in selected:
                            nr = self._partial_run_outcome(store, node)
                        elif any(u in failed for u in node.upstream):
                            nr = NodeResult(
                                node_id=nid, status="FAILED",
                                error="upstream failure")
                        else:
                            nr = self._cond_outcome(
                                store, node, produced, cond_skipped,
                                runtime_parameters, contexts, publish_lock,
                                spmd_sync=self.spmd_sync,
                            )
                    except StoreUnavailableError as e:
                        nr = NodeResult(
                            node_id=nid, status="FAILED",
                            error=f"metadata store unavailable: {e}",
                        )
                    if nr is not None:
                        settle(nr)
                        unprocessed.remove(nid)
                        progressed = True
                        emit_node(nr, ready_at[nid], 0.0, 0.0)
                        continue
                    if len(in_flight) >= max_workers:
                        continue
                    if node.resource_class == "tpu" and tpu_in_flight:
                        # the device is busy; host nodes may go
                        gate_blocked_at.setdefault(nid, time.monotonic())
                        continue
                    dispatch_wall, dispatch_mono = time.time(), time.monotonic()
                    queue_wait = dispatch_mono - ready_at[nid][1]
                    gate_wait = (
                        dispatch_mono - gate_blocked_at.pop(nid)
                        if nid in gate_blocked_at else 0.0
                    )
                    try:
                        prepared = self._prepare_node(
                            store, ir, node, executors[nid], produced,
                            runtime_parameters, contexts, enable_cache,
                            publish_lock,
                        )
                    except StoreUnavailableError as e:
                        prepared = NodeResult(
                            node_id=nid, status="FAILED",
                            error=f"metadata store unavailable: {e}",
                        )
                    unprocessed.remove(nid)
                    progressed = True
                    if isinstance(prepared, NodeResult):
                        settle(prepared)  # cache hit or driver failure
                        emit_node(prepared, (dispatch_wall, dispatch_mono),
                                  queue_wait, gate_wait)
                        continue
                    in_flight.add(nid)
                    in_flight_plans[nid] = prepared
                    dispatch_info[nid] = (
                        dispatch_wall, dispatch_mono, queue_wait, gate_wait
                    )
                    if prepared.deadline_s > 0:
                        deadlines[nid] = time.monotonic() + prepared.deadline_s
                    if node.resource_class == "tpu":
                        tpu_in_flight = nid
                    node_extras = dict(extras)
                    # Cooperative cancellation: set on deadline expiry and at
                    # drain, so a long-running executor can abort.
                    node_extras["cancel_event"] = prepared.cancel
                    telemetry.heartbeat(nid, dispatched=True)
                    pool.submit(worker, prepared, node_extras)
                    if self.spmd_sync:
                        # The worker's collectives must not overlap this
                        # thread's (a later node's store verdict): settle
                        # nothing more until it returns, in topo order as
                        # the reference's sequential loop.
                        break
                if progressed:
                    continue
                if not in_flight:
                    raise RuntimeError(
                        f"scheduler stalled with pending nodes {unprocessed}"
                    )
                # Watchdog wait: a completion, or the nearest deadline.
                wait_s = None
                if deadlines:
                    wait_s = max(0.0, min(deadlines.values()) - time.monotonic())
                try:
                    item = done_q.get(timeout=wait_s)
                except queue_mod.Empty:
                    now = time.monotonic()
                    for nid in [n for n, d in deadlines.items() if d <= now]:
                        expired = self._expire_deadline(
                            store, in_flight_plans[nid], publish_lock
                        )
                        deadlines.pop(nid)
                        if expired is None:
                            continue  # published concurrently: result coming
                        zombies.add(nid)
                        finish(expired)
                    continue
                if isinstance(item, BaseException):
                    raise item  # a forwarded SimulatedCrash
                if item.node_id in zombies:
                    # The timed-out worker finally returned (its publish was
                    # fenced); the node is already settled FAILED(timeout).
                    zombies.discard(item.node_id)
                    continue
                finish(item)
            telemetry.progress(len(unprocessed), len(in_flight), result)
        finally:
            # Release every cooperative hang, give timed-out workers a short
            # grace to drain, then shut down without blocking on a wedged
            # thread (it holds no lock and its publish is fenced).
            for plan in in_flight_plans.values():
                plan.cancel.set()
            grace = time.monotonic() + 2.0
            while zombies and time.monotonic() < grace:
                try:
                    item = done_q.get(timeout=0.1)
                except queue_mod.Empty:
                    continue
                if isinstance(item, NodeResult):
                    zombies.discard(item.node_id)
            pool.shutdown(wait=not zombies)

    def _expire_deadline(
        self,
        store: MetadataStore,
        plan: _LaunchPlan,
        publish_lock: threading.Lock,
    ) -> Optional[NodeResult]:
        """Watchdog expiry of one in-flight node: fence the worker's future
        publish, record the FAILED(timeout) execution, and release the
        (cooperative) executor through the cancel event.  None when the
        worker's publish already won the race (its completion is on the
        done queue), else the timeout NodeResult to settle.

        An expiry is terminal: the hung attempt cannot be reaped, so a
        clean-slate retry would race its writes; the timeout uses up the
        node's retry budget.
        """
        node, ex = plan.node, plan.execution
        with publish_lock:
            if plan.published.is_set():
                return None
            plan.fenced.set()
            plan.cancel.set()
            wall = time.time() - plan.t0
            error = (
                f"execution timeout: node {node.id!r} exceeded its "
                f"{plan.deadline_s:g}s deadline"
            )
            ex.state = ExecutionState.FAILED
            ex.properties.update({
                "wall_clock_s": round(wall, 4),
                "timeout": True,
                "error": error,
            })
            try:
                # Outputs publish as ABANDONED at their allocated URIs; the
                # wedged executor may still be writing under them, which is
                # why they are never adopted or cached.
                store.publish_execution(
                    ex, plan.inputs, plan.outputs, plan.all_ctx
                )
            except StoreUnavailableError as e:
                log.error(
                    "node %s: metadata store unavailable while recording "
                    "timeout: %s", node.id, e,
                )
        log.warning("node %s: %s", node.id, error)
        _trace.instant(
            "deadline_expired", cat="scheduler", node=node.id,
            args={"deadline_s": plan.deadline_s, "execution_id": ex.id},
        )
        return NodeResult(
            node_id=node.id, status="FAILED", execution_id=ex.id,
            error=error, wall_clock_s=wall,
        )

    def _prepare_node(
        self,
        store: MetadataStore,
        ir: PipelineIR,
        node: NodeIR,
        component,
        produced: Dict[str, Dict[str, List[Artifact]]],
        runtime_parameters: Dict[str, Any],
        contexts: List[Context],
        enable_cache: bool,
        publish_lock: threading.Lock,
    ):
        """DRIVER phase: input resolution, cache check, and on a cache miss
        RUNNING-execution registration and output allocation.  Returns a
        NodeResult for nodes finished without an executor (cache hit,
        driver failure), else a _LaunchPlan.  Traced as the ``driver``
        span."""
        t0 = time.time()
        # Fault hook: kill-orchestrator-at-node-N fires here, in the
        # scheduler thread, before any state for this node is registered.
        _faults.at_dispatch(node.id)
        with contextlib.ExitStack() as stack:
            stack.enter_context(_trace.node_log_context(node.id))
            stack.enter_context(
                _trace.span("driver", cat="scheduler", node=node.id)
            )
            return self._prepare_node_inner(
                store, ir, node, component, produced, runtime_parameters,
                contexts, enable_cache, publish_lock, t0,
            )

    def _prepare_node_inner(
        self, store, ir, node, component, produced, runtime_parameters,
        contexts, enable_cache, publish_lock, t0,
    ):
        node_ctx = Context("node", f"{ir.name}.{node.id}")
        with publish_lock:
            store.put_context(node_ctx)
        all_ctx = contexts + [node_ctx]

        if node.is_resolver:
            with publish_lock:
                return self._run_resolver_node(
                    store, ir, node, all_ctx, t0, runtime_parameters
                )

        resolve_error = ""
        try:
            inputs = self._resolve_inputs(node, produced)
        except KeyError as e:
            inputs = {}
            resolve_error = f"input resolution failed: {e}"
        if self.spmd_sync:
            # Process 0's resolution is authoritative: a worker that failed
            # (or resolved otherwise) against its snapshot takes process
            # 0's artifacts; when process 0 failed, every process fails.
            if _dist.broadcast_int(0 if resolve_error else 1):
                inputs = _spmd_sync_inputs(inputs)
                resolve_error = ""
            elif not resolve_error:
                resolve_error = "input resolution failed on process 0"
        if resolve_error:
            return NodeResult(
                node_id=node.id, status="FAILED", error=resolve_error,
            )
        props = {
            k: resolve_property(v, runtime_parameters)
            for k, v in node.exec_properties.items()
        }
        input_fps = {
            key: [a.fingerprint or f"artifact:{a.id}" for a in arts]
            for key, arts in inputs.items()
        }
        external_fps: Dict[str, str] = {}
        # External data named by path-valued exec-properties participates by
        # content, so editing a source file invalidates the cache even though
        # the path string is unchanged; {SPAN}/{VERSION} patterns resolve to
        # the concrete directory first.
        for param in node.external_input_parameters:
            path = props.get(param)
            if isinstance(path, str) and has_span_pattern(path):
                try:
                    path, r_span, r_version = resolve_span_pattern(
                        path, props.get("span"), props.get("version"),
                    )
                except FileNotFoundError:
                    path = None  # the executor raises with the real error
                else:
                    input_fps[f"__span__:{param}"] = [
                        f"span={r_span}:version={r_version}"
                    ]
            if isinstance(path, str) and os.path.exists(path):
                fp = fingerprint_dir(path)
                input_fps[f"__external__:{param}"] = [fp]
                external_fps[os.path.abspath(path)] = fp
        cache_key = execution_cache_key(
            node.id, node.executor_version, props, input_fps
        )

        cached = store.get_cached_outputs(cache_key) if enable_cache else None
        if self.spmd_sync:
            # Every process takes process 0's cache verdict, so none
            # executes (and waits in collectives) while process 0 takes the
            # cached shortcut.  A worker's snapshot is a subset of the live
            # store: a hit on process 0 alone is the case handled here.
            hit = _dist.broadcast_int(1 if cached is not None else 0)
            if hit and cached is None:
                log.info(
                    "node %s: process 0 reported a cache hit not in this "
                    "worker's snapshot; skipping execution", node.id,
                )
                return NodeResult(
                    node_id=node.id, status="CACHED",
                    wall_clock_s=time.time() - t0,
                )
            if not hit:
                cached = None
        if cached is not None:
            ex = Execution(
                type_name=node.component_type,
                node_id=node.id,
                state=ExecutionState.CACHED,
                properties={"cache_hit": True},
                cache_key=cache_key,
            )
            with publish_lock:
                store.publish_execution(ex, inputs, cached, all_ctx)
            log.info("node %s: cache hit (execution %d)", node.id, ex.id)
            _trace.instant(
                "cache_hit", cat="scheduler", node=node.id,
                args={"execution_id": ex.id},
            )
            return NodeResult(
                node_id=node.id,
                status="CACHED",
                execution_id=ex.id,
                outputs=cached,
                wall_clock_s=time.time() - t0,
            )

        if enable_cache:
            _trace.instant("cache_miss", cat="scheduler", node=node.id)
        ex = Execution(
            type_name=node.component_type,
            node_id=node.id,
            state=ExecutionState.RUNNING,
            properties={},
            cache_key=cache_key,
        )
        with publish_lock:
            store.put_execution(ex)
            for ctx in all_ctx:
                store.associate(ctx.id, ex.id)
        # Output URIs embed the execution id; under spmd_sync process 0's
        # is authoritative, so every process writes one shared tree.
        # Process 0 wipes a stale dir BEFORE the broadcast releases the
        # workers: afterwards nobody may delete under the shared URIs.
        uri_ex_id = ex.id
        if self.spmd_sync:
            if _dist.process_index() == 0:
                for key in node.outputs:
                    stale = os.path.join(
                        ir.pipeline_root, node.id, key, str(ex.id))
                    if os.path.isdir(stale):
                        shutil.rmtree(stale)
            uri_ex_id = _dist.broadcast_int(ex.id)
        outputs: Dict[str, List[Artifact]] = {}
        for key, type_name in node.outputs.items():
            uri = os.path.join(ir.pipeline_root, node.id, key, str(uri_ex_id))
            outputs[key] = [Artifact(type_name=type_name, uri=uri)]
        return _LaunchPlan(
            node=node, component=component, inputs=inputs, props=props,
            external_fps=external_fps, execution=ex, outputs=outputs,
            all_ctx=all_ctx, t0=t0,
            # Under spmd_sync no watchdog: the substrate's deadline holds.
            deadline_s=0.0 if self.spmd_sync else self._node_timeout_s(node, ir),
            retry_policy=self._node_retry_policy(node, ir),
        )

    def _execute_and_publish(
        self,
        store: MetadataStore,
        plan: _LaunchPlan,
        extras: Dict[str, Any],
        publish_lock: threading.Lock,
    ) -> NodeResult:
        """LAUNCHER + PUBLISHER phases: run the executor (with per-node
        retries), then fingerprint and publish under the publish lock.  The
        node deadline (enforced by the scheduler's watchdog) covers every
        attempt and backoff; its cancel event stops the retries."""
        node, ex = plan.node, plan.execution
        inputs, props, outputs = plan.inputs, plan.props, plan.outputs
        error = ""
        extra_props: Dict[str, Any] = {}
        attempts = 1
        executor = plan.component.EXECUTOR
        # The runner-allocated output locations: every retry resets to, and
        # cleans, the ALLOCATED path, never an executor-reassigned one.
        allocated_uris = {
            id(a): a.uri for arts in outputs.values() for a in arts
        }
        policy = plan.retry_policy or RetryPolicy(
            max_attempts=1, base_delay_s=0.0, jitter=False
        )
        retry_t0 = time.monotonic()
        if executor is None:
            error = f"component {node.id} has no executor"
        else:
            while True:
                tmp = tempfile.mkdtemp(prefix=f"tpp-{node.id}-")
                try:
                    for arts in outputs.values():
                        for a in arts:
                            a.uri = allocated_uris[id(a)]
                            # spmd_sync: process 0 wiped the shared dirs
                            # before the id broadcast; deleting here would
                            # race the other processes.
                            if not self.spmd_sync and os.path.isdir(a.uri):
                                shutil.rmtree(a.uri)  # clean slate on retry
                            os.makedirs(a.uri, exist_ok=True)
                    ctx = ExecutorContext(
                        node_id=node.id,
                        inputs=inputs,
                        outputs=outputs,
                        exec_properties=props,
                        tmp_dir=tmp,
                        extras=dict(extras),
                    )
                    with _trace.span(
                        "executor", cat="executor", node=node.id,
                        args={"attempt": attempts},
                    ) as tsp:
                        # Fault hook: raise-in-executor / cooperative hang.
                        _faults.in_executor(node.id, plan.cancel)
                        ret = executor(ctx)
                        _faults.after_executor(node.id)
                        tsp["ok"] = True
                    extra_props = dict(ret or {})
                    error = ""
                    break
                except Exception as exc:
                    error = traceback.format_exc()
                    verdict = classify_error(exc)
                    log.warning(
                        "node %s attempt %d/%d failed (%s):\n%s",
                        node.id, attempts, policy.max_attempts, verdict,
                        error,
                    )
                    if attempts >= policy.max_attempts or verdict != TRANSIENT:
                        break
                    delay = policy.backoff_s(attempts)
                    if policy.deadline_s > 0:
                        remaining = policy.deadline_s - (
                            time.monotonic() - retry_t0
                        )
                        if remaining <= 0:
                            break
                        delay = min(delay, remaining)
                    if plan.cancel.is_set():
                        break  # watchdog expiry or drain: stop retrying
                    record_retry(f"node:{node.id}")
                    _trace.instant(
                        "retry", cat="executor", node=node.id,
                        args={
                            "attempt": attempts,
                            "backoff_s": round(delay, 4),
                            "error_kind": type(exc).__name__,
                        },
                    )
                    # Backoff waits on the cancel event, so a draining run
                    # (or the deadline watchdog) wakes it at once.
                    if delay > 0 and plan.cancel.wait(delay):
                        break
                    attempts += 1
                finally:
                    shutil.rmtree(tmp, ignore_errors=True)

        if self.spmd_sync:
            # The status all-gather is also the barrier that lands every
            # process's writes before process 0 fingerprints the shared
            # dirs.  A failure anywhere fails the node everywhere: else
            # process 0 would publish COMPLETE (and a cache entry) over an
            # output a worker never finished.
            failed_on = [i for i, bad in enumerate(
                _dist.allgather_int(1 if error else 0)) if bad]
            if failed_on and not error:
                error = f"executor failed on process(es) {failed_on}"
            if _dist.process_index() != 0:
                # A worker's store is a scratch copy: no fingerprint, no
                # publish.
                for arts in outputs.values():
                    for a in arts:
                        a.uri = allocated_uris[id(a)]
                return NodeResult(
                    node_id=node.id,
                    status="FAILED" if error else "COMPLETE",
                    outputs={} if error else outputs, error=error,
                    wall_clock_s=time.time() - plan.t0,
                    retries=attempts - 1,
                )
        wall = time.time() - plan.t0
        ex.properties.update(extra_props)
        ex.properties.update(
            {"wall_clock_s": round(wall, 4), "retries": attempts - 1}
        )
        if error:
            # The ABANDONED record points at the allocated dirs, never at a
            # path the executor re-pointed an output to (an Importer's
            # source): ABANDONED is what a collector may delete.
            for arts in outputs.values():
                for a in arts:
                    a.uri = allocated_uris[id(a)]
            ex.state = ExecutionState.FAILED
            ex.properties["error"] = error.splitlines()[-1]
            publish_err = self._publish_fenced(store, plan, publish_lock)
            if publish_err:
                error = f"{error}\n{publish_err}"
            return NodeResult(
                node_id=node.id, status="FAILED", execution_id=ex.id,
                error=error, wall_clock_s=wall, retries=attempts - 1,
            )
        # Fault hook: crash after success, before publish (the state a
        # resume must fence: a RUNNING execution and written payload dirs).
        _faults.before_publish(node.id)
        with _trace.span("fingerprint", cat="executor", node=node.id):
            for arts in outputs.values():
                for a in arts:
                    a.fingerprint = (
                        plan.external_fps.get(os.path.abspath(a.uri))
                        or fingerprint_dir(a.uri)
                    )
        ex.state = ExecutionState.COMPLETE
        publish_err = self._publish_fenced(store, plan, publish_lock)
        if publish_err is not None:
            return NodeResult(
                node_id=node.id, status="FAILED", execution_id=ex.id,
                error=publish_err, wall_clock_s=wall, retries=attempts - 1,
            )
        if plan.fenced.is_set():
            # The watchdog expired this node while the executor finished:
            # the scheduler already settled and published FAILED(timeout);
            # this result is discarded as a zombie.
            return NodeResult(
                node_id=node.id, status="FAILED", execution_id=ex.id,
                error="fenced by deadline watchdog", wall_clock_s=wall,
            )
        # Fault hook: crash right after publish (the state a resume adopts).
        _faults.after_publish(node.id)
        log.info(
            "node %s: COMPLETE in %.2fs (execution %d)", node.id, wall, ex.id
        )
        return NodeResult(
            node_id=node.id, status="COMPLETE", execution_id=ex.id,
            outputs=outputs, wall_clock_s=wall, retries=attempts - 1,
        )

    @staticmethod
    def _publish_fenced(
        store: MetadataStore, plan: _LaunchPlan, publish_lock: threading.Lock,
    ) -> Optional[str]:
        """Publish the plan's execution unless the deadline watchdog fenced
        it first.  The fenced/published handshake runs under the publish
        lock, so exactly one of the worker's publish and the watchdog's
        FAILED(timeout) publish reaches the store.  An error string when
        the store is unavailable (the caller records a node failure), else
        None."""
        try:
            with _trace.span(
                "publish", cat="executor", node=plan.node.id,
                args={"state": plan.execution.state.value},
            ), publish_lock:
                if plan.fenced.is_set():
                    return None  # the watchdog published FAILED(timeout)
                plan.published.set()
                store.publish_execution(
                    plan.execution, plan.inputs, plan.outputs, plan.all_ctx
                )
        except StoreUnavailableError as e:
            log.error(
                "node %s: metadata store unavailable during publish: %s",
                plan.node.id, e,
            )
            return f"metadata store unavailable during publish: {e}"
        return None

    def _run_resolver_node(
        self,
        store: MetadataStore,
        ir: PipelineIR,
        node: NodeIR,
        all_ctx: List[Context],
        t0: float,
        runtime_parameters: Dict[str, Any],
    ) -> NodeResult:
        """Driver-level Resolver execution (TFX Resolver semantics): query
        the store per the configured strategy and publish an execution
        whose OUTPUT events reference the existing artifacts (same ids);
        never cached, since the answer changes as runs accumulate."""
        from tpu_pipelines_torch.components.resolver import resolve_artifacts

        props = {
            k: resolve_property(v, runtime_parameters)
            for k, v in node.exec_properties.items()
        }
        error = ""
        outputs: Dict[str, List[Artifact]] = {}
        try:
            outputs = resolve_artifacts(
                store,
                strategy=props.get("strategy", "latest_blessed_model"),
                pipeline_name=ir.name,
                within_pipeline=bool(props.get("within_pipeline", True)),
                # Strategy-specific knobs (rolling_window's span count and
                # producer filters) ride the exec properties verbatim.
                extra=props,
            )
        except Exception:
            error = traceback.format_exc()
        if self.spmd_sync:
            # Process 0's store view is authoritative (snapshot skew).
            if _dist.broadcast_int(0 if error else 1):
                outputs = _spmd_sync_inputs(outputs)
                error = ""
            elif not error:
                error = "resolver failed on process 0"
        if error:
            return NodeResult(node_id=node.id, status="FAILED", error=error)
        resolved_ids = sorted(a.id for arts in outputs.values() for a in arts)
        wall = time.time() - t0
        ex = Execution(
            type_name=node.component_type,
            node_id=node.id,
            state=ExecutionState.COMPLETE,
            properties={
                "strategy": props.get("strategy"),
                "resolved_artifact_ids": resolved_ids,
                "wall_clock_s": round(wall, 4),
            },
        )
        if not self.spmd_sync or _dist.process_index() == 0:
            store.publish_execution(ex, {}, outputs, all_ctx)
        ex_id = ex.id
        if self.spmd_sync:
            # Only process 0 published: its id is the one in the shared
            # store, so every process's result carries it.
            ex_id = _dist.broadcast_int(ex_id)
        log.info(
            "node %s: RESOLVED %s (execution %d)",
            node.id, resolved_ids or "nothing", ex_id,
        )
        return NodeResult(
            node_id=node.id, status="COMPLETE", execution_id=ex_id,
            outputs=outputs, wall_clock_s=wall,
        )

    @staticmethod
    def _resolve_inputs(
        node: NodeIR, produced: Dict[str, Dict[str, List[Artifact]]]
    ) -> Dict[str, List[Artifact]]:
        inputs: Dict[str, List[Artifact]] = {}
        for key, refs in node.inputs.items():
            arts: List[Artifact] = []
            for ref in refs:
                if not ref.producer:
                    raise KeyError(
                        f"{node.id}: input {key!r} is wired to a channel with "
                        "no producer component; external data must enter via "
                        "an ingestion component (e.g. ExampleGen path param)"
                    )
                up = produced.get(ref.producer)
                if up is None:
                    raise KeyError(
                        f"{node.id}: upstream {ref.producer} produced nothing"
                    )
                got = up.get(ref.output_key)
                if not got:
                    # A Resolver that found nothing publishes an empty
                    # output list; an optional input wired to it resolves
                    # to an empty list, the key present, so the executor
                    # tells wired-but-empty (the resolver's bootstrap) from
                    # never-wired.  Anything else fails.
                    if key in node.optional_inputs:
                        continue
                    raise KeyError(
                        f"{node.id}: upstream {ref.producer} has no output "
                        f"{ref.output_key!r}"
                    )
                arts.extend(got)
            inputs[key] = arts
        return inputs
