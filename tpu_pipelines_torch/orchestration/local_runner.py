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

Not ported, and refused with ``NotImplementedError`` naming the
``ROADMAP.md`` item: ``spmd_sync`` multi-process runs (A10); the XLA
compile cache (no counterpart: the port's kernels build once per checkout);
the run trace and the run-progress telemetry server (A17); the lint
pre-flight (A20); Resolver nodes and Cond (A18); ``resume_from``, partial
runs and node deadlines (A22); metric federation and fault injection (A10,
A22).
"""

from __future__ import annotations

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
from typing import Any, Dict, List, Optional

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
from tpu_pipelines_torch.metadata.types import (
    Artifact,
    Context,
    Execution,
    ExecutionState,
)
from tpu_pipelines_torch.robustness import (
    TRANSIENT,
    RetryPolicy,
    classify_error,
    record_retry,
)
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


@dataclasses.dataclass
class NodeResult:
    node_id: str
    status: str   # COMPLETE | CACHED | FAILED
    execution_id: int = 0
    outputs: Dict[str, List[Artifact]] = dataclasses.field(default_factory=dict)
    error: str = ""
    wall_clock_s: float = 0.0
    retries: int = 0


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
            n.status in ("COMPLETE", "CACHED") for n in self.nodes.values()
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
    retry_policy: Optional[RetryPolicy] = None


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"LocalDagRunner: {what} is not ported yet (ROADMAP.md {item})"
    )


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
    """

    def __init__(
        self,
        max_retries: int = 0,
        max_parallel_nodes: Optional[int] = None,
        device: Any = "cuda",
        spmd_sync: bool = False,
    ):
        if spmd_sync:
            raise _unported("spmd_sync (multi-process runs)", "A10")
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
        from_nodes=None,
        to_nodes=None,
        resume_from: Optional[str] = None,
        lint: Optional[str] = None,
    ) -> RunResult:
        """Execute the pipeline; every node runs (or is a cache hit)."""
        if from_nodes or to_nodes:
            raise _unported("a partial run (from_nodes/to_nodes)", "A22")
        if resume_from:
            raise _unported("resume_from", "A22")
        if lint or os.environ.get("TPP_LINT", "off").strip() not in ("", "off"):
            raise _unported("the lint pre-flight", "A20")
        ir = Compiler().compile(pipeline)
        for node in ir.nodes:
            if node.is_resolver:
                raise _unported(f"Resolver node {node.id!r}", "A18")
            if self._node_timeout_s(node, ir) > 0:
                raise _unported(f"node deadlines ({node.id!r})", "A22")
        executors = {c.id: c for c in pipeline.components}
        store = open_store(pipeline.metadata_path)
        try:
            run_id = run_id or f"{pipeline.name}-{int(time.time() * 1000)}"
            pipeline_ctx = Context("pipeline", pipeline.name)
            run_ctx = Context(
                "pipeline_run", f"{pipeline.name}.{run_id}",
                properties={"run_id": run_id,
                            "dag_fingerprint": ir.fingerprint()},
            )
            store.put_context(pipeline_ctx)
            store.put_context(run_ctx)
            result = RunResult(pipeline_name=pipeline.name, run_id=run_id)
            result.max_parallel_nodes = self._effective_parallelism(ir)
            node_extras = dict(extras or {})
            node_extras["device"] = str(self.device)
            self._run_nodes(
                store=store, ir=ir, executors=executors, result=result,
                runtime_parameters=dict(runtime_parameters or {}),
                contexts=[pipeline_ctx, run_ctx], extras=node_extras,
                enable_cache=pipeline.enable_cache,
                max_workers=result.max_parallel_nodes,
            )
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
        """Scheduler pool size: explicit arg > env > DAG roots."""
        if self.max_parallel_nodes is not None:
            return max(1, int(self.max_parallel_nodes))
        env = os.environ.get("TPP_MAX_PARALLEL_NODES", "")
        if env:
            return max(1, int(env))
        return max(1, ir.n_roots())

    @staticmethod
    def _node_timeout_s(node: NodeIR, ir: PipelineIR) -> float:
        """The deadline the reference would enforce (0 = none): component
        override > pipeline default > env ``TPP_NODE_TIMEOUT_S``."""
        if node.execution_timeout_s and node.execution_timeout_s > 0:
            return float(node.execution_timeout_s)
        if ir.default_node_timeout_s and ir.default_node_timeout_s > 0:
            return float(ir.default_node_timeout_s)
        env = os.environ.get("TPP_NODE_TIMEOUT_S", "")
        try:
            return max(0.0, float(env)) if env else 0.0
        except ValueError:
            return 0.0

    def _node_retry_policy(
        self, node: NodeIR, ir: PipelineIR
    ) -> Optional[RetryPolicy]:
        """Effective executor retry policy (None = single attempt)."""
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

    def _run_nodes(
        self, *, store, ir, executors, result, runtime_parameters, contexts,
        extras, enable_cache, max_workers: int,
    ) -> None:
        """Ready-set scheduler: dispatch any node whose upstreams have all
        settled, lowest topo index first; executors run in a worker pool
        while the driver (and so execution-id/URI assignment) stays in this
        thread.  At most one "tpu" node is in flight at a time.  A failing
        node marks its descendants FAILED without cancelling in-flight or
        independent work."""
        publish_lock = threading.Lock()
        unprocessed = [n.id for n in ir.nodes]  # stays in topo order
        by_id = {n.id: n for n in ir.nodes}
        produced: Dict[str, Dict[str, List[Artifact]]] = {}
        failed: set = set()
        settled: set = set()
        in_flight: set = set()
        tpu_in_flight: Optional[str] = None
        done_q: "queue_mod.Queue" = queue_mod.Queue()

        def settle(nr: NodeResult) -> None:
            result.nodes[nr.node_id] = nr
            settled.add(nr.node_id)
            if nr.status in ("COMPLETE", "CACHED"):
                produced[nr.node_id] = nr.outputs
            else:
                failed.add(nr.node_id)

        def worker(plan: _LaunchPlan) -> None:
            try:
                nr = self._execute_and_publish(
                    store, plan, extras, publish_lock)
            except Exception:
                # Runner-internal failure: settle the node as FAILED instead
                # of deadlocking the scheduler on a completion that never
                # arrives.
                nr = NodeResult(
                    node_id=plan.node.id, status="FAILED",
                    error=traceback.format_exc(),
                )
            done_q.put(nr)

        with ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="tpp-node"
        ) as pool:
            while unprocessed or in_flight:
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
                    if any(u in failed for u in node.upstream):
                        settle(NodeResult(
                            node_id=nid, status="FAILED",
                            error="upstream failure"))
                        unprocessed.remove(nid)
                        progressed = True
                        continue
                    if len(in_flight) >= max_workers:
                        continue
                    if node.resource_class == "tpu" and tpu_in_flight:
                        continue  # the device is busy; host nodes may go
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
                        continue
                    in_flight.add(nid)
                    if node.resource_class == "tpu":
                        tpu_in_flight = nid
                    pool.submit(worker, prepared)
                if progressed:
                    continue
                if not in_flight:
                    raise RuntimeError(
                        f"scheduler stalled with pending nodes {unprocessed}"
                    )
                nr = done_q.get()
                in_flight.discard(nr.node_id)
                if tpu_in_flight == nr.node_id:
                    tpu_in_flight = None
                settle(nr)

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
        driver failure), else a _LaunchPlan."""
        t0 = time.time()
        node_ctx = Context("node", f"{ir.name}.{node.id}")
        with publish_lock:
            store.put_context(node_ctx)
        all_ctx = contexts + [node_ctx]

        try:
            inputs = self._resolve_inputs(node, produced)
        except KeyError as e:
            return NodeResult(
                node_id=node.id, status="FAILED",
                error=f"input resolution failed: {e}",
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
            return NodeResult(
                node_id=node.id,
                status="CACHED",
                execution_id=ex.id,
                outputs=cached,
                wall_clock_s=time.time() - t0,
            )

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
        outputs: Dict[str, List[Artifact]] = {}
        for key, type_name in node.outputs.items():
            uri = os.path.join(ir.pipeline_root, node.id, key, str(ex.id))
            outputs[key] = [Artifact(type_name=type_name, uri=uri)]
        return _LaunchPlan(
            node=node, component=component, inputs=inputs, props=props,
            external_fps=external_fps, execution=ex, outputs=outputs,
            all_ctx=all_ctx, t0=t0,
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
        retries), then fingerprint and publish under the publish lock."""
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
                            if os.path.isdir(a.uri):
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
                    extra_props = dict(executor(ctx) or {})
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
                    record_retry(f"node:{node.id}")
                    if delay > 0:
                        time.sleep(delay)
                    attempts += 1
                finally:
                    shutil.rmtree(tmp, ignore_errors=True)

        wall = time.time() - plan.t0
        ex.properties.update(extra_props)
        ex.properties.update(
            {"wall_clock_s": round(wall, 4), "retries": attempts - 1}
        )
        if error:
            ex.state = ExecutionState.FAILED
            ex.properties["error"] = error.splitlines()[-1]
            publish_err = self._publish(store, plan, publish_lock)
            if publish_err:
                error = f"{error}\n{publish_err}"
            return NodeResult(
                node_id=node.id, status="FAILED", execution_id=ex.id,
                error=error, wall_clock_s=wall, retries=attempts - 1,
            )
        for arts in outputs.values():
            for a in arts:
                a.fingerprint = (
                    plan.external_fps.get(os.path.abspath(a.uri))
                    or fingerprint_dir(a.uri)
                )
        ex.state = ExecutionState.COMPLETE
        publish_err = self._publish(store, plan, publish_lock)
        if publish_err is not None:
            return NodeResult(
                node_id=node.id, status="FAILED", execution_id=ex.id,
                error=publish_err, wall_clock_s=wall, retries=attempts - 1,
            )
        log.info(
            "node %s: COMPLETE in %.2fs (execution %d)", node.id, wall, ex.id
        )
        return NodeResult(
            node_id=node.id, status="COMPLETE", execution_id=ex.id,
            outputs=outputs, wall_clock_s=wall, retries=attempts - 1,
        )

    @staticmethod
    def _publish(
        store: MetadataStore, plan: _LaunchPlan, publish_lock: threading.Lock,
    ) -> Optional[str]:
        """Publish the plan's execution; an error string when the store is
        unavailable (the caller records a node failure), else None."""
        try:
            with publish_lock:
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
                    if key in node.optional_inputs:
                        continue
                    raise KeyError(
                        f"{node.id}: upstream {ref.producer} has no output "
                        f"{ref.output_key!r}"
                    )
                arts.extend(got)
            inputs[key] = arts
        return inputs
