"""Compiler: DSL Pipeline → JSON-serializable IR.

Equivalent of TFX's DSL→pipeline-IR-proto compile step (SURVEY.md §1 L3).
The IR is what runners consume: the local runner walks it in-process; the
cluster runner renders one pod spec per IR node.  Golden-IR tests pin the
format (SURVEY.md §4 "Compiler/IR tests").
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, List, Optional

from tpu_pipelines_torch.dsl.component import Component, RuntimeParameter
from tpu_pipelines_torch.dsl.pipeline import Pipeline
from tpu_pipelines_torch.utils.fingerprint import canonical_json, fingerprint_callable

IR_SCHEMA_VERSION = "tpu-pipelines-ir/v1"

_RUNTIME_PARAM_KEY = "__runtime_parameter__"


def encode_property(value: Any) -> Any:
    if isinstance(value, RuntimeParameter):
        return {_RUNTIME_PARAM_KEY: value.name, "default": value.default}
    return value


def is_runtime_param(value: Any) -> bool:
    return isinstance(value, dict) and _RUNTIME_PARAM_KEY in value


def resolve_property(value: Any, runtime_parameters: Dict[str, Any]) -> Any:
    if is_runtime_param(value):
        name = value[_RUNTIME_PARAM_KEY]
        return runtime_parameters.get(name, value.get("default"))
    return value


@dataclasses.dataclass
class InputRef:
    producer: str       # producing node id; "" for external inputs
    output_key: str
    type_name: str

    def to_json(self) -> Dict[str, str]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class NodeIR:
    id: str
    component_type: str
    inputs: Dict[str, List[InputRef]]
    outputs: Dict[str, str]                 # key -> artifact type
    exec_properties: Dict[str, Any]
    executor_version: str
    upstream: List[str]
    # Exec-property keys holding external data paths; the driver fingerprints
    # their content into the cache key (stale-cache guard for ingestion).
    external_input_parameters: List[str] = dataclasses.field(default_factory=list)
    # Input keys allowed to resolve empty (downstream executor sees the key
    # absent) — how a Resolver that found nothing feeds an optional input.
    optional_inputs: List[str] = dataclasses.field(default_factory=list)
    # Driver-level node (TFX Resolver equivalent): the runner resolves its
    # outputs from the metadata store instead of launching an executor, and
    # never caches it (its answer changes as runs accumulate).
    is_resolver: bool = False
    # Serialized Cond predicates (dsl/cond.py); ALL must hold or the runner
    # marks the node COND_SKIPPED and cascades to its consumers.
    conditions: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    # Scheduler resource class ("host" | "tpu", the reference's spelling;
    # "tpu" = holds the accelerator): the local runner admits at most one
    # "tpu" node at a time.
    resource_class: str = "host"
    # Per-node execution deadline in seconds (0 = fall back to the pipeline
    # default, then env TPP_NODE_TIMEOUT_S).  Local runner: scheduler
    # watchdog; cluster runner: activeDeadlineSeconds.
    execution_timeout_s: float = 0.0
    # Declared side effect (Component.IS_SINK): exempts the node from the
    # TPP101 dead-end analyzer rule — its unconsumed outputs are expected.
    is_sink: bool = False
    # Analyzer rule ids suppressed for this node (Component.LINT_SUPPRESS /
    # .with_lint_suppressions()); tpu_pipelines/analysis drops matching
    # findings.  Operational metadata: excluded from the DAG fingerprint.
    lint_suppress: List[str] = dataclasses.field(default_factory=list)
    # Per-node retry policy in RetryPolicy.to_json() form (None = fall back
    # to PipelineIR.default_retry_policy, then env TPP_RETRY_*).  Local
    # runner: classified backoff retries in the launcher loop; cluster
    # runner: Argo retryStrategy / JobSet restarts.  Operational metadata,
    # excluded from the DAG fingerprint like deadlines.
    retry_policy: Optional[Dict[str, Any]] = None

    def to_json(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "component_type": self.component_type,
            "inputs": {
                k: [r.to_json() for r in refs] for k, refs in self.inputs.items()
            },
            "outputs": dict(self.outputs),
            "exec_properties": self.exec_properties,
            "executor_version": self.executor_version,
            "upstream": list(self.upstream),
            "external_input_parameters": list(self.external_input_parameters),
            "optional_inputs": list(self.optional_inputs),
            "is_resolver": self.is_resolver,
            "conditions": list(self.conditions),
            "resource_class": self.resource_class,
            "execution_timeout_s": self.execution_timeout_s,
            "is_sink": self.is_sink,
            "lint_suppress": list(self.lint_suppress),
            "retry_policy": (
                dict(self.retry_policy) if self.retry_policy else None
            ),
        }


@dataclasses.dataclass
class PipelineIR:
    name: str
    pipeline_root: str
    metadata_path: str
    enable_cache: bool
    nodes: List[NodeIR]
    schema_version: str = IR_SCHEMA_VERSION
    # Pipeline-wide default node deadline (0 = none); a node's own
    # execution_timeout_s takes precedence.
    default_node_timeout_s: float = 0.0
    # Pipeline-wide default retry policy (RetryPolicy.to_json() form, None
    # = none); a node's own retry_policy takes precedence.  Operational —
    # excluded from fingerprint().
    default_retry_policy: Optional[Dict[str, Any]] = None
    # Execution-context flag, set by callers that KNOW this IR will run
    # under the spmd_sync runner (multi-host run_node, `lint --spmd-sync`).
    # Not compiled from the DSL (distribution degree lives in the runner
    # config) and excluded from fingerprint(); the TPP108 analyzer rule
    # reads it to catch in-runner retry policies that the spmd runner
    # would refuse at runtime.
    spmd_sync: bool = False
    # Execution-context flag like spmd_sync, set by callers that KNOW this
    # IR will be driven by the continuous controller (`lint --continuous`,
    # ContinuousController's own pre-flight).  Excluded from fingerprint();
    # the TPP111 analyzer rule reads it: a node with neither a deadline
    # nor a retry policy can wedge the always-on loop forever.
    continuous: bool = False

    def to_json(self) -> Dict[str, Any]:
        return {
            "schema_version": self.schema_version,
            "name": self.name,
            "pipeline_root": self.pipeline_root,
            "metadata_path": self.metadata_path,
            "enable_cache": self.enable_cache,
            "default_node_timeout_s": self.default_node_timeout_s,
            "default_retry_policy": (
                dict(self.default_retry_policy)
                if self.default_retry_policy else None
            ),
            "spmd_sync": self.spmd_sync,
            "continuous": self.continuous,
            "nodes": [n.to_json() for n in self.nodes],
        }

    def fingerprint(self) -> str:
        """Structural DAG fingerprint, recorded per run and checked by
        ``resume_from``: a resume against a run whose compiled graph differs
        (nodes, wiring, exec-properties, executor code) must be refused —
        adopted outputs would no longer be what the current DAG produces.
        Deliberately EXCLUDES relocatable/operational fields (pipeline_root,
        metadata_path, enable_cache, resource_class, timeouts, lint
        metadata): moving the home or retuning deadlines does not change
        what a node computes.  Nodes are serialized SORTED BY ID, not in
        list order, so reordering component declarations — which permutes
        same-level siblings in the topo order — cannot change the
        fingerprint of a structurally identical DAG.
        """
        structural = [
            {
                "id": n.id,
                "component_type": n.component_type,
                "inputs": {
                    k: [r.to_json() for r in refs]
                    for k, refs in n.inputs.items()
                },
                "outputs": dict(n.outputs),
                "exec_properties": n.exec_properties,
                "executor_version": n.executor_version,
                "upstream": list(n.upstream),
                "external_input_parameters": list(
                    n.external_input_parameters
                ),
                "optional_inputs": list(n.optional_inputs),
                "is_resolver": n.is_resolver,
                "conditions": list(n.conditions),
            }
            for n in sorted(self.nodes, key=lambda n: n.id)
        ]
        # canonical_json, not default=str: an exec property whose repr
        # embeds a memory address must not make the DAG fingerprint (and
        # with it resume_from) nondeterministic across processes.
        payload = canonical_json(
            {"schema": self.schema_version, "name": self.name,
             "nodes": structural},
        )
        return hashlib.sha256(payload.encode()).hexdigest()

    def to_json_str(self, indent: int = 2) -> str:
        return json.dumps(self.to_json(), indent=indent, sort_keys=True, default=str)

    def node(self, node_id: str) -> NodeIR:
        for n in self.nodes:
            if n.id == node_id:
                return n
        raise KeyError(node_id)

    def topo_levels(self) -> List[List[str]]:
        """Topological stage groups: level 0 holds the DAG roots, level k the
        nodes whose deepest upstream sits at level k-1.  Nodes within one
        level share no data dependency, so a scheduler may run a whole level
        concurrently — the local runner's ready-set scheduling realizes the
        same parallelism dynamically; the cluster runner records the groups
        as a workflow annotation.  Ids within a level are SORTED so the
        groups (like the fingerprint) are invariant under component-
        declaration reordering — siblings share no dependency, so order
        inside a group carries no scheduling meaning."""
        level: Dict[str, int] = {}
        for n in self.nodes:  # self.nodes is topologically ordered
            level[n.id] = 1 + max(
                (level[u] for u in n.upstream), default=-1
            )
        groups: List[List[str]] = []
        for n in self.nodes:
            depth = level[n.id]
            while len(groups) <= depth:
                groups.append([])
            groups[depth].append(n.id)
        return [sorted(g) for g in groups]

    def n_roots(self) -> int:
        """Number of DAG roots — the concurrent runner's default pool size."""
        return sum(1 for n in self.nodes if not n.upstream)


class Compiler:
    def compile(self, pipeline: Pipeline) -> PipelineIR:
        nodes: List[NodeIR] = []
        for comp in pipeline.components:
            inputs: Dict[str, List[InputRef]] = {}
            upstream: List[str] = []
            for key, chans in comp.input_channels.items():
                refs = []
                for ch in chans:
                    producer_id = ch.producer.id if ch.producer else ""
                    refs.append(
                        InputRef(
                            producer=producer_id,
                            output_key=ch.output_key,
                            type_name=ch.type_name,
                        )
                    )
                    if producer_id and producer_id not in upstream:
                        upstream.append(producer_id)
                inputs[key] = refs
            conditions = []
            for pred in getattr(comp, "conditions", ()):
                conditions.append(pred.to_json())
                ch = getattr(pred, "channel", None)
                if ch is not None and ch.producer is not None:
                    pid = ch.producer.id
                    if pid not in upstream:
                        upstream.append(pid)
            executor_version = self._executor_version(comp)
            nodes.append(
                NodeIR(
                    id=comp.id,
                    component_type=type(comp).__name__,
                    inputs=inputs,
                    outputs=dict(comp.SPEC.outputs),
                    exec_properties={
                        k: encode_property(v)
                        for k, v in sorted(comp.exec_properties.items())
                    },
                    executor_version=executor_version,
                    upstream=upstream,
                    external_input_parameters=sorted(
                        comp.EXTERNAL_INPUT_PARAMETERS
                    ),
                    optional_inputs=sorted(comp.SPEC.optional_inputs),
                    is_resolver=bool(getattr(comp, "IS_RESOLVER", False)),
                    conditions=conditions,
                    resource_class=getattr(comp, "RESOURCE_CLASS", "host"),
                    execution_timeout_s=float(
                        getattr(comp, "execution_timeout_s", 0.0) or 0.0
                    ),
                    is_sink=bool(getattr(comp, "IS_SINK", False)),
                    lint_suppress=sorted(
                        getattr(comp, "lint_suppress", ()) or ()
                    ),
                    retry_policy=(
                        comp.retry_policy.to_json()
                        if getattr(comp, "retry_policy", None) is not None
                        else None
                    ),
                )
            )
        return PipelineIR(
            name=pipeline.name,
            pipeline_root=pipeline.pipeline_root,
            metadata_path=pipeline.metadata_path,
            enable_cache=pipeline.enable_cache,
            nodes=nodes,
            default_node_timeout_s=float(
                getattr(pipeline, "node_timeout_s", 0.0) or 0.0
            ),
            default_retry_policy=(
                pipeline.retry_policy.to_json()
                if getattr(pipeline, "retry_policy", None) is not None
                else None
            ),
        )

    @staticmethod
    def _executor_version(comp: Component) -> str:
        if comp.EXECUTOR is None:
            return "no-executor"
        base = fingerprint_callable(comp.EXECUTOR)
        salt = comp.CACHE_SALT
        return f"{base}:{salt}" if salt else base
