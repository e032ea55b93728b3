"""Layer 1: TPP1xx graph rules over the compiled ``PipelineIR``.

The port's copy of ``tpu_pipelines/analysis/graph_rules.py``, over the
port's IR (the same fields, so both packages give the same findings for
the same pipeline).  TPP108 reads ``PipelineIR.spmd_sync``, which the
runner stamps under ``spmd_sync`` and ``lint --spmd-sync`` stamps by hand.

These run in milliseconds on the same IR every runner consumes, so the
CLI gate, the LocalDagRunner pre-flight, and the cluster runner's
pre-emit check all see exactly what would execute — not the DSL objects.
Each rule is a pure function ``(ir) -> [Finding]``; the registry at the
bottom is what ``analyze_ir`` iterates, and fixtures in
tests/test_torch_analysis.py pin one deliberately broken pipeline per rule
id, built in both packages' DSLs.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

from tpu_pipelines_torch.analysis.findings import ERROR, WARN, Finding
from tpu_pipelines_torch.dsl.compiler import PipelineIR, is_runtime_param
from tpu_pipelines_torch.utils.fingerprint import find_unjsonable

# The deadline watchdog publishes FAILED(timeout) only after the executor
# attempt actually started; a sub-second budget cannot cover even process
# startup + driver phase, so it is near-certainly a units mistake
# (minutes-as-seconds is the one we've seen; seconds-as-milliseconds is this
# one).
MIN_SANE_TIMEOUT_S = 1.0


def check_dead_end_nodes(ir: PipelineIR) -> List[Finding]:
    """TPP101: a node with outputs that nothing consumes and no declared
    side effect computes into the void — usually a wiring mistake (the
    author meant to feed it downstream) or dead weight on the critical
    path.  Sink components (Pusher, validators, BulkInferrer, Evaluator)
    declare ``IS_SINK`` and are exempt: their value IS the side effect /
    gate, not the artifact."""
    consumed: Set[Tuple[str, str]] = set()
    for node in ir.nodes:
        for refs in node.inputs.values():
            for ref in refs:
                if ref.producer:
                    consumed.add((ref.producer, ref.output_key))
    out = []
    for node in ir.nodes:
        if not node.outputs or getattr(node, "is_sink", False):
            continue
        if any((node.id, key) in consumed for key in node.outputs):
            continue
        out.append(Finding(
            rule="TPP101", severity=WARN, node_id=node.id,
            message=(
                f"outputs {sorted(node.outputs)} are not consumed by any "
                "node; the node burns schedule time for artifacts nothing "
                "reads"
            ),
            fix=(
                "wire an output into a downstream component, drop the "
                "node, or mark the component IS_SINK = True if its side "
                "effect is the point"
            ),
        ))
    return out


def check_deadline_sanity(ir: PipelineIR) -> List[Finding]:
    """TPP102: deadline values that contradict the docs/RECOVERY.md
    contract.  The deadline covers the node's WHOLE launcher phase — all
    retry attempts included — and expiry is terminal, so a malformed or
    sub-second budget does not fail fast, it fails *always*."""
    out = []
    default = float(getattr(ir, "default_node_timeout_s", 0.0) or 0.0)
    for node in ir.nodes:
        t = float(getattr(node, "execution_timeout_s", 0.0) or 0.0)
        if t < 0:
            out.append(Finding(
                rule="TPP102", severity=ERROR, node_id=node.id,
                message=f"execution_timeout_s={t} is negative",
                fix="use 0 for no deadline, a positive budget otherwise",
            ))
        elif 0 < t < MIN_SANE_TIMEOUT_S:
            out.append(Finding(
                rule="TPP102", severity=ERROR, node_id=node.id,
                message=(
                    f"execution_timeout_s={t} is sub-second; the deadline "
                    "covers every retry attempt, so this node can never "
                    "complete (likely a units mistake)"
                ),
                fix="deadlines are in seconds; budget the slowest attempt "
                    "times (1 + max_retries)",
            ))
        elif t > 0 and node.is_resolver:
            out.append(Finding(
                rule="TPP102", severity=WARN, node_id=node.id,
                message=(
                    "deadline set on a resolver node: resolvers answer "
                    "from the metadata store and never launch an executor, "
                    "so the watchdog has nothing to fence"
                ),
                fix="drop the execution_timeout_s on this node",
            ))
        elif t > 0 and default > 0 and t == default:
            out.append(Finding(
                rule="TPP102", severity=WARN, node_id=node.id,
                message=(
                    f"per-node deadline {t}s duplicates the pipeline "
                    f"default (node_timeout_s={default}); the override is "
                    "redundant and hides the single knob"
                ),
                fix="remove the per-node override and keep "
                    "Pipeline(node_timeout_s=...)",
            ))
    return out


def check_tpu_level_conflicts(ir: PipelineIR) -> List[Finding]:
    """TPP103: two+ tpu-class nodes in one topo level LOOK parallel to the
    scheduler but serialize on the chip mutex (at most one tpu executor
    holds the device) — the run trace measures exactly this as
    ``gate_wait`` on the second node.  The DAG shape promises concurrency
    the hardware contract will revoke; restructure or accept the wait."""
    out = []
    try:
        levels = ir.topo_levels()
    except KeyError:
        # Dangling upstream edge: the IR is structurally broken and
        # TPP106 reports the real problem; depth analysis is meaningless.
        return out
    for depth, level in enumerate(levels):
        tpu_nodes = sorted(
            nid for nid in level
            if getattr(ir.node(nid), "resource_class", "host") == "tpu"
        )
        if len(tpu_nodes) < 2:
            continue
        others = ", ".join(tpu_nodes[1:])
        for nid in tpu_nodes:
            out.append(Finding(
                rule="TPP103", severity=WARN, node_id=nid,
                message=(
                    f"topo level {depth} holds {len(tpu_nodes)} tpu-class "
                    f"nodes ({', '.join(tpu_nodes)}); with "
                    "max_parallel_nodes>1 they serialize on the chip mutex "
                    "and the extras accrue measured gate-wait (RunTrace "
                    "gate_wait_s)"
                ),
                fix=(
                    "chain them explicitly, move one off the chip "
                    "(resource_class='host'), or suppress if the wait is "
                    "accepted"
                ),
            ))
    return out


def check_cache_unsafe_properties(ir: PipelineIR) -> List[Finding]:
    """TPP104: exec-property values outside the JSON-native set feed the
    execution cache key through a repr fallback.  A repr embedding a
    memory address (`<obj at 0x7f..>`) changes every process, so the node
    NEVER cache-hits — or worse, two different configs collide once the
    address is scrubbed.  ERROR for address-bearing values, WARN for any
    other non-JSON-native value (deterministically encoded today, but the
    encoding sees only ``str(value)``, not the value's real state)."""
    out = []
    for node in ir.nodes:
        for path, value, has_addr in find_unjsonable(node.exec_properties):
            where = f"exec_properties[{path}]"
            if has_addr:
                out.append(Finding(
                    rule="TPP104", severity=ERROR, node_id=node.id,
                    message=(
                        f"{where} = {type(value).__name__!r} encodes with "
                        "a memory address; the execution cache key is "
                        "nondeterministic across processes"
                    ),
                    fix=(
                        "pass JSON-native values (str/int/float/bool/"
                        "list/dict) or give the object a deterministic "
                        "__repr__ without the address"
                    ),
                ))
            else:
                out.append(Finding(
                    rule="TPP104", severity=WARN, node_id=node.id,
                    message=(
                        f"{where} = {type(value).__name__!r} is not "
                        "JSON-native; the cache key sees only str(value), "
                        "so state changes invisible to str() cannot "
                        "invalidate cached executions"
                    ),
                    fix="pass JSON-native values or encode the state "
                        "explicitly (e.g. dataclasses.asdict)",
                ))
    return out


def check_unresolved_runtime_parameters(ir: PipelineIR) -> List[Finding]:
    """TPP105: a RuntimeParameter placeholder with no default resolves to
    None unless `run(runtime_parameters={...})` supplies it — a latent
    TypeError minutes into the run instead of a lint line now."""
    out = []
    for node in ir.nodes:
        for key, value in _walk_props(node.exec_properties):
            if is_runtime_param(value) and value.get("default") is None:
                name = value["__runtime_parameter__"]
                out.append(Finding(
                    rule="TPP105", severity=WARN, node_id=node.id,
                    message=(
                        f"exec_properties[{key}] is "
                        f"RuntimeParameter({name!r}) with no default; the "
                        "executor sees None unless every run supplies it"
                    ),
                    fix=f"give {name!r} a default, or document/enforce "
                        "the runtime_parameters contract in CI",
                ))
    return out


def check_missing_producers(ir: PipelineIR) -> List[Finding]:
    """TPP106: an input ref naming a producer that is not in the node set
    can never resolve — typically a component consumed a channel from an
    object that was never added to (or was removed from) the pipeline."""
    ids = {n.id for n in ir.nodes}
    out = []
    for node in ir.nodes:
        for key, refs in node.inputs.items():
            for ref in refs:
                if ref.producer and ref.producer not in ids:
                    out.append(Finding(
                        rule="TPP106", severity=ERROR, node_id=node.id,
                        message=(
                            f"input {key!r} references producer "
                            f"{ref.producer!r} which is not in the "
                            "pipeline"
                        ),
                        fix="add the producer component to the pipeline "
                            "or rewire the input",
                    ))
        for up in node.upstream:
            if up not in ids:
                out.append(Finding(
                    rule="TPP106", severity=ERROR, node_id=node.id,
                    message=f"upstream {up!r} is not in the pipeline",
                    fix="add the missing component or drop the edge",
                ))
    return out


def check_duplicate_node_ids(ir: PipelineIR) -> List[Finding]:
    """TPP107: duplicate node ids alias each other's artifacts, cache
    entries, and metadata rows.  The Pipeline constructor refuses this at
    authoring time; the rule catches hand-built or post-processed IR."""
    seen: Dict[str, int] = {}
    for node in ir.nodes:
        seen[node.id] = seen.get(node.id, 0) + 1
    return [
        Finding(
            rule="TPP107", severity=ERROR, node_id=nid,
            message=f"node id {nid!r} appears {n} times in the IR",
            fix="use .with_id()/instance_name= to disambiguate",
        )
        for nid, n in sorted(seen.items()) if n > 1
    ]


def check_retry_policy_under_spmd(ir: PipelineIR) -> List[Finding]:
    """TPP108: an in-runner retry policy on an ``spmd_sync`` pipeline.

    The spmd runner refuses in-runner retries at runtime (ValueError in
    ``LocalDagRunner``): a fast-failing process would wipe the shared
    output dirs and re-enter the executor while its peers are still
    inside the previous attempt's collectives.  ``PipelineIR.spmd_sync``
    is stamped by context-aware callers (``lint --spmd-sync``, the
    multi-host ``run_node`` pre-flight) — distribution degree lives in
    runner configs, so the DSL alone cannot author this state.
    """
    if not getattr(ir, "spmd_sync", False):
        return []
    from tpu_pipelines_torch.robustness import RetryPolicy

    default = RetryPolicy.from_json(
        getattr(ir, "default_retry_policy", None)
    )
    out = []
    for node in ir.nodes:
        policy = RetryPolicy.from_json(
            getattr(node, "retry_policy", None)
        ) or default
        if policy is None or policy.max_attempts <= 1 or node.is_resolver:
            continue
        out.append(Finding(
            rule="TPP108", severity=ERROR, node_id=node.id,
            message=(
                f"retry policy (max_attempts={policy.max_attempts}) on an "
                "spmd_sync pipeline: in-runner retries would wipe shared "
                "output dirs while peer processes are mid-attempt, and the "
                "runner refuses them at runtime"
            ),
            fix=(
                "drop the in-runner policy for multi-host nodes and rely "
                "on the substrate retry the cluster runner compiles from "
                "it (Argo retryStrategy / JobSet failurePolicy "
                "maxRestarts)"
            ),
        ))
    return out


def check_pusher_without_infra_validator(ir: PipelineIR) -> List[Finding]:
    """TPP109: a push-to-serving node (outputs a ``PushedModel``) with no
    InfraValidator feeding it.  The Evaluator blesses model QUALITY; only
    the InfraValidator canary proves the exported payload actually LOADS
    and answers the serving request shape — and the serving fleet's
    hot-swap gate replays that same canary check (docs/SERVING.md), so a
    pipeline without one pushes versions whose first smoke test happens
    in production.  Detected structurally: none of the node's inputs
    resolves to a producer output of type ``InfraBlessing``."""
    out = []
    producers = {n.id: n for n in ir.nodes}
    for node in ir.nodes:
        if "PushedModel" not in node.outputs.values():
            continue
        gated = any(
            producers.get(ref.producer) is not None
            and producers[ref.producer].outputs.get(ref.output_key)
            == "InfraBlessing"
            for refs in node.inputs.values()
            for ref in refs
        )
        if gated:
            continue
        out.append(Finding(
            rule="TPP109", severity=WARN, node_id=node.id,
            message=(
                "pushes a model to serving with no InfraValidator "
                "upstream: nothing canary-loads the exported payload "
                "before it lands in the live version directory"
            ),
            fix=(
                "add an InfraValidator over the same model/examples and "
                "wire its blessing into the pusher "
                "(infra_blessing=infra.outputs['blessing']), or suppress "
                "if an external canary gates the push"
            ),
        ))
    return out


_SLO_DECL_KEYS = ("slo_p99_ms", "slo_p99_s", "slo_ms_per_token")
_SLO_MONITOR_KEYS = (
    "slo_monitor", "slo_monitor_interval_s", "metrics_registry",
    "registry", "metrics_port", "monitor",
)


def check_slo_without_monitor(ir: PipelineIR) -> List[Finding]:
    """TPP110: a serving config in the exec-property tree declares an SLO
    target (``slo_p99_ms``/``slo_p99_s``/``slo_ms_per_token`` > 0) but
    wires no observability next to it.  The target silently shapes the
    batch gather window (serving/batching.py) — real behavior changes —
    yet nothing evaluates burn rates against it, so a blown SLO neither
    alerts nor triggers the fleet's post-swap auto-rollback
    (``ServingFleet.on_slo_breach``): an SLO declared yet unobservable.
    Detected structurally on dict literals carried as exec properties
    (serving configs a Pusher/InfraValidator/custom deploy component
    forwards); a monitor key in the SAME mapping is the wiring."""
    out = []
    for node in ir.nodes:
        for path, value in _walk_dicts(node.exec_properties):
            declared = None
            for key in _SLO_DECL_KEYS:
                v = value.get(key)
                if isinstance(v, (int, float)) and not isinstance(
                    v, bool
                ) and v > 0:
                    declared = key
                    break
            if declared is None:
                continue
            if any(k in value for k in _SLO_MONITOR_KEYS):
                continue
            where = f"exec_properties[{path}]" if path else "exec_properties"
            out.append(Finding(
                rule="TPP110", severity=WARN, node_id=node.id,
                message=(
                    f"{where} declares {declared}="
                    f"{value[declared]!r} with no metrics registry or "
                    "SLO monitor in the same config: the target drives "
                    "the batch window but nothing watches burn rates or "
                    "arms the post-swap auto-rollback"
                ),
                fix=(
                    "wire the monitor next to the target (e.g. "
                    "slo_monitor_interval_s=5 / env TPP_SLO_MONITOR, or "
                    "metrics_registry=...) so SLOMonitor evaluates burn "
                    "rates and ServingFleet.on_slo_breach can fire "
                    "(docs/OBSERVABILITY.md), or suppress if an external "
                    "system scrapes and alerts"
                ),
            ))
    return out


def check_unbounded_continuous_nodes(ir: PipelineIR) -> List[Finding]:
    """TPP111: a pipeline handed to the continuous controller whose node
    carries NO execution deadline and NO retry policy.  The controller is
    an always-on loop: a batch run that hangs costs one operator page,
    but an unbounded incremental run wedges the loop — no new span is
    ingested, no model retrained, no deploy happens, silently, forever.
    A deadline (node ``execution_timeout_s`` or the pipeline default)
    bounds the hang; a retry policy (node or pipeline default) bounds
    the flake; either suffices.  Armed only when the IR is stamped
    continuous (``lint --continuous`` / the controller's own pre-flight)
    — ordinary batch pipelines are exempt.  Resolver nodes answer from
    the store in the driver and are exempt too."""
    if not getattr(ir, "continuous", False):
        return []
    out = []
    default_deadline = bool(
        ir.default_node_timeout_s and ir.default_node_timeout_s > 0
    )
    default_retry = bool(getattr(ir, "default_retry_policy", None))
    for node in ir.nodes:
        if node.is_resolver:
            continue
        bounded = (
            default_deadline
            or default_retry
            or (node.execution_timeout_s and node.execution_timeout_s > 0)
            or getattr(node, "retry_policy", None)
        )
        if bounded:
            continue
        out.append(Finding(
            rule="TPP111", severity=WARN, node_id=node.id,
            message=(
                "runs under the continuous controller with no "
                "execution_timeout_s and no retry policy: one hung or "
                "flaky execution wedges the always-on loop (no new span "
                "ingests, no retrain, no deploy) with nothing to bound it"
            ),
            fix=(
                "bound the node: .with_execution_timeout(seconds) or "
                "Pipeline(node_timeout_s=...) for hangs, "
                ".with_retry_policy(...) or Pipeline(retry_policy=...) "
                "for flakes (docs/RECOVERY.md precedence), or suppress "
                "if an external supervisor bounds the run"
            ),
        ))
    return out


def check_pusher_bypasses_rewriter(ir: PipelineIR) -> List[Finding]:
    """TPP112: a push-to-serving node (outputs a ``PushedModel``) whose
    Model input comes straight from a non-Rewriter producer while a
    Rewriter-shaped node (Model in -> Model out) exists in the same
    pipeline.  The Rewriter's whole value — quantized variants, the
    quality gate, AOT-warmed executables — rides on its OUTPUT being
    what ships; wiring the Pusher to the Trainer's raw model next to a
    Rewriter almost always means the float payload reaches serving and
    the optimized one computes into the void."""
    producers = {n.id: n for n in ir.nodes}
    # Rewriter-shaped: a Model flows in through the canonical "model"
    # input key AND a Model flows out.  The key matters: a warm-start
    # Trainer consumes its baseline via "base_model" and must not count
    # (it produces a NEW model; nothing is bypassed by pushing it).
    rewriter_ids = sorted(
        n.id for n in ir.nodes
        if "Model" in n.outputs.values() and any(
            producers.get(ref.producer) is not None
            and producers[ref.producer].outputs.get(ref.output_key)
            == "Model"
            for ref in n.inputs.get("model", ())
        )
    )
    if not rewriter_ids:
        return []
    out = []
    for node in ir.nodes:
        if "PushedModel" not in node.outputs.values():
            continue
        for key, refs in node.inputs.items():
            for ref in refs:
                producer = producers.get(ref.producer)
                if producer is None:
                    continue
                if producer.outputs.get(ref.output_key) != "Model":
                    continue
                if ref.producer in rewriter_ids:
                    continue
                out.append(Finding(
                    rule="TPP112", severity=WARN, node_id=node.id,
                    message=(
                        f"input {key!r} consumes the Model from "
                        f"{ref.producer!r} directly while rewriter "
                        f"node(s) {rewriter_ids} exist in this pipeline "
                        "— the optimized variant is bypassed and the "
                        "unoptimized payload is what ships"
                    ),
                    fix=(
                        "wire the pusher to the rewriter's output "
                        "(model=rewriter.outputs['model'], optionally "
                        "variant='aqt_int8'), or suppress if pushing "
                        "the raw model is intentional"
                    ),
                ))
    return out


def _walk_dicts(obj, prefix=""):
    """Yield (path, dict) over every mapping in a nested exec-property
    tree (the dict itself first, then its children)."""
    if isinstance(obj, dict):
        yield prefix, obj
        for k, v in obj.items():
            yield from _walk_dicts(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _walk_dicts(v, f"{prefix}[{i}]")


def _walk_props(obj, prefix=""):
    """Yield (path, value) over nested dict/list exec-property trees."""
    if isinstance(obj, dict):
        if is_runtime_param(obj):
            yield prefix or "<root>", obj
            return
        for k, v in obj.items():
            yield from _walk_props(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _walk_props(v, f"{prefix}[{i}]")
    else:
        yield prefix or "<root>", obj


# Registry consumed by analyze_ir, in stable catalog order.
GRAPH_RULES = (
    check_dead_end_nodes,
    check_deadline_sanity,
    check_tpu_level_conflicts,
    check_cache_unsafe_properties,
    check_unresolved_runtime_parameters,
    check_missing_producers,
    check_duplicate_node_ids,
    check_retry_policy_under_spmd,
    check_pusher_without_infra_validator,
    check_slo_without_monitor,
    check_unbounded_continuous_nodes,
    check_pusher_bypasses_rewriter,
)
