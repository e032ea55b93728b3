"""Resolver: driver-level artifact resolution across prior runs.

The port's copy of ``tpu_pipelines/components/resolver.py`` (TFX's
``tfx.dsl.Resolver`` with ``LatestBlessedModelStrategy`` /
``LatestArtifactStrategy``).  A Resolver node runs in the runner's driver
against the metadata store — no executor, never cached (its answer changes
as runs accumulate) — and re-emits existing artifacts: downstream consumers
see the same artifact ids, so lineage records reuse, not copies.

Canonical continuous-training wiring::

    baseline = Resolver(strategy="latest_blessed_model")
    evaluator = Evaluator(
        examples=..., model=trainer.outputs["model"],
        baseline_model=baseline.outputs["model"],
        change_thresholds={"accuracy": {"min_improvement": 0.0}},
    )

Run 1: no blessed model exists, the resolver yields nothing, and Evaluator
(whose ``baseline_model`` is optional) gates on value thresholds only.
Run N: the newest blessed model from any prior run becomes the baseline, so
change thresholds gate against production.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from tpu_pipelines_torch.dsl.component import Component, ComponentSpec, Parameter
from tpu_pipelines_torch.metadata.store import MetadataStore
from tpu_pipelines_torch.metadata.types import Artifact, ArtifactState, EventType

STRATEGY_LATEST_BLESSED = "latest_blessed_model"
STRATEGY_LATEST = "latest_created"
STRATEGY_ROLLING_WINDOW = "rolling_window"

STRATEGIES = (
    STRATEGY_LATEST_BLESSED, STRATEGY_LATEST, STRATEGY_ROLLING_WINDOW,
)


class Resolver(Component):
    """Driver-level node resolving a Model artifact from prior runs."""

    SPEC = ComponentSpec(
        inputs={},
        outputs={"model": "Model"},
        parameters={
            # latest_blessed_model: newest Model that has a blessed=True
            #   ModelBlessing produced by an execution that consumed it.
            # latest_created: newest LIVE Model regardless of blessing
            #   (TFX LatestArtifactStrategy — warm-start wiring).
            "strategy": Parameter(type=str, default=STRATEGY_LATEST_BLESSED),
            # Restrict to artifacts attributed to THIS pipeline's context;
            # False searches every pipeline sharing the metadata store.
            "within_pipeline": Parameter(type=bool, default=True),
        },
    )
    EXECUTOR = None
    IS_RESOLVER = True


class RollingWindowResolver(Component):
    """Rolling last-K-spans window over per-span artifacts.

    The continuous-training resolver (TFX's RollingRange/SpanRangeStrategy
    analog): selects the newest delivery of each of the last ``window_spans``
    spans — Examples and their matching per-span ExampleStatistics — plus
    the latest blessed baseline Model, so Trainer/Evaluator retrain over a
    sliding window instead of all history.  Artifacts are matched by their
    ``span``/``version`` properties (stamped by ExampleGen and propagated
    by StatisticsGen/Transform); a re-delivered span (higher ``version``,
    or simply a newer artifact for the same span) replaces the old delivery
    in the window.

    Outputs are span-ascending (oldest -> newest), so a downstream
    ``SpanWindow`` union and a cold full run over the same data fold in
    the identical order.  ``source_pipeline`` scopes the span artifacts to
    the per-span ingest pipeline's context (the continuous controller runs
    ingest and training as separate pipelines against one shared store);
    the baseline model is always resolved within THIS pipeline's context.
    """

    SPEC = ComponentSpec(
        inputs={},
        outputs={
            "examples": "Examples",
            "statistics": "ExampleStatistics",
            "model": "Model",
        },
        parameters={
            "strategy": Parameter(type=str, default=STRATEGY_ROLLING_WINDOW),
            # How many trailing spans the window covers (K).
            "window_spans": Parameter(type=int, default=3),
            # Node ids (in the source pipeline) whose outputs are the
            # span artifacts; "" accepts any producer.  Distinguishes raw
            # from transformed Examples when both carry span properties.
            "examples_producer": Parameter(type=str, default=""),
            "statistics_producer": Parameter(type=str, default=""),
            # Pipeline context the span artifacts live in ("" = no scope:
            # any pipeline sharing the store).
            "source_pipeline": Parameter(type=str, default=""),
            "within_pipeline": Parameter(type=bool, default=False),
        },
    )
    EXECUTOR = None
    IS_RESOLVER = True


def resolve_artifacts(
    store: MetadataStore,
    *,
    strategy: str,
    pipeline_name: str,
    within_pipeline: bool = True,
    extra: Optional[Dict] = None,
) -> Dict[str, List[Artifact]]:
    """Run a resolver strategy against the store; returns the node's
    output dict ({"model": [...]} for the model strategies, the full
    window mapping for ``rolling_window``) — the runner publishes this
    as the node's outputs.  ``extra`` carries strategy-specific exec
    properties (window size, producer filters) verbatim."""
    if strategy not in STRATEGIES:
        raise ValueError(
            f"unknown resolver strategy {strategy!r}; expected one of "
            f"{STRATEGIES}"
        )
    if strategy == STRATEGY_ROLLING_WINDOW:
        return _resolve_rolling_window(
            store, pipeline_name=pipeline_name,
            within_pipeline=within_pipeline, extra=dict(extra or {}),
        )
    scope: Optional[set] = None
    if within_pipeline:
        ctx = store.get_context("pipeline", pipeline_name)
        if ctx is None:
            return {"model": []}
        scope = {a.id for a in store.get_artifacts_by_context(ctx.id)}

    if strategy == STRATEGY_LATEST:
        models = [
            a for a in store.get_artifacts(
                type_name="Model", state=ArtifactState.LIVE
            )
            if scope is None or a.id in scope
        ]
        models.sort(key=lambda a: a.id, reverse=True)
        return {"model": models[:1]}

    # latest_blessed_model: walk from blessing artifacts (newest first) to
    # the Model the blessing execution consumed at input path "model".
    blessings = [
        b for b in store.get_artifacts(
            type_name="ModelBlessing", state=ArtifactState.LIVE
        )
        if b.properties.get("blessed") and (scope is None or b.id in scope)
    ]
    blessings.sort(key=lambda a: a.id, reverse=True)
    for blessing in blessings:
        producer_ids = [
            ev.execution_id
            for ev in store.get_events_by_artifact(blessing.id)
            if ev.type == EventType.OUTPUT
        ]
        for ex_id in producer_ids:
            for ev in store.get_events_by_execution(ex_id):
                if ev.type != EventType.INPUT or ev.path != "model":
                    continue
                model = store.get_artifact(ev.artifact_id)
                if model is not None and model.state == ArtifactState.LIVE:
                    return {"model": [model]}
    return {"model": []}


def _producer_node_id(store: MetadataStore, artifact_id: int) -> str:
    """Node id of the execution that OUTPUT this artifact ("" if unknown)."""
    for ev in store.get_events_by_artifact(artifact_id):
        if ev.type != EventType.OUTPUT:
            continue
        ex = store.get_execution(ev.execution_id)
        if ex is not None:
            return ex.node_id
    return ""


def _latest_per_span(
    store: MetadataStore,
    type_name: str,
    producer: str,
    scope: Optional[set],
) -> Dict[int, Artifact]:
    """Newest LIVE artifact per ``span`` property.  Re-delivery ordering:
    the highest ``version`` property wins (an out-of-order re-delivery of
    version 2 after version 3 must NOT displace 3); artifact id — publish
    order — breaks ties and orders unversioned layouts."""
    by_span: Dict[int, Artifact] = {}

    def rank(a: Artifact):
        v = a.properties.get("version")
        return (v if isinstance(v, int) else -1, a.id)

    for art in store.get_artifacts(
        type_name=type_name, state=ArtifactState.LIVE
    ):
        span = art.properties.get("span")
        if not isinstance(span, int):
            continue
        if scope is not None and art.id not in scope:
            continue
        if producer and _producer_node_id(store, art.id) != producer:
            continue
        cur = by_span.get(span)
        if cur is None or rank(art) > rank(cur):
            by_span[span] = art
    return by_span


def _resolve_rolling_window(
    store: MetadataStore,
    *,
    pipeline_name: str,
    within_pipeline: bool,
    extra: Dict,
) -> Dict[str, List[Artifact]]:
    """The ``rolling_window`` strategy (RollingWindowResolver docstring):
    last-K spans' Examples + matching per-span statistics, span-ascending,
    plus the latest blessed Model from THIS pipeline as baseline."""
    window = max(1, int(extra.get("window_spans") or 3))
    source = str(extra.get("source_pipeline") or "")
    scope: Optional[set] = None
    if source:
        ctx = store.get_context("pipeline", source)
        if ctx is None:
            # Source pipeline has published nothing yet: empty window.
            scope = set()
        else:
            scope = {a.id for a in store.get_artifacts_by_context(ctx.id)}
    elif within_pipeline:
        ctx = store.get_context("pipeline", pipeline_name)
        scope = (
            set() if ctx is None
            else {a.id for a in store.get_artifacts_by_context(ctx.id)}
        )
    examples = _latest_per_span(
        store, "Examples", str(extra.get("examples_producer") or ""), scope
    )
    stats = _latest_per_span(
        store, "ExampleStatistics",
        str(extra.get("statistics_producer") or ""), scope,
    )
    spans = sorted(examples)[-window:]
    # Baseline: the newest blessed model of the TRAINING pipeline (the
    # one this resolver node runs in), the LatestBlessedModelStrategy walk.
    model = resolve_artifacts(
        store, strategy=STRATEGY_LATEST_BLESSED,
        pipeline_name=pipeline_name, within_pipeline=True,
    )["model"]
    return {
        "examples": [examples[s] for s in spans],
        "statistics": [stats[s] for s in spans if s in stats],
        "model": model,
    }
