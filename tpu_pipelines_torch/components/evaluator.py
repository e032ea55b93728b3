"""Evaluator: sliced evaluation + blessing gate.

The port's copy of ``tpu_pipelines/components/evaluator.py`` (TFX
Evaluator / TFMA): evaluates the candidate model on the eval split with its
payload loaded on the runner's device (``ctx.extras["device"]``), writes a
sliced ModelEvaluation artifact, optionally compares against a baseline
model on the same data, and emits the ModelBlessing gate that Pusher honors.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

from tpu_pipelines_torch.data.input_pipeline import BatchIterator, InputConfig
from tpu_pipelines_torch.dsl.component import Parameter, component
from tpu_pipelines_torch.evaluation.metrics import (
    AUC_EXACT_MAX_EXAMPLES,
    EvalOutcome,
    check_thresholds,
    evaluate_model,
)
from tpu_pipelines_torch.trainer.export import (
    load_exported_model,
    model_input_columns,
)

BLESSING_FILE = "BLESSED"
NOT_BLESSED_FILE = "NOT_BLESSED"


def metric_deltas(
    base: Dict[str, float],
    other: Dict[str, float],
    keys=None,
) -> Dict[str, float]:
    """Relative |delta| per shared metric — THE quality-diff surface.

    The Rewriter's per-variant quality gate and any baseline-vs-candidate
    comparison share this one definition: ``|other - base| / max(|base|,
    1e-6)`` for every metric present in both (or just ``keys``), so
    "within quality_tolerance of the float model" means the same thing
    everywhere it is enforced.
    """
    out: Dict[str, float] = {}
    for k in keys if keys is not None else sorted(set(base) & set(other)):
        b, o = base.get(k), other.get(k)
        if b is None or o is None:
            continue
        out[k] = abs(float(o) - float(b)) / max(abs(float(b)), 1e-6)
    return out


def max_metric_delta(deltas: Dict[str, float]) -> float:
    return max(deltas.values()) if deltas else 0.0


def _capped_batches(batches, max_examples: int):
    rows = 0
    for batch in batches:
        yield batch
        rows += len(next(iter(batch.values())))
        if rows >= max_examples:
            return


def evaluate_payload(
    model_uri: str, examples_uri: str, props: Dict, device: Any = "cuda",
) -> EvalOutcome:
    """Evaluate one exported payload, loaded on ``device``, on an eval
    split: the Evaluator's metric surface.  ``props["max_eval_examples"]``
    (0/absent = all) caps the slice."""
    loaded = load_exported_model(model_uri, device=device)
    # Column projection: the model's transformed-feature surface plus the
    # label and slice columns; the rest is never read.  None (no
    # transform graph in the payload) = unknown surface, read everything.
    columns = model_input_columns(loaded, raw=False)
    if columns is not None:
        columns = sorted(
            set(columns)
            | {props["label_key"]}
            | set(props["slice_columns"] or ())
        )
    batches = BatchIterator(
        examples_uri,
        props["eval_split"],
        InputConfig(
            batch_size=props["batch_size"], shuffle=False, num_epochs=1,
            drop_remainder=False,
        ),
        columns=columns,
    )
    cap = int(props.get("max_eval_examples") or 0)
    if cap > 0:
        batches = _capped_batches(batches, cap)
    return evaluate_model(
        # Eval data is transformed examples; the payload's transform was
        # already applied at materialization, so use the direct forward pass.
        loaded.predict_transformed,
        batches,
        label_key=props["label_key"],
        problem=props["problem"],
        slice_columns=tuple(props["slice_columns"] or ()),
        auc_buckets=props.get("auc_buckets") or 0,
        auto_bucket_threshold=props.get(
            "auc_exact_max_examples", AUC_EXACT_MAX_EXAMPLES
        ),
    )


@component(
    inputs={
        "examples": "Examples",
        "model": "Model",
        "baseline_model": "Model",
    },
    optional_inputs=("baseline_model",),
    outputs={"evaluation": "ModelEvaluation", "blessing": "ModelBlessing"},
    parameters={
        "label_key": Parameter(type=str, required=True),
        "problem": Parameter(type=str, default="binary_classification"),
        "eval_split": Parameter(type=str, default="eval"),
        "batch_size": Parameter(type=int, default=512),
        "slice_columns": Parameter(type=list, default=None),
        # Ranking-metric aggregation: 0 (default) = exact AUC/PR-AUC while a
        # slice stays under AUC_EXACT_MAX_EXAMPLES rows, auto-spilling to a
        # 16384-bucket streaming histogram beyond that (flat memory at
        # BulkInferrer scale, deviation < 1e-3); N > 0 = N-bucket histogram
        # from the first row (metrics.py note).
        "auc_buckets": Parameter(type=int, default=0),
        # Auto-spill row threshold for auc_buckets=0; 0 = never spill
        # (reference-exact AUC at any size, memory grows with the slice).
        "auc_exact_max_examples": Parameter(
            type=int, default=AUC_EXACT_MAX_EXAMPLES
        ),
        # {"accuracy": {"lower_bound": 0.7}, "loss": {"upper_bound": 1.0}}
        "value_thresholds": Parameter(type=dict, default=None),
        # {"accuracy": {"min_improvement": 0.0, "higher_is_better": True}}
        "change_thresholds": Parameter(type=dict, default=None),
        # Bootstrap semantics apply ONLY when baseline_model is WIRED (e.g.
        # to a Resolver) but resolved empty — the first run of a
        # continuous-training pipeline has no blessed baseline yet, so
        # change thresholds are skipped (TFX LatestBlessedModelStrategy).
        # An UNWIRED baseline_model with change thresholds configured always
        # fails the gate (fail-closed: a forgotten channel must not bless a
        # regressed model).  require_baseline=True tightens further: even
        # the wired-but-empty bootstrap fails.
        "require_baseline": Parameter(type=bool, default=False),
    },
    resource_class="tpu",
    is_sink=True,
)
def Evaluator(ctx):
    props = ctx.exec_properties
    examples_uri = ctx.input("examples").uri
    device = ctx.extras.get("device", "cuda")
    outcome = evaluate_payload(
        ctx.input("model").uri, examples_uri, props, device)

    baseline_overall = None
    baseline_uri = ""
    if ctx.inputs.get("baseline_model"):
        baseline_uri = ctx.input("baseline_model").uri
        baseline_outcome = evaluate_payload(
            baseline_uri, examples_uri, props, device)
        baseline_overall = baseline_outcome.overall().metrics

    eval_art = ctx.output("evaluation")
    outcome.save(eval_art.uri)
    overall = outcome.overall()
    eval_art.properties["overall_metrics"] = overall.metrics

    # Wired-but-empty (resolver bootstrap) may skip change thresholds;
    # never-wired must not — see the require_baseline parameter note.
    baseline_wired = "baseline_model" in ctx.inputs
    blessed, reasons = check_thresholds(
        overall.metrics,
        props["value_thresholds"] or {},
        baseline=baseline_overall,
        change_thresholds=props["change_thresholds"] or {},
        require_baseline=(
            bool(props.get("require_baseline")) or not baseline_wired
        ),
    )
    blessing_art = ctx.output("blessing")
    os.makedirs(blessing_art.uri, exist_ok=True)
    marker = BLESSING_FILE if blessed else NOT_BLESSED_FILE
    with open(os.path.join(blessing_art.uri, marker), "w") as f:
        json.dump({"reasons": reasons}, f)
    blessing_art.properties["blessed"] = blessed
    return {
        "blessed": blessed,
        "not_blessed_reasons": reasons,
        "baseline_model_uri": baseline_uri,
        **{f"overall_{k}": v for k, v in overall.metrics.items()},
        "num_slices": len(outcome.slices),
    }


def is_blessed(blessing_uri: str) -> bool:
    return os.path.exists(os.path.join(blessing_uri, BLESSING_FILE))
