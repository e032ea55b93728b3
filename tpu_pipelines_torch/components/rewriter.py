"""Rewriter: quantized serving variants with a self-applied quality gate.

The port of ``tpu_pipelines/components/rewriter.py`` (the reference's
ModelOptimizer seam between Trainer and Pusher).  It consumes a trained
Model payload and emits serving variants of it, each a self-contained
payload under ``<uri>/variants/<name>/``:

  ``float32``   the original payload, hardlinked (the always-safe fallback)
  ``bfloat16``  every float tensor cast to bf16 (half the resident bytes;
                the loader casts once at load)
  ``aqt_int8``  int8 weights with per-channel scales along flax's first
                axis (``trainer/quantize.py``), dequantized inside the
                predict step (on the card, inside every captured bucket
                graph)

and hardlinks the selected variant's payload at the artifact root, so every
Model consumer (Pusher, InfraValidator, the serving fleet, BulkInferrer)
loads it with no change of wiring.

**Gate 1, quality (here).**  With an eval ``examples`` input wired, the
component runs the Evaluator's metric surface (``evaluate_payload``) on an
eval slice for the float payload and every variant, on the runner's device;
a variant whose worst relative metric delta (``metric_deltas``,
``max_metric_delta``) exceeds ``quality_tolerance`` is NOT_BLESSED:
recorded in its ``model_spec.json`` (``rewriter.blessed = false``) and by a
``REWRITE_NOT_BLESSED`` marker, and never selected.  Without eval examples
the gate fails closed: only ``float32`` is blessed.

**Gate 2, canary (fleet).**  The serving fleet's swap gate refuses any
payload whose spec says ``rewriter.blessed = false`` (409, the prior
version keeps serving), however it reached the version directory.

Each variant's measured latency (one predict at ``latency_batch_size``,
host fetch included, on this device), resident parameter bytes on the
device, and quality deltas are recorded on the execution and in
``rewrite_report.json``, so ``selection="auto"`` picks the fastest blessed
variant on the numbers measured on this card.  ``aot_warm_buckets > 0``
(the reference's serialized-executable prewarm) raises: a CUDA graph
cannot be serialized across processes (ROADMAP.md C, "No cross-process
executable cache"); the fleet captures a version's buckets at its swap.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from tpu_pipelines_torch.dsl.component import Parameter, component

log = logging.getLogger("tpu_pipelines_torch.components.rewriter")

VARIANTS_DIR = "variants"
REPORT_FILE = "rewrite_report.json"
NOT_BLESSED_MARKER = "REWRITE_NOT_BLESSED"

# Canonical variant names = payload dtype strings; aliases accepted at the
# parameter surface.
_ALIASES = {
    "bf16": "bfloat16",
    "int8": "aqt_int8",
    "f32": "float32",
    "fp32": "float32",
}
KNOWN_VARIANTS = ("float32", "bfloat16", "aqt_int8")

# Spec keys export_model owns; the rest of the source spec is carried onto
# each variant payload as it is.
_SPEC_OWNED = (
    "format", "hyperparameters", "has_transform", "dtype",
    "params_bytes",  # tpp: disable=TPP214 (payload key)
)


def canonical_variant(name: str) -> str:
    name = str(name).strip().lower()
    name = _ALIASES.get(name, name)
    if name not in KNOWN_VARIANTS:
        raise ValueError(
            f"unknown rewriter variant {name!r}; known: "
            f"{list(KNOWN_VARIANTS)} (aliases: {sorted(_ALIASES)})"
        )
    return name


def _link_or_copy(src: str, dst: str) -> None:
    try:
        os.link(src, dst)
    except OSError:
        shutil.copy2(src, dst)


def _copy_payload(src: str, dst: str) -> None:
    """Hardlink the payload entries of ``src`` into ``dst`` (byte copies
    across filesystems); an artifact root never swallows its own
    ``variants/`` tree."""
    from tpu_pipelines_torch.trainer.export import (
        CHECKPOINT_DIR, MODULE_COPY, SPEC_FILE, TRANSFORM_DIR,
    )

    os.makedirs(dst, exist_ok=True)
    for entry in (SPEC_FILE, MODULE_COPY, CHECKPOINT_DIR, TRANSFORM_DIR,
                  NOT_BLESSED_MARKER):
        s = os.path.join(src, entry)
        d = os.path.join(dst, entry)
        if not os.path.exists(s):
            continue
        if os.path.isdir(d):
            shutil.rmtree(d)
        elif os.path.exists(d):
            os.unlink(d)
        if os.path.isdir(s):
            shutil.copytree(s, d, copy_function=_link_or_copy)
        else:
            _link_or_copy(s, d)


def _annotate_spec(payload_dir: str, verdict: Dict[str, Any]) -> None:
    """Record the verdict in the payload's own spec (what the fleet's gate
    reads), and the marker when it is refused.  The spec is rewritten as a
    new file, so a hardlinked copy elsewhere keeps its own."""
    from tpu_pipelines_torch.trainer.export import SPEC_FILE

    path = os.path.join(payload_dir, SPEC_FILE)
    with open(path) as f:
        spec = json.load(f)
    spec["rewriter"] = verdict
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(spec, f, indent=2, sort_keys=True, default=str)
    os.replace(tmp, path)
    marker = os.path.join(payload_dir, NOT_BLESSED_MARKER)
    if verdict.get("blessed") is False:
        with open(marker, "w") as f:
            json.dump({"reason": verdict.get("reason", "")}, f)
    elif os.path.exists(marker):
        os.unlink(marker)


def variant_blessed(payload_dir: str) -> bool:
    """False only when the payload carries a refused verdict (a plain
    payload with no rewriter block is not gated here)."""
    from tpu_pipelines_torch.trainer.export import SPEC_FILE

    if os.path.exists(os.path.join(payload_dir, NOT_BLESSED_MARKER)):
        return False
    try:
        with open(os.path.join(payload_dir, SPEC_FILE)) as f:
            spec = json.load(f)
    except (OSError, ValueError):
        return True
    rewrite = spec.get("rewriter")
    return not (isinstance(rewrite, dict) and rewrite.get("blessed") is False)


def variant_dirs(model_uri: str) -> Dict[str, str]:
    """Variant name -> payload dir of a Rewriter output artifact (empty for
    a plain Model payload)."""
    root = os.path.join(model_uri, VARIANTS_DIR)
    if not os.path.isdir(root):
        return {}
    return {
        name: os.path.join(root, name)
        for name in sorted(os.listdir(root))
        if os.path.isdir(os.path.join(root, name))
    }


def _measure_latency_ms(predict, batch: Dict[str, np.ndarray],
                        iters: int) -> float:
    """Mean wall of one predict at the measurement batch, the host fetch
    included (what a serving request pays); two untimed calls first."""
    np.asarray(predict(batch))
    np.asarray(predict(batch))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = predict(batch)
    np.asarray(out)
    return (time.perf_counter() - t0) / max(1, iters) * 1e3


def _emit_variant(name: str, model_uri: str, vdir: str, spec: Dict[str, Any],
                  min_quant_size: int) -> Dict[str, Any]:
    """Write one variant payload; returns the quantization report (empty
    for float32 and bfloat16)."""
    from tpu_pipelines_torch.trainer import quantize as qz
    from tpu_pipelines_torch.trainer.export import (
        CHECKPOINT_DIR, MODULE_COPY, STATE_FILE, TRANSFORM_DIR, export_model,
    )
    from tpu_pipelines_torch.utils.module_loader import load_fn

    if name == "float32":
        _copy_payload(model_uri, vdir)
        return {}
    params = torch.load(os.path.join(model_uri, CHECKPOINT_DIR, STATE_FILE),
                        map_location="cpu", weights_only=True)
    hp = spec.get("hyperparameters") or {}
    report: Dict[str, Any] = {}
    if name == "bfloat16":
        params = qz.cast_params(params, torch.bfloat16)
    else:  # aqt_int8: the channel layouts come from the module's model,
        # built on the meta device (shapes and module types only).
        with torch.device("meta"):
            model = load_fn(os.path.join(model_uri, MODULE_COPY),
                            "build_model")(hp)
        params, report = qz.quantize_params(
            params, qz.channel_layouts(model), min_size=min_quant_size)
    export_model(
        serving_model_dir=vdir,
        params=params,
        module_file=os.path.join(model_uri, MODULE_COPY),
        hyperparameters=hp,
        transform_graph_uri=(os.path.join(model_uri, TRANSFORM_DIR)
                             if spec.get("has_transform") else ""),
        extra_spec={k: v for k, v in spec.items() if k not in _SPEC_OWNED},
        serving_dtype=name,
    )
    return report


@component(
    inputs={
        "model": "Model",
        "examples": "Examples",
        "transform_graph": "TransformGraph",
    },
    optional_inputs=("examples", "transform_graph"),
    outputs={"model": "Model"},
    parameters={
        # Variants to emit beyond the always-present float32 reference.
        "variants": Parameter(type=list, default=["bfloat16", "aqt_int8"]),
        # Gate 1: worst relative metric delta a variant may show against
        # the float payload on the eval slice.
        "quality_tolerance": Parameter(type=float, default=0.02),
        # None = every metric of the problem's surface; or a list of names.
        "quality_metrics": Parameter(type=list, default=None),
        # The Evaluator surface's knobs (label_key required with examples).
        "label_key": Parameter(type=str, default=""),
        "problem": Parameter(type=str, default="binary_classification"),
        "eval_split": Parameter(type=str, default="eval"),
        "batch_size": Parameter(type=int, default=512),
        # Eval-slice cap (0 = the whole split).
        "max_eval_examples": Parameter(type=int, default=4096),
        # "auto" = the fastest blessed variant by measured latency; or a
        # variant name (aliases accepted).
        "selection": Parameter(type=str, default="auto"),
        "min_quant_size": Parameter(type=int, default=4096),
        "latency_batch_size": Parameter(type=int, default=8),
        "latency_iters": Parameter(type=int, default=20),
        # > 0 raises: no serialized executables on the card (see above).
        "aot_warm_buckets": Parameter(type=int, default=0),
    },
    resource_class="tpu",
)
def Rewriter(ctx):
    from tpu_pipelines_torch.components.evaluator import (
        evaluate_payload,
        max_metric_delta,
        metric_deltas,
    )
    from tpu_pipelines_torch.data.input_pipeline import BatchIterator, InputConfig
    from tpu_pipelines_torch.trainer.export import SPEC_FILE, load_exported_model

    props = ctx.exec_properties
    if int(props["aot_warm_buckets"] or 0) > 0:
        raise NotImplementedError(
            "Rewriter: aot_warm_buckets > 0 prewarms serialized executables, "
            "and a CUDA graph cannot be serialized across processes "
            "(ROADMAP.md C, 'No cross-process executable cache'); the fleet "
            "captures each version's buckets at its swap gate")
    device = str(ctx.extras.get("device", "cuda"))
    model_uri = ctx.input("model").uri
    out_art = ctx.output("model")
    os.makedirs(out_art.uri, exist_ok=True)
    tolerance = float(props["quality_tolerance"])
    names = ["float32"]
    for v in props["variants"] or []:
        v = canonical_variant(v)
        if v not in names:
            names.append(v)
    selection = str(props["selection"] or "auto").strip().lower()
    if selection != "auto":
        selection = canonical_variant(selection)
        if selection not in names:
            raise ValueError(
                f"selection={selection!r} is not among emitted variants "
                f"{names}")

    examples = ctx.inputs.get("examples")
    examples_uri = examples[0].uri if examples else ""
    if examples_uri and not props["label_key"]:
        raise ValueError(
            "Rewriter: label_key is required when examples are wired "
            "(the quality gate runs the Evaluator metric surface)")
    eval_props = {
        "label_key": props["label_key"],
        "problem": props["problem"],
        "eval_split": props["eval_split"],
        "batch_size": props["batch_size"],
        "slice_columns": (),
        "max_eval_examples": props["max_eval_examples"],
    }
    with open(os.path.join(model_uri, SPEC_FILE)) as f:
        src_spec = json.load(f)

    # The latency batch: one eval batch without the label column, the
    # serving request's surface.
    latency_batch = None
    if examples_uri:
        first = next(iter(BatchIterator(
            examples_uri, props["eval_split"],
            InputConfig(batch_size=int(props["latency_batch_size"]),
                        shuffle=False, num_epochs=1, drop_remainder=False),
        )), None)
        if first is not None:
            latency_batch = {k: v for k, v in first.items()
                             if k != props["label_key"]}

    base_metrics: Optional[Dict[str, float]] = None
    if examples_uri:
        base_metrics = evaluate_payload(
            model_uri, examples_uri, eval_props, device=device
        ).overall().metrics

    variants: Dict[str, Dict[str, Any]] = {}
    quality_keys = props["quality_metrics"]
    for name in names:
        vdir = os.path.join(out_art.uri, VARIANTS_DIR, name)
        quant_report = _emit_variant(
            name, model_uri, vdir, src_spec, int(props["min_quant_size"]))
        loaded = load_exported_model(vdir, device=device)
        info: Dict[str, Any] = {
            "dtype": loaded.dtype,
            "params_bytes": int(loaded.params_bytes),  # tpp: disable=TPP214 (payload key)
        }
        if quant_report:
            info["num_quantized_leaves"] = quant_report.get("num_quantized", 0)
        if latency_batch is not None:
            info["latency_ms"] = round(_measure_latency_ms(
                loaded.predict_transformed, latency_batch,
                int(props["latency_iters"])), 4)
        del loaded
        if name == "float32":
            blessed, reason, deltas = True, "", {}
            info["metrics"] = base_metrics
        elif base_metrics is None:
            blessed = False
            reason = "no eval examples wired: the quality gate fails closed"
            deltas = {}
        else:
            metrics = evaluate_payload(
                vdir, examples_uri, eval_props, device=device
            ).overall().metrics
            deltas = metric_deltas(base_metrics, metrics, quality_keys)
            worst = max_metric_delta(deltas)
            blessed = worst <= tolerance
            reason = ("" if blessed else
                      f"max metric delta {worst:.4f} > quality_tolerance "
                      f"{tolerance}")
            info["metrics"] = metrics
        info.update({
            "blessed": blessed,
            "quality_deltas": {k: round(v, 6) for k, v in sorted(deltas.items())},
            "max_quality_delta": round(max_metric_delta(deltas), 6),
        })
        if reason:
            info["reason"] = reason
        _annotate_spec(vdir, {
            "variant": name,
            "blessed": blessed,
            "reason": reason,
            "quality_deltas": info["quality_deltas"],
            "max_quality_delta": info["max_quality_delta"],
            "quality_tolerance": tolerance,
            "base_model_uri": model_uri,
        })
        variants[name] = info
        if not blessed:
            log.warning("rewriter: variant %s NOT_BLESSED (%s)", name, reason)

    if selection == "auto":
        blessed_names = [n for n in names if variants[n]["blessed"]]
        if all(variants[n].get("latency_ms") is not None
               for n in blessed_names):
            selected = min(blessed_names,
                           key=lambda n: variants[n]["latency_ms"])
        else:
            selected = "float32"
    else:
        selected = selection
        if not variants[selected]["blessed"]:
            raise ValueError(
                f"selection={selected!r} failed the quality gate: "
                f"{variants[selected].get('reason', '')}")
    _copy_payload(os.path.join(out_art.uri, VARIANTS_DIR, selected),
                  out_art.uri)

    speedup = None
    if (variants[selected].get("latency_ms")
            and variants["float32"].get("latency_ms")):
        speedup = round(variants["float32"]["latency_ms"]
                        / variants[selected]["latency_ms"], 4)
    report = {
        "selected_variant": selected,
        "quality_tolerance": tolerance,
        "variants": variants,
        "speedup_vs_float": speedup,
        "base_model_uri": model_uri,
    }
    with open(os.path.join(out_art.uri, REPORT_FILE), "w") as f:
        json.dump(report, f, indent=2, sort_keys=True, default=str)
    out_art.properties.update({
        "selected_variant": selected,
        "dtype": variants[selected]["dtype"],
        "params_bytes": variants[selected]["params_bytes"],  # tpp: disable=TPP214 (payload key)
        "blessed_variants": [n for n in names if variants[n]["blessed"]],
    })
    return report
