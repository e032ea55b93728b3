"""Pusher: atomically publish a blessed model to the serving destination.

The port's copy of ``tpu_pipelines/components/pusher.py`` (TFX Pusher,
with the Rewriter's ``variant`` selection: the named payload of the
artifact's ``variants/`` tree, an unblessed one skipped): checks the
Evaluator's (and optionally InfraValidator's) blessing, then copies the model
payload into a monotonically-versioned directory under ``push_destination``
— staged to a temp dir and renamed, so a serving binary watching the
directory never sees a partial version (the TF Serving version-dir
convention).

Push-is-deploy: with ``serving_push_url`` set (or env
``TPP_SERVING_PUSH_URL``), a successful push also POSTs the serving tier's
``:reload`` route, so a live ModelServer/fleet hot-swaps to the new version
immediately instead of waiting out its poll interval.  The notify is
best-effort by design — the version is already durably on disk and the
server's file watcher WILL pick it up, so a notify failure (or a fleet
canary refusing the version: HTTP 409) is recorded on the execution, never
a push failure.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time

from tpu_pipelines_torch.dsl.component import Parameter, component

log = logging.getLogger("tpu_pipelines_torch.components.pusher")

# "push-URL" env rung: the serving tier's model endpoint, e.g.
# http://serving:8501/v1/models/taxi — the component parameter wins.
ENV_PUSH_URL = "TPP_SERVING_PUSH_URL"


def notify_serving(push_url: str, timeout: float = 120.0) -> dict:
    """POST ``<push_url>:reload`` and return the notify verdict dict.

    Returns ``{"notified": bool, "version" | "error": ...}``; transient
    connection faults retry with backoff (the InfraValidator urlopen
    policy), an HTTP verdict (including a 409 canary refusal) is final.
    """
    import urllib.error
    import urllib.request

    from tpu_pipelines_torch.components.infra_validator import _urlopen_backoff

    url = push_url.rstrip("/")
    if not url.endswith(":reload"):
        url += ":reload"
    req = urllib.request.Request(url, data=b"{}", method="POST")
    try:
        with _urlopen_backoff(req, timeout=timeout) as r:
            payload = json.load(r)
        return {"notified": True, "version": payload.get("version")}
    except urllib.error.HTTPError as e:
        body = ""
        try:
            body = e.read().decode("utf-8", "replace")[:500]
        except Exception:  # noqa: BLE001
            pass
        return {"notified": False, "error": f"HTTP {e.code}: {body}"}
    except Exception as e:  # noqa: BLE001 — server down/unreachable
        return {"notified": False, "error": f"{type(e).__name__}: {e}"}


@component(
    inputs={
        "model": "Model",
        "blessing": "ModelBlessing",
        "infra_blessing": "InfraBlessing",
        # Training-data lineage: wire the training run's
        # statistics/schema and the Pusher stamps their URIs onto the
        # pushed payload's model_spec.json — the serving fleet's live
        # drift baseline, resolved with zero metadata-store walks.
        "statistics": "ExampleStatistics",
        "schema": "Schema",
    },
    optional_inputs=("blessing", "infra_blessing", "statistics", "schema"),
    is_sink=True,
    outputs={"pushed_model": "PushedModel"},
    parameters={
        "push_destination": Parameter(type=str, required=True),
        # Live-fleet reload hook: "" = env TPP_SERVING_PUSH_URL, else off.
        "serving_push_url": Parameter(type=str, default=""),
        # Rewriter variant selection: "" pushes the model payload root
        # (a Rewriter artifact's root IS its selected variant); a
        # variant name ("aqt_int8" / "bfloat16" / "float32", aliases ok)
        # pushes that payload from the artifact's variants/ tree — and
        # honors the Rewriter's quality gate: an unblessed variant is a
        # skipped push, never a served model.
        "variant": Parameter(type=str, default=""),
    },
)
def Pusher(ctx):
    from tpu_pipelines_torch.components.evaluator import is_blessed

    pushed_art = ctx.output("pushed_model")
    os.makedirs(pushed_art.uri, exist_ok=True)

    for key in ("blessing", "infra_blessing"):
        if ctx.inputs.get(key) and not is_blessed(ctx.input(key).uri):
            pushed_art.properties["pushed"] = False
            pushed_art.properties["skip_reason"] = f"{key} = NOT_BLESSED"
            return {"pushed": False, "skip_reason": f"{key} = NOT_BLESSED"}

    model_uri = ctx.input("model").uri
    variant = str(ctx.exec_properties.get("variant") or "").strip()
    if variant:
        from tpu_pipelines_torch.components.rewriter import (
            canonical_variant,
            variant_blessed,
            variant_dirs,
        )

        variant = canonical_variant(variant)
        dirs = variant_dirs(model_uri)
        if variant not in dirs:
            raise ValueError(
                f"Pusher: variant {variant!r} not found under "
                f"{model_uri!r} (have {sorted(dirs) or 'no variants/'}); "
                "wire the Pusher to a Rewriter output"
            )
        if not variant_blessed(dirs[variant]):
            skip = f"variant {variant} = NOT_BLESSED"
            pushed_art.properties["pushed"] = False
            pushed_art.properties["skip_reason"] = skip
            return {"pushed": False, "skip_reason": skip}
        model_uri = dirs[variant]
        pushed_art.properties["variant"] = variant

    dest = ctx.exec_properties["push_destination"]
    os.makedirs(dest, exist_ok=True)
    existing = [int(d) for d in os.listdir(dest) if d.isdigit()]
    version = max(existing, default=int(time.time()) - 1) + 1

    staging = os.path.join(dest, f".staging-{version}")
    if os.path.exists(staging):
        shutil.rmtree(staging)
    shutil.copytree(model_uri, staging)
    # Stamp training-data lineage into the STAGING copy, before the atomic
    # rename — a watcher never sees a half-stamped payload.  The export-time
    # spec keys (trainer modules calling export_model(training_*_uri=...))
    # survive when the Pusher has nothing wired.
    stamped = {}
    if ctx.inputs.get("statistics"):
        stamped["training_statistics_uri"] = ctx.input("statistics").uri
    if ctx.inputs.get("schema"):
        stamped["training_schema_uri"] = ctx.input("schema").uri
    if stamped:
        from tpu_pipelines_torch.trainer.export import SPEC_FILE

        spec_path = os.path.join(staging, SPEC_FILE)
        try:
            with open(spec_path) as f:
                spec = json.load(f)
            spec.update(stamped)
            with open(spec_path, "w") as f:
                json.dump(spec, f, indent=2, sort_keys=True, default=str)
            pushed_art.properties.update(stamped)
        except (OSError, ValueError) as e:
            # A payload without a readable spec isn't loadable by the
            # fleet anyway; surface the miss, don't fail the push.
            log.warning(
                "could not stamp training lineage onto %s: %s", spec_path, e
            )
    final = os.path.join(dest, str(version))
    os.rename(staging, final)  # atomic within a filesystem

    with open(os.path.join(pushed_art.uri, "pushed_version.txt"), "w") as f:
        f.write(f"{final}\n")
    pushed_art.properties.update(
        {"pushed": True, "pushed_version": version, "pushed_destination": final}
    )
    result = {"pushed": True, "pushed_version": version, "destination": final}

    push_url = (
        ctx.exec_properties.get("serving_push_url")
        or os.environ.get(ENV_PUSH_URL, "")
    ).strip()
    if push_url:
        notify = notify_serving(push_url)
        if notify["notified"]:
            result["reload_notified"] = True
            result["reload_version"] = notify.get("version")
            # On the artifact too: the continuous controller's deploy
            # observation matches THIS id against the fleet's quarantine
            # list without re-deriving it from the destination path.
            pushed_art.properties["reload_version"] = notify.get("version")
        else:
            # Best-effort: the push is durable and the server's poll will
            # converge on it; surface the miss, don't fail the node.
            log.warning(
                "pushed version %s but serving notify to %r failed: %s",
                version, push_url, notify.get("error"),
            )
            result["reload_notified"] = False
            result["reload_error"] = notify.get("error")
        pushed_art.properties["reload_notified"] = result["reload_notified"]
    return result
