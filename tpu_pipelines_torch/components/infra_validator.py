"""InfraValidator: canary-load the model and smoke-infer before pushing.

The port's copy of ``tpu_pipelines/components/infra_validator.py`` (TFX
InfraValidator): loads the exported payload the way serving does
(``load_exported_model``, on the runner's device ``ctx.extras["device"]``),
runs a smoke inference on a few real examples with latency probes, and
emits an InfraBlessing that Pusher can require.  ``serving_binary="http"``
canaries through the port's ``ModelServer`` on a loopback port, ``"grpc"``
through its gRPC surface (``serving/grpc_server.py``); ``raw_examples=False``
serves ``predict_transformed`` on every binary.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from tpu_pipelines_torch.data import examples_io
from tpu_pipelines_torch.dsl.component import Parameter, component
from tpu_pipelines_torch.trainer.export import load_exported_model

BLESSING_FILE = "BLESSED"
NOT_BLESSED_FILE = "NOT_BLESSED"


def canary_check(predict, batch) -> str:
    """One smoke inference; returns an error string ('' = pass).

    THE canary verdict — shared by the InfraValidator executor and the
    serving fleet's version gate (serving/fleet/versions.py), so "gated by
    the InfraValidator canary" means literally the same check at push time
    and at hot-swap time: the prediction count must match the batch, and
    every prediction must be finite."""
    try:
        preds = predict(batch)
        if len(preds) != len(next(iter(batch.values()))):
            return f"prediction count {len(preds)} != batch size"
        if not np.isfinite(np.asarray(preds, dtype=np.float64)).all():
            return "non-finite predictions"
    except Exception as e:  # noqa: BLE001 — the canary's job is catching
        return f"{type(e).__name__}: {e}"
    return ""


def serving_batch_filter(batch, schema, environment):
    """Keep only features the schema expects in ``environment`` (labels drop
    out under "SERVING") — the canary then poses exactly the request
    production serving will see.  Columns the schema does not know keep
    flowing (passthrough keys are serving-legal)."""
    return {
        k: v for k, v in batch.items()
        if k not in schema.features or schema.expected_in(k, environment)
    }


@component(
    inputs={"model": "Model", "examples": "Examples", "schema": "Schema"},
    optional_inputs=("schema",),
    is_sink=True,
    outputs={"blessing": "InfraBlessing"},
    parameters={
        "split": Parameter(type=str, default="eval"),
        "num_examples": Parameter(type=int, default=8),
        # With a schema wired, the canary batch keeps ONLY features the
        # schema expects in this environment (labels drop out under
        # "SERVING") — the canary then exercises the exact request surface
        # production serving will see (TFDV schema environments).
        "environment": Parameter(type=str, default="SERVING"),
        # Raw examples (apply embedded transform) vs pre-transformed.
        "raw_examples": Parameter(type=bool, default=True),
        # "inprocess": load + call predict directly.  "http"/"grpc": boot
        # the framework ModelServer on a loopback port and canary through
        # that surface — the closest local equivalent of the reference's
        # serving-container canary (TF Serving speaks both, SURVEY.md §3.5).
        "serving_binary": Parameter(type=str, default="inprocess"),
        # Latency smoke: after one warmup, time this many repeat predicts on
        # the same batch and record p50/p95 (ms) into the blessing.
        "latency_probes": Parameter(type=int, default=5),
        # 0 = no gate; otherwise p95 above this many ms fails validation.
        "max_latency_ms": Parameter(type=float, default=0.0),
    },
)
def InfraValidator(ctx):
    blessing = ctx.output("blessing")
    os.makedirs(blessing.uri, exist_ok=True)
    n = ctx.exec_properties["num_examples"]
    split = ctx.exec_properties["split"]
    # .get: hand-built ExecutorContexts (tests, embedding users) may omit
    # optional params the runner would have defaulted.
    probes = max(0, ctx.exec_properties.get("latency_probes", 5))
    error = ""
    latency_p50 = latency_p95 = None
    try:
        # First streamed chunk only — the canary needs n rows, not the
        # split: a full read_split here was O(split) memory and wall for an
        # 8-row request batch.
        batch = next(
            examples_io.iter_column_chunks(
                ctx.input("examples").uri, split, rows=max(1, n)
            ),
            None,
        )
        if batch is None:
            raise ValueError(f"split {split!r} is empty")
        batch = {k: v[:n] for k, v in batch.items()}
        if ctx.inputs.get("schema"):
            from tpu_pipelines_torch.data.schema import Schema

            batch = serving_batch_filter(
                batch,
                Schema.load(ctx.input("schema").uri),
                ctx.exec_properties.get("environment") or None,
            )
        binary = ctx.exec_properties.get("serving_binary", "inprocess")
        device = ctx.extras.get("device", "cuda")
        if binary == "http":
            predict = _http_canary(
                ctx.input("model").uri,
                raw=ctx.exec_properties["raw_examples"], device=device,
            )
        elif binary == "grpc":
            predict = _grpc_canary(
                ctx.input("model").uri,
                raw=ctx.exec_properties["raw_examples"], device=device,
            )
        else:
            loaded = load_exported_model(ctx.input("model").uri, device=device)
            raw_fn = (
                loaded.predict if ctx.exec_properties["raw_examples"]
                else loaded.predict_transformed
            )
            predict = lambda b: np.asarray(raw_fn(b))  # noqa: E731
        try:
            # Smoke-infer doubles as warmup; the verdict logic is shared
            # with the fleet's hot-swap gate (canary_check).
            error = canary_check(predict, batch)
            if not error and probes:
                lat_ms = []
                for _ in range(probes):
                    t0 = time.perf_counter()
                    predict(batch)
                    lat_ms.append((time.perf_counter() - t0) * 1000.0)
                latency_p50 = round(float(np.percentile(lat_ms, 50)), 3)
                latency_p95 = round(float(np.percentile(lat_ms, 95)), 3)
                gate = ctx.exec_properties.get("max_latency_ms", 0.0)
                if gate and latency_p95 > gate:
                    error = (
                        f"latency p95 {latency_p95}ms exceeds "
                        f"max_latency_ms={gate}"
                    )
        finally:
            closer = getattr(predict, "close", None)
            if closer:
                closer()
    except Exception as e:  # the canary's entire job is catching these
        error = f"{type(e).__name__}: {e}"

    marker = NOT_BLESSED_FILE if error else BLESSING_FILE
    with open(os.path.join(blessing.uri, marker), "w") as f:
        json.dump({
            "error": error,
            "latency_p50_ms": latency_p50,
            "latency_p95_ms": latency_p95,
        }, f)
    blessing.properties["blessed"] = not error
    if latency_p50 is not None:
        blessing.properties["latency_p50_ms"] = latency_p50
        blessing.properties["latency_p95_ms"] = latency_p95
    props = {"blessed": not error}
    if latency_p50 is not None:
        props["latency_p50_ms"] = latency_p50
        props["latency_p95_ms"] = latency_p95
    if error:
        props["error"] = error
    return props


def _urlopen_backoff(req, timeout: float = 60, attempts: int = 3,
                     base_delay_s: float = 0.5):
    """``urlopen`` under the shared :class:`RetryPolicy`.

    A model server that is still warming up refuses connections for a
    moment; without the retry the canary would declare the model
    NOT_BLESSED over a transient, gating a perfectly good push.  The
    shared taxonomy encodes the old contract exactly: connection-level
    failures (URLError wrapping ECONNREFUSED/reset, raw ConnectionError,
    timeouts) are transient and retried with full-jitter backoff; an
    ``HTTPError`` is PERMANENT — the server spoke, its verdict stands.
    Every retry now lands in ``retry_attempts_total{site=
    "infra_validator.urlopen"}`` on the process metrics registry.
    """
    import urllib.request

    from tpu_pipelines_torch.robustness import RetryPolicy, retry_call

    return retry_call(
        urllib.request.urlopen,
        req,
        timeout=timeout,
        policy=RetryPolicy(
            max_attempts=attempts,
            base_delay_s=base_delay_s,
            max_delay_s=8.0,
        ),
        site="infra_validator.urlopen",
    )


def _http_canary(model_uri: str, raw: bool = True, device="cuda"):
    """A reusable predict(batch) callable through the REST surface on a
    loopback port; ``.close()`` stops the server.  Keeping one server alive
    across the latency probes means they measure steady-state request cost,
    not model load."""
    import urllib.request

    from tpu_pipelines_torch.serving.server import ModelServer

    server = ModelServer("canary", model_uri, raw=raw, device=device)
    port = server.start()

    def predict(batch) -> np.ndarray:
        instances = [
            {k: np.asarray(v[i]).tolist() for k, v in batch.items()}
            for i in range(len(next(iter(batch.values()))))
        ]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/models/canary:predict",
            data=json.dumps({"instances": instances}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with _urlopen_backoff(req, timeout=60) as r:
            return np.asarray(json.load(r)["predictions"])

    predict.close = server.stop
    return predict


def _grpc_canary(model_uri: str, raw: bool = True, device="cuda"):
    """predict(batch) through the gRPC surface on a loopback port."""
    from tpu_pipelines_torch.serving.grpc_server import (
        PredictionClient,
        start_grpc_server,
    )
    from tpu_pipelines_torch.serving.server import ModelServer

    server = ModelServer("canary", model_uri, raw=raw, device=device)
    grpc_server, port = start_grpc_server(server)
    client = PredictionClient(f"127.0.0.1:{port}")

    def predict(batch) -> np.ndarray:
        preds, _ = client.predict("canary", batch)
        return np.asarray(preds)

    def close() -> None:
        client.close()
        grpc_server.stop(grace=2)
        server.stop()

    predict.close = close
    return predict
