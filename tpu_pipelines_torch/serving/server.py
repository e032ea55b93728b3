"""REST model server over the port's exported model payloads.

The single-server path of ``tpu_pipelines/serving/server.py``: Pusher-style
``<base>/<version>/`` payloads, the highest version served, TF-Serving
REST shapes:

    GET  /healthz                     -> liveness + served version
    GET  /metrics                     -> Prometheus text exposition
    GET  /v1/models/<name>            -> version status
    POST /v1/models/<name>:predict    -> {"predictions": [...]}
         body: {"instances": [{feature: value, ...}, ...]}
         or    {"inputs": {feature: [values...], ...}}
    POST /v1/models/<name>:generate   -> {"outputs": [[token ids...], ...]}
         same bodies; the payload's generate hook (whole-request decode)
    POST /v1/models/<name>:reload     -> {"version": "..."} (rescan and
         hot-swap to the newest version)

The model runs on ``device`` (CUDA unless the caller asks for the CPU).
Concurrent requests are safe and, with ``batching=True``, coalesce through
the micro-batcher into padded bucket-sized device calls.  Admission control
(``max_queue_depth``) refuses work past its bound with 429 + Retry-After.
The fleet (replicas, resident versions, SLO deadlines) and with it the
continuous-batching route of ``:generate`` (generation ``params`` such as
``max_new_tokens``), gRPC, request tracing, the SLO monitor, drift
sampling, metric federation and fault hooks wait for later slices of the
port.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np

from tpu_pipelines_torch.observability.metrics import (
    CONTENT_TYPE_LATEST,
    MetricsRegistry,
)
from tpu_pipelines_torch.serving.batching import RequestBatcher
from tpu_pipelines_torch.trainer.export import (
    LoadedModel,
    load_exported_model,
    resolve_device,
)

log = logging.getLogger("tpu_pipelines_torch.serving")


class ServerOverloaded(RuntimeError):
    """Admission control refused the request: in-flight + queued work
    already reached the configured bound.  Maps to HTTP 429 + Retry-After,
    so load is shed at the door and every admitted request keeps its
    latency budget."""

    retry_after_s = 1


class GenerateUnsupported(ValueError):
    """This server or payload cannot decode (the payload's module has no
    generate hook).  A ValueError, so REST answers 400."""


def latest_version_dir(base_dir: str) -> Optional[str]:
    """Highest numeric subdirectory — the TF Serving version convention."""
    if not os.path.isdir(base_dir):
        return None
    versions = [
        d for d in os.listdir(base_dir)
        if d.isdigit() and os.path.isdir(os.path.join(base_dir, d))
    ]
    if not versions:
        return None
    return os.path.join(base_dir, max(versions, key=int))


class ModelServer:
    """Serves one model name from a version-dir layout (or a flat payload)
    on ``device``."""

    def __init__(
        self,
        model_name: str,
        base_dir: str,
        *,
        batching: bool = False,
        max_batch_size: int = 64,
        batch_timeout_s: float = 0.005,
        max_queue_depth: int = 0,
        device: Any = "cuda",
    ):
        self.model_name = model_name
        self.base_dir = base_dir
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        # Serializes reload(); never held while answering requests, so a
        # reload drains naturally onto whichever model is current.
        self._reload_lock = threading.Lock()
        # Whole-request decodes run one at a time (see generate_batch).
        self._generate_lock = threading.Lock()
        self._loaded: Optional[LoadedModel] = None
        self._loaded_version: Optional[str] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        # 0 = unbounded.
        self.max_queue_depth = max(0, int(max_queue_depth))
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self.metrics = MetricsRegistry()
        self._m_requests = self.metrics.counter(
            "serving_requests_total",
            "HTTP requests handled, by endpoint and status code.",
            labels=("endpoint", "code"),
        )
        self._m_latency = self.metrics.histogram(
            "serving_request_latency_seconds",
            "End-to-end request latency (parse + model + reply), "
            "by endpoint.",
            labels=("endpoint",),
        )
        self._m_model_info = self.metrics.gauge(
            "serving_model_info",
            "1 for the currently served model version, 0 for prior ones.",
            labels=("model", "version"),
        )
        self._m_reloads = self.metrics.counter(
            "serving_model_reloads_total",
            "Successful model version loads (including the initial one).",
        )
        self._m_shed = self.metrics.counter(
            "serving_load_shed_total",
            "Requests refused (429) by admission control, by endpoint.",
            labels=("endpoint",),
        )
        self._m_inflight = self.metrics.gauge(
            "serving_inflight_requests",
            "Predict requests currently being served.",
        )
        self._m_inflight.set_function(lambda: self._inflight)
        # The batcher resolves the current model at call time, so hot-swaps
        # apply to queued requests.
        self._batcher: Optional[RequestBatcher] = None
        if batching:
            self._batcher = RequestBatcher(
                lambda b: self._current_model().predict(b),
                max_batch_size=max_batch_size,
                batch_timeout_s=batch_timeout_s,
                registry=self.metrics,
            )
        self.reload()

    # ----------------------------------------------------------- lifecycle

    def reload(self) -> str:
        """(Re)load the newest version; returns the version string.

        The (slow) load happens outside the predict lock and the swap is a
        single reference assignment under it; a failed load leaves the
        prior version serving."""
        with self._reload_lock:
            vdir = latest_version_dir(self.base_dir)
            if vdir is None:
                # flat layout: base_dir IS the payload
                if os.path.exists(
                    os.path.join(self.base_dir, "model_spec.json")
                ):
                    vdir = self.base_dir
                else:
                    raise FileNotFoundError(
                        f"no model versions under {self.base_dir!r}"
                    )
            version = os.path.basename(vdir.rstrip("/"))
            if version == self._loaded_version:
                return version
            loaded = load_exported_model(vdir, device=self.device)
            with self._lock:
                prior = self._loaded_version
                self._loaded = loaded
                self._loaded_version = version
            if prior is not None:
                self._m_model_info.labels(self.model_name, prior).set(0)
            self._m_model_info.labels(self.model_name, version).set(1)
            self._m_reloads.inc()
            log.info("loaded %s version %s on %s", self.model_name, version,
                     self.device)
            return version

    @property
    def version(self) -> Optional[str]:
        return self._loaded_version

    # -------------------------------------------------- admission control

    def _admit(self, endpoint: str) -> None:
        """Admission check + in-flight accounting (pair with _release)."""
        with self._inflight_lock:
            if self.max_queue_depth > 0:
                depth = self._inflight
                if self._batcher is not None:
                    depth += self._batcher.queue_depth()
                if depth >= self.max_queue_depth:
                    self._m_shed.labels(endpoint).inc()
                    raise ServerOverloaded(
                        f"queue depth {depth} >= bound {self.max_queue_depth}"
                    )
            self._inflight += 1

    def _release(self) -> None:
        with self._inflight_lock:
            self._inflight -= 1

    # ------------------------------------------------------------- predict

    def _current_model(self) -> LoadedModel:
        with self._lock:
            loaded = self._loaded
        if loaded is None:
            raise RuntimeError("no model loaded")
        return loaded

    def predict_batch(self, batch: Dict[str, Any]) -> np.ndarray:
        """Predict on a columnar feature batch — the shared entry for every
        surface, so all of them ride the same micro-batcher."""
        n_rows = len(next(iter(batch.values())))
        if self._batcher is not None:
            return self._batcher.submit(batch, n_rows)
        return self._current_model().predict(batch)

    @staticmethod
    def _payload_to_batch(payload: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """TF-Serving REST semantics: 'instances' (row) or 'inputs' (column);
        None for an empty instances list."""
        if "instances" in payload:
            rows = payload["instances"]
            if not rows:
                return None
            return {
                k: np.asarray([r[k] for r in rows])
                for k in rows[0]
            }
        if "inputs" in payload:
            return {k: np.asarray(v) for k, v in payload["inputs"].items()}
        raise ValueError("request needs 'instances' or 'inputs'")

    def predict(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        batch = self._payload_to_batch(payload)
        if batch is None:
            return {"predictions": []}
        return {"predictions": self.predict_batch(batch).tolist()}

    # ------------------------------------------------------------ generate

    def _generate_fn(self):
        """The loaded model's generate callable; raises GenerateUnsupported
        when the payload cannot decode."""
        loaded = self._current_model()
        if loaded.generate is None:
            raise GenerateUnsupported(
                f"model {self.model_name!r} does not support generate "
                "(exported module has no make_generate_step or legacy "
                "make_generate_fn)"
            )
        return loaded.generate

    def generate_batch(
        self,
        batch: Dict[str, Any],
        gen_params: Optional[Dict[str, Any]] = None,
    ) -> np.ndarray:
        """Seq2seq decoding of a columnar feature batch through the
        payload's whole-request decode.  Generation ``params`` need the
        generative fleet (ROADMAP A8) and are refused here."""
        if gen_params:
            raise ValueError(
                "generation params require a generative model type (the "
                f"serving fleet, not ported yet); got {sorted(gen_params)}"
            )
        generate = self._generate_fn()
        # One decode at a time, as the device runs the reference's compiled
        # decode programs in turn: the port's is an eager loop of small
        # launches driven from the host, and loops running side by side
        # only contend for the interpreter lock.
        with self._generate_lock:
            return np.asarray(generate(batch))

    def generate(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        gen_params = payload.get("params")
        if gen_params is not None and not isinstance(gen_params, dict):
            raise ValueError(
                f"'params' must be an object, got {type(gen_params).__name__}"
            )
        # Capability check before parsing: an empty request to a server
        # that cannot generate must fail, not answer 200 [].
        self._generate_fn()
        batch = self._payload_to_batch(payload)
        if batch is None:
            return {"outputs": []}
        return {"outputs": self.generate_batch(batch, gen_params).tolist()}

    # -------------------------------------------------------------- health

    def health(self) -> Dict[str, Any]:
        """The ``GET /healthz`` payload: liveness + which version serves.
        The probe never touches the device."""
        batcher_open = self._batcher is None or not self._batcher.closed
        return {
            "healthy": (
                self._loaded is not None and batcher_open and not self._stopped
            ),
            "model": self.model_name,
            "version": self.version,
            "batching": self._batcher is not None,
            "device": str(self.device),
        }

    # ---------------------------------------------------------------- HTTP

    def start(self, port: int = 0, host: str = "127.0.0.1") -> int:
        """Serve in a background thread; returns the bound port."""
        if self._httpd is not None:
            raise RuntimeError(
                f"server for {self.model_name!r} already running on port "
                f"{self._httpd.server_address[1]}; call stop() first"
            )
        server = self

        class Handler(BaseHTTPRequestHandler):
            # TCP_NODELAY: a reply's header and body writes go out at once
            # instead of waiting on the client's delayed ACK.
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):  # route to logging, not stderr
                log.debug("http: " + fmt, *args)

            def _reply(
                self,
                code: int,
                obj: Dict[str, Any],
                endpoint: str = "",
                retry_after_s: int = 0,
            ) -> None:
                body = json.dumps(obj).encode("utf-8")
                # Counted before the reply goes out: a client that scrapes
                # /metrics after its reply must find its request counted.
                if endpoint:
                    server._m_requests.labels(endpoint, code).inc()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if retry_after_s > 0:
                    self.send_header("Retry-After", str(retry_after_s))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/metrics":
                    body = server.metrics.to_prometheus().encode("utf-8")
                    self.send_response(200)
                    self.send_header("Content-Type", CONTENT_TYPE_LATEST)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    server._m_requests.labels("metrics", 200).inc()
                elif self.path == "/healthz":
                    health = server.health()
                    self._reply(
                        200 if health["healthy"] else 503, health,
                        endpoint="healthz",
                    )
                elif self.path == f"/v1/models/{server.model_name}":
                    t0 = time.perf_counter()
                    self._reply(200, {
                        "model_version_status": [{
                            "version": server.version,
                            "state": "AVAILABLE",
                        }],
                    }, endpoint="status")
                    server._m_latency.labels("status").observe(
                        time.perf_counter() - t0
                    )
                else:
                    self._reply(
                        404, {"error": f"unknown path {self.path}"},
                        endpoint="other",
                    )

            def do_POST(self):
                routes = {
                    f"/v1/models/{server.model_name}:predict":
                        ("predict", server.predict),
                    f"/v1/models/{server.model_name}:generate":
                        ("generate", server.generate),
                    # Management op: rescan base_dir and hot-swap to the
                    # newest version.  Never admission-controlled.
                    f"/v1/models/{server.model_name}:reload":
                        ("reload", lambda _payload: {
                            "version": server.reload(),
                            "model": server.model_name,
                        }),
                }
                route = routes.get(self.path)
                if route is None:
                    self._reply(
                        404, {"error": f"unknown path {self.path}"},
                        endpoint="other",
                    )
                    return
                endpoint, handler = route
                t0 = time.perf_counter()
                admitted = False
                try:
                    if endpoint != "reload":
                        server._admit(endpoint)
                        admitted = True
                    n = int(self.headers.get("Content-Length", "0"))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    code, obj, retry = 200, handler(payload), 0
                except ServerOverloaded as e:
                    code, obj = 429, {"error": f"overloaded: {e}"}
                    retry = ServerOverloaded.retry_after_s
                except Exception as e:  # noqa: BLE001 — classify, then reply
                    # Caller mistakes are 4xx, not-ready is a retriable 503,
                    # everything else is an honest 500.
                    if isinstance(e, (ValueError, KeyError, TypeError)):
                        code, retry = 400, 0
                    elif "no model loaded" in str(e):
                        code, retry = 503, ServerOverloaded.retry_after_s
                    else:
                        code, retry = 500, 0
                        log.exception(
                            "%s: internal error serving %s",
                            server.model_name, endpoint,
                        )
                    obj = {"error": f"{type(e).__name__}: {e}"}
                finally:
                    # Released before the reply goes out: a client that
                    # sends its next request on the reply must find the
                    # slot free (the reference releases after the reply).
                    if admitted:
                        server._release()
                self._reply(code, obj, endpoint=endpoint, retry_after_s=retry)
                server._m_latency.labels(endpoint).observe(
                    time.perf_counter() - t0
                )

        class Httpd(ThreadingHTTPServer):
            # socketserver's default listen backlog is 5; a concurrent-client
            # burst overflows it into connection resets.
            request_queue_size = 128
            daemon_threads = True

        self._httpd = Httpd((host, port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self._httpd.server_address[1]

    def stop(self) -> None:
        self._stopped = True
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._batcher is not None:
            self._batcher.close()
            self._batcher = None
