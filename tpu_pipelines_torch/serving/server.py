"""REST model server over the port's exported model payloads.

The port of ``tpu_pipelines/serving/server.py``: Pusher-style
``<base>/<version>/`` payloads, the highest version served, TF-Serving
REST shapes (the same surface over gRPC: ``serving/grpc_server.py``):

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
``raw=True`` (the default) serves ``LoadedModel.predict`` (the embedded
transform applied to raw features); ``raw=False`` serves
``predict_transformed`` for callers that send transformed features.
Concurrent requests are safe and, with ``batching=True``, coalesce through
the micro-batcher into padded bucket-sized device calls.  Admission control
(``max_queue_depth``) refuses work past its bound with 429 + Retry-After.

``replicas`` / ``max_versions`` > 1, or ``model_type="generative"``, put
the same surface on the serving fleet (``serving/fleet/``): replica
batchers behind a latency-aware router, resident versions with
canary-gated hot-swap (a refused push answers 409), SLO-derived batch
deadlines (``slo_p99_ms``), an opt-in supervisor (``supervisor_interval_s``;
all replicas down answers 503 + Retry-After), and, for the generative
type, ``:generate`` through per-replica continuous-batching engines with
generation ``params``, token admission (``max_queue_tokens``, 429) and the
engine's decode levers: ``prefix_cache_entries``, ``prefill_chunk_pages``,
``spec_tokens`` and the per-token SLO ``slo_ms_per_token`` (with
``hard_deadline`` an evicted generation answers 503).
Each knob left at its default falls back to its ``TPP_SERVING_*``
environment variable, as in the reference.

Post-deploy guards (opt-in): ``slo_monitor_interval_s`` (``TPP_SLO_MONITOR``)
runs an :class:`~tpu_pipelines_torch.observability.slo.SLOMonitor` over this
server's registry while it serves, wired to the fleet's
``on_slo_breach`` (a breach inside the post-swap probation window,
``swap_probation_s`` / ``TPP_SWAP_PROBATION_S``, rolls back and quarantines
the new version); ``monitor_sample_rate`` (``TPP_SERVING_MONITOR_SAMPLE``)
and ``monitor_window_s`` (``TPP_SERVING_MONITOR_WINDOW_S``) sample the
served traffic into drift windows scored against the version's training
statistics (asking for it makes a single server a one-replica fleet).

Observability (each off by default, and then absent from ``/metrics``):
request tracing (``request_trace_mode`` / ``TPP_REQUEST_TRACE``, spans
into ``trace_dir`` / ``TPP_REQUEST_TRACE_DIR``) takes or makes a W3C
``traceparent`` at the front door, hands it back on the reply and appends
exemplar comment lines to ``/metrics``; metric federation
(``TPP_FEDERATION_DIR``) publishes this server's registry into the spool
on each scrape and serves the merged, host/replica/tenant-labelled
exposition.
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

from tpu_pipelines_torch.observability import federation as _fed
from tpu_pipelines_torch.observability import request_trace
from tpu_pipelines_torch.observability.metrics import (
    CONTENT_TYPE_LATEST,
    MetricsRegistry,
)
from tpu_pipelines_torch.observability.request_trace import RequestTracer
from tpu_pipelines_torch.serving.batching import RequestBatcher
from tpu_pipelines_torch.testing import faults as _faults
from tpu_pipelines_torch.trainer.export import (
    LoadedModel,
    load_exported_model,
    resolve_device,
)

log = logging.getLogger("tpu_pipelines_torch.serving")

# Knobs whose constructor default (0 / -1 / "") falls back to the
# environment: the admission bound, the fleet's replica count, resident
# versions and p99 budget (ms), the generative model type, its KV page
# size and token admission bound, and the supervisor's probe interval and
# wedge threshold (seconds).
ENV_MAX_QUEUE = "TPP_SERVING_MAX_QUEUE"
ENV_REPLICAS = "TPP_SERVING_REPLICAS"
ENV_MAX_VERSIONS = "TPP_SERVING_MAX_VERSIONS"
ENV_SLO_P99_MS = "TPP_SERVING_SLO_P99_MS"
ENV_MODEL_TYPE = "TPP_SERVING_MODEL_TYPE"
ENV_PAGE_SIZE = "TPP_SERVING_PAGE_SIZE"
ENV_MAX_TOKENS = "TPP_SERVING_MAX_TOKENS"
ENV_SUPERVISOR_S = "TPP_SERVING_SUPERVISOR_S"
ENV_SUPERVISOR_QUEUE_AGE_S = "TPP_SERVING_SUPERVISOR_QUEUE_AGE_S"
# The SLO monitor's evaluation interval (seconds) and the drift sampler's
# rate and window (seconds); unset, each is off.
ENV_SLO_MONITOR = "TPP_SLO_MONITOR"
ENV_MONITOR_SAMPLE = "TPP_SERVING_MONITOR_SAMPLE"
ENV_MONITOR_WINDOW = "TPP_SERVING_MONITOR_WINDOW_S"
# The per-token SLO (ms) and the engine's decode levers: resident
# prefix-cache entries, prefill pages admitted per decode round, and the
# speculative window (0 = off each).
ENV_SLO_MS_PER_TOKEN = "TPP_SERVING_SLO_MS_PER_TOKEN"
ENV_PREFIX_CACHE = "TPP_SERVING_PREFIX_CACHE"
ENV_PREFILL_CHUNK = "TPP_SERVING_PREFILL_CHUNK"
ENV_SPEC_TOKENS = "TPP_SERVING_SPEC_TOKENS"
# Request tracing: off | sample:N | all, and where the spans are written.
ENV_REQUEST_TRACE = request_trace.ENV_REQUEST_TRACE
ENV_REQUEST_TRACE_DIR = request_trace.ENV_REQUEST_TRACE_DIR


def _env_number(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "").strip() or default)
    except ValueError:
        return default


class ServerOverloaded(RuntimeError):
    """Admission control refused the request: in-flight + queued work
    already reached the configured bound.  Maps to HTTP 429 + Retry-After,
    so load is shed at the door and every admitted request keeps its
    latency budget."""

    retry_after_s = 1


class GenerateUnsupported(ValueError):
    """This server or payload cannot decode (the payload's module has no
    generate hook, or ``raw=False`` with an embedded transform).  A
    ValueError, so REST answers 400 (gRPC FAILED_PRECONDITION)."""


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
    on ``device``: raw features (``raw=True``) or transformed ones."""

    def __init__(
        self,
        model_name: str,
        base_dir: str,
        *,
        raw: bool = True,
        batching: bool = False,
        max_batch_size: int = 64,
        batch_timeout_s: float = 0.005,
        max_queue_depth: int = 0,
        replicas: int = 0,
        max_versions: int = 0,
        slo_p99_ms: float = -1.0,
        model_type: str = "",
        decode_page_size: int = 0,
        max_queue_tokens: int = 0,
        supervisor_interval_s: float = -1.0,
        supervisor_queue_age_s: float = -1.0,
        slo_ms_per_token: float = -1.0,
        hard_deadline: bool = False,
        prefix_cache_entries: int = 0,
        prefill_chunk_pages: int = 0,
        spec_tokens: int = 0,
        request_trace_mode: str = "",
        trace_dir: str = "",
        slo_monitor_interval_s: float = -1.0,
        monitor_sample_rate: float = -1.0,
        monitor_window_s: float = -1.0,
        swap_probation_s: float = -1.0,
        device: Any = "cuda",
    ):
        self.model_name = model_name
        self.base_dir = base_dir
        self.raw = raw
        self.device = resolve_device(device)
        # Constructor wins; 0 / -1 / "" fall back to the environment, then
        # to the single-server defaults.
        if max_queue_depth <= 0:
            max_queue_depth = int(_env_number(ENV_MAX_QUEUE, 0))
        if replicas <= 0:
            replicas = int(_env_number(ENV_REPLICAS, 1))
        if max_versions <= 0:
            max_versions = int(_env_number(ENV_MAX_VERSIONS, 1))
        if slo_p99_ms < 0:
            slo_p99_ms = _env_number(ENV_SLO_P99_MS, 0.0)
        if not model_type:
            model_type = os.environ.get(ENV_MODEL_TYPE, "").strip() or "predict"
        if decode_page_size <= 0:
            decode_page_size = int(_env_number(ENV_PAGE_SIZE, 0))
        if max_queue_tokens <= 0:
            max_queue_tokens = int(_env_number(ENV_MAX_TOKENS, 0))
        if supervisor_interval_s < 0:
            supervisor_interval_s = _env_number(ENV_SUPERVISOR_S, 0.0)
        if supervisor_queue_age_s < 0:
            supervisor_queue_age_s = _env_number(ENV_SUPERVISOR_QUEUE_AGE_S, 0.0)
        if slo_ms_per_token < 0:
            slo_ms_per_token = _env_number(ENV_SLO_MS_PER_TOKEN, 0.0)
        if prefix_cache_entries <= 0:
            prefix_cache_entries = int(_env_number(ENV_PREFIX_CACHE, 0))
        if prefill_chunk_pages <= 0:
            prefill_chunk_pages = int(_env_number(ENV_PREFILL_CHUNK, 0))
        if spec_tokens <= 0:
            spec_tokens = int(_env_number(ENV_SPEC_TOKENS, 0))
        self.slo_ms_per_token = max(0.0, slo_ms_per_token)
        self.hard_deadline = bool(hard_deadline)
        self.prefix_cache_entries = max(0, prefix_cache_entries)
        self.prefill_chunk_pages = max(0, prefill_chunk_pages)
        self.spec_tokens = max(0, spec_tokens)
        if slo_monitor_interval_s < 0:
            slo_monitor_interval_s = _env_number(ENV_SLO_MONITOR, 0.0)
        if monitor_sample_rate < 0:
            monitor_sample_rate = _env_number(ENV_MONITOR_SAMPLE, 0.0)
        if monitor_window_s < 0:
            monitor_window_s = _env_number(ENV_MONITOR_WINDOW, 0.0)
        self._slo_interval_s = max(0.0, slo_monitor_interval_s)
        self.monitor_sample_rate = max(0.0, monitor_sample_rate)
        self.monitor_window_s = max(0.0, monitor_window_s)
        self.slo_monitor = None
        self.replicas = max(1, replicas)
        self.max_versions = max(1, max_versions)
        self.slo_p99_ms = max(0.0, slo_p99_ms)
        self.model_type = model_type
        self.decode_page_size = max(0, decode_page_size)
        self.max_queue_tokens = max(0, max_queue_tokens)
        self.supervisor_interval_s = max(0.0, supervisor_interval_s)
        self.supervisor_queue_age_s = max(0.0, supervisor_queue_age_s)
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
        # Request tracing: constructor wins, else the environment; off (the
        # default) makes no tracer, no file and no metric family.
        self.request_tracer = RequestTracer.create(
            request_trace_mode or os.environ.get(ENV_REQUEST_TRACE, ""),
            trace_dir or os.environ.get(ENV_REQUEST_TRACE_DIR, ""),
            service=model_name,
            registry=self.metrics,
        )
        # Metric federation, opt-in through TPP_FEDERATION_DIR: each scrape
        # publishes this server's registry into the spool, then serves the
        # merged exposition.  The writer stamp keeps the merge from
        # counting this server's own spool file twice.
        self._federated = None
        self._fed_source = ""
        if _fed.federation_dir() is not None:
            self._fed_source = f"serving-{model_name}-{os.getpid()}"
            self._federated = _fed.FederatedRegistry(self.metrics)
        # The batcher resolves the current model at call time, so hot-swaps
        # apply to queued requests.  Fleet mode moves batching into the
        # replica workers behind the router; the REST surface, admission
        # control and /metrics stay here.
        self._batcher: Optional[RequestBatcher] = None
        self._fleet = None
        if (self.replicas > 1 or self.max_versions > 1
                or self.model_type == "generative"
                or self.monitor_sample_rate > 0):
            # Generative serving is a fleet model type even at one
            # replica: the engines, their per-version drain and their
            # step-graph warm-up live behind the version manager.  The
            # drift sampler hooks the fleet's leased predict path, so
            # asking for it also makes a one-replica fleet.
            from tpu_pipelines_torch.serving.fleet import ServingFleet

            self._fleet = ServingFleet(
                model_name,
                base_dir,
                replicas=self.replicas,
                raw=raw,
                max_batch_size=max_batch_size,
                batch_timeout_s=batch_timeout_s,
                slo_p99_s=self.slo_p99_ms / 1e3,
                max_versions=self.max_versions,
                model_type=self.model_type,
                decode_page_size=self.decode_page_size,
                max_queue_tokens=self.max_queue_tokens,
                slo_ms_per_token=self.slo_ms_per_token,
                hard_deadline=self.hard_deadline,
                prefix_cache_entries=self.prefix_cache_entries,
                prefill_chunk_pages=self.prefill_chunk_pages,
                spec_tokens=self.spec_tokens,
                swap_probation_s=swap_probation_s,
                supervisor_interval_s=self.supervisor_interval_s,
                supervisor_queue_age_s=self.supervisor_queue_age_s,
                monitor_sample_rate=self.monitor_sample_rate,
                monitor_window_s=self.monitor_window_s,
                registry=self.metrics,
                device=self.device,
            )
            if self._fleet.sampler is not None:
                # Drift alerts land in the request tracer's stream when
                # there is one.
                self._fleet.sampler.tracer = self.request_tracer
            if self._slo_interval_s > 0:
                # The SLO burn-rate monitor, wired to the fleet's breach
                # policy (a breach inside the post-swap probation window
                # rolls back).  With drift sampling on, the drift kind is
                # watched too.
                from tpu_pipelines_torch.observability.drift import (
                    DEFAULT_DRIFT_THRESHOLD,
                )
                from tpu_pipelines_torch.observability.slo import SLOMonitor

                self.slo_monitor = SLOMonitor(
                    self.metrics,
                    slo_p99_s=self.slo_p99_ms / 1e3,
                    drift_threshold=(
                        DEFAULT_DRIFT_THRESHOLD
                        if self.monitor_sample_rate > 0 else 0.0
                    ),
                    on_breach=self._fleet.on_slo_breach,
                    tracer=self.request_tracer,
                )
        elif batching:
            self._batcher = RequestBatcher(
                lambda b: np.asarray(self._predict_fn()(b)),
                max_batch_size=max_batch_size,
                batch_timeout_s=batch_timeout_s,
                slo_p99_s=self.slo_p99_ms / 1e3,
                registry=self.metrics,
                name="server",
            )
        try:
            self.reload()
        except BaseException:
            self._close_workers()
            raise

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
            if self._fleet is not None:
                # The version manager owns load-outside-lock, the canary
                # gate (CanaryRefused propagates: the prior version keeps
                # serving), swap, drain, eviction and serving_model_info.
                if version == self._fleet.active_version:
                    return version
                self._fleet.load_version(vdir)
                self._m_reloads.inc()
                return version
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
        if self._fleet is not None:
            return self._fleet.active_version
        return self._loaded_version

    # -------------------------------------------------- admission control

    def _admit(self, endpoint: str) -> None:
        """Admission check + in-flight accounting (pair with _release).
        A generative fleet's ``:generate`` counts outstanding decode
        tokens against ``max_queue_tokens`` (a queued 500-token generation
        is 125x the work of a 4-token one)."""
        with self._inflight_lock:
            if (endpoint == "generate" and self.max_queue_tokens > 0
                    and self._fleet is not None and self._fleet.generative):
                owed = self._fleet.outstanding_tokens()
                if owed >= self.max_queue_tokens:
                    self._m_shed.labels(endpoint).inc()
                    raise ServerOverloaded(
                        f"outstanding decode tokens {owed} >= bound "
                        f"{self.max_queue_tokens}"
                    )
            ctx = request_trace.current()
            depth = None
            if self.max_queue_depth > 0 or ctx is not None:
                depth = self._inflight
                if self._fleet is not None:
                    depth += self._fleet.queue_depth()
                elif self._batcher is not None:
                    depth += self._batcher.queue_depth()
            if self.max_queue_depth > 0 and depth >= self.max_queue_depth:
                self._m_shed.labels(endpoint).inc()
                raise ServerOverloaded(
                    f"queue depth {depth} >= bound {self.max_queue_depth}"
                )
            self._inflight += 1
        if ctx is not None:
            # What admission saw when it let the request in.
            ctx.instant("admission", depth=depth, bound=self.max_queue_depth)

    def _release(self) -> None:
        with self._inflight_lock:
            self._inflight -= 1

    # ------------------------------------------------------------- predict

    def _current_model(self) -> LoadedModel:
        if self._fleet is not None:
            loaded = self._fleet.active_loaded()
        else:
            with self._lock:
                loaded = self._loaded
        if loaded is None:
            raise RuntimeError("no model loaded")
        return loaded

    def _predict_fn(self):
        loaded = self._current_model()
        return loaded.predict if self.raw else loaded.predict_transformed

    def predict_batch(self, batch: Dict[str, Any]) -> np.ndarray:
        """Predict on a columnar feature batch — the shared entry for every
        surface, so all of them ride the same micro-batcher."""
        n_rows = len(next(iter(batch.values())))
        if self._fleet is not None:
            return self._fleet.submit(batch, n_rows)
        if self._batcher is not None:
            return self._batcher.submit(batch, n_rows)
        return np.asarray(self._predict_fn()(batch))

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
        if not self.raw and loaded.transform is not None:
            # The payload's generate applies its embedded transform, so a
            # raw=False server (callers send transformed features) would
            # transform twice.
            raise GenerateUnsupported(
                "generate requires raw features (server is raw=False but "
                "the payload embeds a transform)"
            )
        return loaded.generate

    def generate_batch(
        self,
        batch: Dict[str, Any],
        gen_params: Optional[Dict[str, Any]] = None,
    ) -> np.ndarray:
        """Seq2seq decoding of a columnar feature batch.

        ``model_type="generative"``: each row joins the fleet's
        continuous-batching engines as its own sequence.  Otherwise the
        payload's whole-request decode runs, and generation ``params``
        (meaningful on the engine path only) are refused."""
        if self._fleet is not None and self._fleet.generative:
            return self._fleet.generate_submit(batch, gen_params)
        if gen_params:
            raise ValueError(
                "generation params require a generative model type "
                f"(server model_type={self.model_type!r}); "
                f"got {sorted(gen_params)}"
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
        if self._fleet is None or not self._fleet.generative:
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
        loaded = self._loaded is not None
        if self._fleet is not None:
            batcher_open = not self._fleet.closed
            loaded = self._fleet.active_loaded() is not None
        health = {
            "healthy": loaded and batcher_open and not self._stopped,
            "model": self.model_name,
            "version": self.version,
            "batching": self._batcher is not None or self._fleet is not None,
            "device": str(self.device),
        }
        if self._fleet is not None:
            health["fleet"] = self._fleet.health()
        return health

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
                ctx = getattr(self, "_trace_ctx", None)
                if ctx is not None:
                    # The caller gets the trace id back; this request's
                    # root span is the downstream parent.
                    self.send_header("traceparent", ctx.traceparent())
                    self._trace_code = code
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/metrics":
                    body = server.metrics_text().encode("utf-8")
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
                # The request trace's root: a traceparent header joins the
                # caller's trace, its absence starts one; the sampling
                # verdict made here holds for every span downstream.
                ctx = trace_token = None
                if server.request_tracer is not None:
                    ctx = server.request_tracer.start(
                        endpoint, self.headers.get("traceparent"))
                    if ctx is not None:
                        self._trace_ctx = ctx
                        self._trace_code = 0
                        trace_token = request_trace.push(ctx)
                try:
                    # Fault hook (RELOAD_DURING_HAMMER): a no-op global
                    # read unless a test plan is active.
                    _faults.serving_request(server, endpoint)
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
                    from tpu_pipelines_torch.serving.fleet.supervisor import (
                        FleetUnavailable,
                    )
                    from tpu_pipelines_torch.serving.fleet.versions import (
                        CanaryRefused,
                    )
                    from tpu_pipelines_torch.serving.generative import (
                        EngineOverloaded,
                        GenerationEvicted,
                    )

                    # Shed token work is a 429; an evicted generation or a
                    # fleet with every replica down a retriable 503; a
                    # refused push a 409 (the server is healthy, the
                    # payload is not); caller mistakes are 4xx, not-ready
                    # a retriable 503, everything else an honest 500.
                    error = f"{type(e).__name__}: {e}"
                    if isinstance(e, EngineOverloaded):
                        code, retry = 429, EngineOverloaded.retry_after_s
                        error = f"overloaded: {e}"
                    elif isinstance(e, GenerationEvicted):
                        code, retry = 503, ServerOverloaded.retry_after_s
                        error = f"evicted: {e}"
                    elif isinstance(e, FleetUnavailable):
                        code, retry = 503, FleetUnavailable.retry_after_s
                        error = f"fleet unavailable: {e}"
                    elif isinstance(e, CanaryRefused):
                        code, retry = 409, 0
                    elif isinstance(e, (ValueError, KeyError, TypeError)):
                        code, retry = 400, 0
                    elif "no model loaded" in str(e):
                        code, retry = 503, ServerOverloaded.retry_after_s
                    else:
                        code, retry = 500, 0
                        log.exception(
                            "%s: internal error serving %s",
                            server.model_name, endpoint,
                        )
                    obj = {"error": error}
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
                if ctx is not None:
                    request_trace.pop(trace_token)
                    self._trace_ctx = None
                    ctx.finish(self._trace_code or 0)

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
        if self.slo_monitor is not None:
            self.slo_monitor.start(self._slo_interval_s)
        return self._httpd.server_address[1]

    def stop(self) -> None:
        self._stopped = True
        if self.slo_monitor is not None:
            self.slo_monitor.stop()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self._close_workers()
        if self.request_tracer is not None:
            self.request_tracer.close()
            self.request_tracer = None

    def metrics_text(self) -> str:
        """The ``/metrics`` exposition: this server's registry (merged with
        the federation spool when ``TPP_FEDERATION_DIR`` is set), then, with
        request tracing on, the exemplar comment lines."""
        if self._federated is not None:
            try:
                _fed.publish_registry(self.metrics, source=self._fed_source)
            except OSError:
                pass  # an unwritable spool: still serve the local registry
            text = self._federated.to_prometheus()
        else:
            text = self.metrics.to_prometheus()
        if self.request_tracer is not None:
            text += self.request_tracer.exemplar_exposition()
        return text

    def _close_workers(self) -> None:
        if self._batcher is not None:
            self._batcher.close()
            self._batcher = None
        if self._fleet is not None:
            # Parallel drain of every replica: bounded by one timeout.
            self._fleet.close()
            self._fleet = None
