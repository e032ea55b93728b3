"""Replica: one micro-batcher + model runner with its own telemetry.

The port of ``tpu_pipelines/serving/fleet/replica.py``.  Each replica owns
a private :class:`RequestBatcher` (its queue is the per-replica queue the
router inspects) and runs its device work on its own CUDA stream of the
fleet's ``torch.device``.  It publishes the ``serving_replica_*`` family
the router and operators read:

  ==============================================  =========================
  serving_replica_queue_depth{replica}            requests queued+in-flight
  serving_replica_p99_seconds{replica}            EWMA p99 request latency
  serving_replica_ewma_latency_seconds{replica}   EWMA mean request latency
  serving_replica_requests_total{replica}         requests routed here
  serving_replica_batch_deadline_seconds{replica} effective gather window
  serving_replica_step_seconds{replica}           EWMA device-call wall
  serving_replica_latency_seconds{replica}        latency histogram
  ==============================================  =========================

A generative replica also holds one warmed :class:`GenerativeEngine` per
resident model version (``prepare_engine``), drained and pruned across
hot-swaps.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from tpu_pipelines_torch.serving.batching import (
    RequestBatcher,
    validate_generation_params,
)
from tpu_pipelines_torch.testing import faults as _faults
from tpu_pipelines_torch.utils.device import resolve_device

# Routing cost for a replica nothing has been observed on yet: small but
# non-zero, so fresh replicas attract traffic without dividing by zero.
DEFAULT_LATENCY_S = 1e-3


def _recoverable_decode_error(exc: BaseException) -> bool:
    """Is this decode failure the replica's fault (recover the streams
    elsewhere) rather than the request's?  Overload and eviction keep their
    429/503, validation errors stay 4xx, and a client timeout is not a dead
    replica; anything else (an engine worker death, a device error) means
    the sequences need a new home."""
    from tpu_pipelines_torch.serving.generative import (
        EngineOverloaded,
        GenerationEvicted,
    )

    if isinstance(exc, (EngineOverloaded, GenerationEvicted)):
        return False
    return not isinstance(exc, (TimeoutError, ValueError, TypeError, KeyError))


class LatencyTracker:
    """Sliding-window p99 + EWMA smoothing over observed request latencies:
    the window makes p99 an order statistic over recent traffic, the EWMA
    keeps the routed-on estimate from whiplashing on one outlier."""

    def __init__(self, alpha: float = 0.2, window: int = 128):
        self.alpha = alpha
        self._samples: collections.deque = collections.deque(maxlen=window)
        self._lock = threading.Lock()
        self.ewma_mean_s = 0.0
        self.ewma_p99_s = 0.0
        self.count = 0

    def observe(self, latency_s: float) -> None:
        with self._lock:
            self._samples.append(float(latency_s))
            p99 = float(np.percentile(self._samples, 99))
            mean = float(np.mean(self._samples))
            if self.count == 0:
                self.ewma_p99_s = p99
                self.ewma_mean_s = mean
            else:
                a = self.alpha
                self.ewma_p99_s = (1 - a) * self.ewma_p99_s + a * p99
                self.ewma_mean_s = (1 - a) * self.ewma_mean_s + a * mean
            self.count += 1


class Replica:
    """One worker: batcher + runner + latency telemetry.

    ``predict_fn`` resolves the model at call time (the version manager's
    lease), so hot-swaps apply to queued work.  ``device`` is the
    ``torch.device`` the replica's work runs on (the fleet's; replicas of
    one fleet share its card), on a CUDA stream of its own."""

    def __init__(
        self,
        index: int,
        predict_fn: Callable[[Dict[str, Any]], np.ndarray],
        *,
        max_batch_size: int = 64,
        batch_timeout_s: float = 0.005,
        slo_p99_s: float = 0.0,
        device: Any = "cuda",
        registry=None,
        generative_cfg: Optional[Dict[str, Any]] = None,
    ):
        self.index = index
        self.name = str(index)
        self.device = resolve_device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        # Rebuild epoch: bumped by rebuild() so anything latched to the old
        # incarnation (an injected kill) stops applying to the new one.
        self.generation = 0
        self.latency = LatencyTracker()
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        # Generative side: one GenerativeEngine per resident version,
        # created and warmed by the fleet's canary gate.
        self._generative_cfg = generative_cfg
        self._engines: Dict[str, Any] = {}
        self._engines_lock = threading.Lock()
        self._decode_telemetry = None
        if generative_cfg is not None:
            from tpu_pipelines_torch.serving.generative import DecodeTelemetry

            self._decode_telemetry = DecodeTelemetry(registry, self.name)

        def _hooked_predict(batch, _inner=predict_fn):
            # Fault-injection seam (KILL_REPLICA / WEDGE_PREDICT /
            # DEVICE_ERROR): one module-global read when no plan is active.
            _faults.replica_predict(self.name, self.generation)
            with torch.cuda.stream(self.stream):
                return _inner(batch)

        self._predict_fn = _hooked_predict
        # Kept so rebuild() re-creates the batcher with the same knobs.
        self._batcher_kwargs = dict(
            max_batch_size=max_batch_size,
            batch_timeout_s=batch_timeout_s,
            slo_p99_s=slo_p99_s,
        )
        # Per-replica series below; the batcher's own unlabeled gauges
        # would collide across replicas.
        self.batcher = RequestBatcher(
            self._predict_fn, registry=None, name=self.name,
            **self._batcher_kwargs,
        )
        self._m_depth = self._m_p99 = self._m_ewma = self._m_requests = None
        self._m_deadline = self._m_step = self._m_latency_h = None
        if registry is not None:
            from tpu_pipelines_torch.observability.metrics import (
                fine_latency_buckets,
            )

            lab = ("replica",)
            self._m_latency_h = registry.histogram(
                "serving_replica_latency_seconds",
                "Per-request latency observed on this replica (fine "
                "sqrt(2) buckets; gauge twin: serving_replica_p99_seconds).",
                labels=lab, buckets=fine_latency_buckets(),
            ).labels(self.name)
            self._m_depth = registry.gauge(
                "serving_replica_queue_depth",
                "Requests queued or in flight on this replica.", labels=lab,
            ).labels(self.name)
            self._m_p99 = registry.gauge(
                "serving_replica_p99_seconds",
                "EWMA p99 request latency observed on this replica.",
                labels=lab,
            ).labels(self.name)
            self._m_ewma = registry.gauge(
                "serving_replica_ewma_latency_seconds",
                "EWMA mean request latency observed on this replica.",
                labels=lab,
            ).labels(self.name)
            self._m_requests = registry.counter(
                "serving_replica_requests_total",
                "Requests the router assigned to this replica.", labels=lab,
            ).labels(self.name)
            self._m_deadline = registry.gauge(
                "serving_replica_batch_deadline_seconds",
                "Effective batch-gather window on this replica "
                "(SLO-derived when slo_p99_ms is configured).", labels=lab,
            ).labels(self.name)
            self._m_step = registry.gauge(
                "serving_replica_step_seconds",
                "EWMA wall time of one coalesced device call on this "
                "replica.", labels=lab,
            ).labels(self.name)

    # ------------------------------------------------------------- routing

    def queue_depth(self) -> int:
        """Queued + in-flight work: the router's load signal."""
        with self._inflight_lock:
            inflight = self._inflight
        return self.batcher.queue_depth() + inflight

    def ewma_p99_s(self) -> float:
        return self.latency.ewma_p99_s or DEFAULT_LATENCY_S

    def routing_cost(self) -> float:
        """Estimated wait for one more request routed here: (queue depth +
        1) x EWMA p99.  A generative replica costs outstanding tokens x the
        slowest engine's EWMA step instead: requests overlap inside the
        continuous batch, so what a new sequence waits on is the token work
        ahead of it."""
        if self._generative_cfg is not None:
            tokens = 0
            step = None
            with self._engines_lock:
                engines = list(self._engines.values())
            for eng in engines:
                tokens += eng.outstanding_tokens()
                if eng.step_ewma_s is not None:
                    step = max(step or 0.0, eng.step_ewma_s)
            return (tokens + 1) * (step or DEFAULT_LATENCY_S)
        return (self.queue_depth() + 1) * self.ewma_p99_s()

    # -------------------------------------------------------------- health

    def heartbeat(self) -> None:
        """Supervisor probe: a tiny device op on this replica's stream,
        waited for.  Bypasses the batcher (the queue-age probe covers a
        wedged batcher); the fault hook fires first, so an injected kill
        fails the heartbeat as a dead device would."""
        _faults.replica_predict(self.name, self.generation)
        with torch.cuda.stream(self.stream):
            one = torch.zeros((), device=self.device) + 1.0
        if self.stream is not None:
            self.stream.synchronize()
        if float(one) != 1.0:
            raise RuntimeError(f"replica {self.name}: heartbeat read {one}")

    def rebuild(self, timeout_s: float = 2.0) -> None:
        """Rebuild in place after ejection: fail the old batcher's wedged
        work so callers unblock (and fail over), bump the generation, then
        re-create the batcher and, for a generative replica, one warmed
        engine per resident version.  The Replica object and its labeled
        series survive."""
        old = self.batcher
        old.request_close()
        old.join_close(timeout_s)
        self.generation += 1
        self.batcher = RequestBatcher(
            self._predict_fn, registry=None, name=self.name,
            **self._batcher_kwargs,
        )
        # Fresh latency window: the dead incarnation's tail must not deter
        # the router from the rebuilt replica.
        self.latency = LatencyTracker()
        cfg = self._generative_cfg
        if cfg is not None:
            final_error = None
            if cfg.get("recover"):
                final_error = RuntimeError(
                    "replica rebuilt while generation was in flight"
                )
            with self._engines_lock:
                engines = list(self._engines.values())
                self._engines.clear()
            for e in engines:
                e.close(timeout_s=timeout_s, final_error=final_error)
            versions = cfg["versions"]
            for version in versions.resident_versions():
                loaded = versions.loaded_for(version)
                if loaded is not None:
                    self.prepare_engine(version, loaded)

    # ------------------------------------------------------------- serving

    def submit(self, batch, n_rows: int, timeout_s: float = 300.0, ctx=None):
        with self._inflight_lock:
            self._inflight += 1
        if self._m_requests is not None:
            self._m_requests.inc()
            self._m_depth.set(self.queue_depth())
        t0 = time.perf_counter()
        try:
            return self.batcher.submit(
                batch, n_rows, timeout_s=timeout_s, ctx=ctx
            )
        finally:
            dt = time.perf_counter() - t0
            with self._inflight_lock:
                self._inflight -= 1
            self.latency.observe(dt)
            if self._m_latency_h is not None:
                self._m_latency_h.observe(dt)
                self._m_p99.set(self.latency.ewma_p99_s)
                self._m_ewma.set(self.latency.ewma_mean_s)
                self._m_depth.set(self.queue_depth())
                self._m_deadline.set(self.batcher.gather_window_s())
                self._m_step.set(self.batcher._step_ewma_s or 0.0)

    # --------------------------------------------------------- generative

    def prepare_engine(self, version: str, loaded) -> Any:
        """Build and warm this replica's continuous-batching engine for one
        model version: every (batch, kv) bucket's step is captured here,
        before the version becomes eligible.  Raises ``ValueError`` when the
        payload carries no decode contract."""
        if self._generative_cfg is None:
            raise RuntimeError("replica is not generative")
        with self._engines_lock:
            engine = self._engines.get(version)
        if engine is not None:
            return engine
        fns = getattr(loaded, "decode_fns", None)
        if fns is None:
            raise ValueError(
                "payload does not support generative serving (exported "
                "module defines no make_decode_fns)"
            )
        from tpu_pipelines_torch.serving.generative import GenerativeEngine

        def _engine_fault_hook(_self=self):
            # Generative traffic never reaches the batcher's predict path,
            # so the engine carries its own seam: a latched kill fails
            # decode rounds until the rebuild bumps the generation.
            _faults.replica_predict(_self.name, _self.generation)

        kwargs = dict(self._generative_cfg.get("engine_kwargs", {}))
        if int(kwargs.get("spec_tokens", 0) or 0) > 0:
            # Speculative decoding drafts with the payload's exported draft
            # lane (make_draft_decode_fns) when it ships one; otherwise the
            # engine self-drafts (correct, speed-neutral).
            kwargs["draft_fns"] = getattr(loaded, "draft_decode_fns", None)
            kwargs["draft_params"] = getattr(loaded, "draft_params", None)
        engine = GenerativeEngine(
            fns,
            loaded.params,
            device=self.device,
            telemetry=self._decode_telemetry,
            fault_hook=_engine_fault_hook,
            **kwargs,
        )
        try:
            engine.warm()
        except BaseException:
            engine.close(timeout_s=1.0)
            raise
        with self._engines_lock:
            # Two loads racing the same version: keep the first engine.
            existing = self._engines.setdefault(version, engine)
        if existing is not engine:
            engine.close(timeout_s=1.0)
            return existing
        return engine

    def decode_submit(
        self, rows, gen_params: Dict[str, Any], timeout_s: float = 300.0,
        ctx=None,
    ) -> np.ndarray:
        """Run one request's sequences through this replica's engine.

        The version lease is held for the whole generation: sequences
        admitted before a hot-swap finish on the version they started on,
        while new requests decode on the new active version.  The reply
        pads the rows to the longest emitted stream."""
        cfg = self._generative_cfg
        if cfg is None:
            raise RuntimeError("replica is not generative")
        versions = cfg["versions"]
        with self._inflight_lock:
            self._inflight += 1
        if self._m_requests is not None:
            self._m_requests.inc()
        t0 = time.perf_counter()
        try:
            with versions.lease() as (version, loaded):
                if ctx is not None:
                    # The lease pins this generation to ``version`` across
                    # any hot-swap; the trace records the pin.
                    ctx.annotate(version=version, replica=self.name)
                engine = self.prepare_engine(version, loaded)
                # Submit-time validation: a malformed request is its
                # caller's 4xx here, before any sequence joins the engine.
                gp = validate_generation_params(
                    gen_params, max_decode_len=engine.max_decode_len
                )
                handles = []
                try:
                    for row in rows:
                        handles.append(engine.submit_nowait(
                            row["inputs"],
                            input_mask=row.get("input_mask"),
                            max_new_tokens=gp["max_new_tokens"],
                            ctx=ctx,
                        ))
                    outs = [h.wait(timeout_s) for h in handles]
                except Exception as e:
                    if cfg.get("recover") and _recoverable_decode_error(e):
                        # Supervised fleet: hand the sequences' progress to
                        # the fleet, which re-prefills them elsewhere.
                        from tpu_pipelines_torch.serving.generative import (
                            DecodeSessionLost,
                        )

                        raise DecodeSessionLost(
                            e,
                            partial_tokens=[
                                [int(t) for t in h.tokens] for h in handles
                            ],
                            unfinished=sum(
                                1 for h in handles if h.result is None
                            ),
                        ) from e
                    raise
        finally:
            with self._inflight_lock:
                self._inflight -= 1
            self.latency.observe(time.perf_counter() - t0)
            self._prune_engines()
        width = max(len(o) for o in outs)
        return np.stack([
            np.pad(o, (0, width - len(o)), constant_values=engine.pad_id)
            for o in outs
        ])

    def _prune_engines(self) -> None:
        """Drop idle engines whose version is no longer resident: the
        engine half of drain-then-evict."""
        cfg = self._generative_cfg
        if cfg is None:
            return
        resident = set(cfg["versions"].resident_versions())
        with self._engines_lock:
            stale = [
                v for v, e in self._engines.items()
                if v not in resident and e.idle()
            ]
            engines = [self._engines.pop(v) for v in stale]
        for e in engines:
            e.close(timeout_s=1.0)

    def decode_outstanding_tokens(self) -> int:
        with self._engines_lock:
            engines = list(self._engines.values())
        return sum(e.outstanding_tokens() for e in engines)

    def close_engines(self, timeout_s: float = 5.0) -> None:
        with self._engines_lock:
            engines = list(self._engines.values())
            self._engines.clear()
        for e in engines:
            e.close(timeout_s=timeout_s)
