"""ServingFleet: the facade ModelServer front-ends route through.

The port of ``tpu_pipelines/serving/fleet/fleet.py``.  One fleet = one
model name served by ``replicas`` workers (each its own micro-batcher and
CUDA stream on the fleet's ``device``) over a shared
:class:`ModelVersionManager`.  The REST surface stays on ``ModelServer``;
in fleet mode its ``predict_batch`` / ``reload`` delegate here.

Canary gating: the fleet remembers the first feature batch it serves and
replays it against every later pushed version through the same check
InfraValidator runs (``canary_check``: prediction count + finiteness)
before the version becomes eligible; then ``_warm_buckets`` captures one
CUDA graph per padded bucket of the new version (``serving/aot.py``).  A
generative fleet's gate also builds every replica's engine for the version
and captures its (batch, kv) step graphs.  A bad push, or a capture that
fails, is refused (:class:`CanaryRefused`, HTTP 409) while the prior
version keeps serving.

A version that became active with no canary batch yet (the one the fleet
boots with) has nothing to warm from at its gate: on CUDA the first batch
it is given is its warm-up, and every bucket is captured from that batch's
first row before the batch itself is served.  A capture that fails there
fails that request and is tried again on the next; the version never
serves eagerly.

Post-deploy guards (opt-in): ``monitor_sample_rate`` starts a
:class:`~tpu_pipelines_torch.observability.drift.TrafficSampler` fed from
the leased predict path and scored against the version's training
statistics; :meth:`on_slo_breach`, the callback the server's SLO monitor
fires, rolls a version that burns its SLO inside the post-swap probation
window (``swap_probation_s`` / ``TPP_SWAP_PROBATION_S``, default 120 s)
back to the prior resident version, whose captured graphs replay as they
are, and quarantines it.  With ``TPP_METRICS_HISTORY`` set the sampler
also appends each window's registry to the metrics-history ring under
``base_dir``.

A generative fleet passes the engine's decode levers through to every
replica's engines: ``slo_ms_per_token`` (with ``hard_deadline``),
``prefix_cache_entries``, ``prefill_chunk_pages`` and ``spec_tokens`` (the
payload's draft lane when it exports one, else self-draft).  Request traces
ride ``submit`` / ``generate_submit`` as ``ctx`` (the calling thread's
current trace by default): the route decision, the leased version and the
engine's decode spans land on the request's trace.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from tpu_pipelines_torch.observability import request_trace
from tpu_pipelines_torch.serving.fleet.pool import ReplicaPool
from tpu_pipelines_torch.serving.fleet.replica import Replica
from tpu_pipelines_torch.serving.fleet.versions import ModelVersionManager
from tpu_pipelines_torch.utils.device import resolve_device

log = logging.getLogger("tpu_pipelines_torch.serving")

# Post-swap probation window (seconds): an SLO burn-rate breach inside it
# is attributed to the swap and rolls back to the prior resident version;
# past it, breaches are the operator's page, not the fleet's trigger.
ENV_SWAP_PROBATION = "TPP_SWAP_PROBATION_S"
DEFAULT_SWAP_PROBATION_S = 120.0


def _on_cuda(loaded) -> bool:
    device = getattr(loaded, "device", None)
    return device is not None and torch.device(device).type == "cuda"


class ServingFleet:
    def __init__(
        self,
        model_name: str,
        base_dir: str,
        *,
        replicas: int = 2,
        raw: bool = True,
        max_batch_size: int = 64,
        batch_timeout_s: float = 0.005,
        slo_p99_s: float = 0.0,
        max_versions: int = 2,
        model_type: str = "predict",
        decode_page_size: int = 0,
        max_queue_tokens: int = 0,
        slo_ms_per_token: float = 0.0,
        hard_deadline: bool = False,
        prefix_cache_entries: int = 0,
        prefill_chunk_pages: int = 0,
        spec_tokens: int = 0,
        swap_probation_s: float = -1.0,
        supervisor_interval_s: float = 0.0,
        supervisor_queue_age_s: float = 0.0,
        supervisor_breaker_failures: int = 3,
        supervisor_breaker_open_s: float = 0.0,
        monitor_sample_rate: float = 0.0,
        monitor_window_s: float = 0.0,
        registry=None,
        loader: Optional[Callable[[str], Any]] = None,
        device: Any = "cuda",
    ):
        if model_type not in ("predict", "generative"):
            raise ValueError(
                f"model_type must be 'predict' or 'generative', "
                f"got {model_type!r}"
            )
        self.model_name = model_name
        self.base_dir = base_dir
        self.raw = raw
        self.slo_p99_s = slo_p99_s
        self.model_type = model_type
        self.device = resolve_device(device)
        if swap_probation_s < 0:
            try:
                swap_probation_s = float(
                    os.environ.get(ENV_SWAP_PROBATION, "").strip()
                    or DEFAULT_SWAP_PROBATION_S
                )
            except ValueError:
                swap_probation_s = DEFAULT_SWAP_PROBATION_S
        self.swap_probation_s = max(0.0, swap_probation_s)
        self._rollback_lock = threading.Lock()
        self._max_batch_size = max_batch_size
        self._canary_batch: Optional[Dict[str, Any]] = None
        self._canary_lock = threading.Lock()
        # Serializes the first-batch captures of a version that went active
        # unwarmed (the replicas' first batches arrive together).
        self._boot_warm_lock = threading.Lock()
        # What the last swap's bucket warm-up did (aot.warm_loaded's stats).
        self.last_warm: Optional[Dict[str, Any]] = None
        self._m_warmup = self._m_aot_compiles = self._m_aot_after_warm = None
        self._m_rollbacks = None
        if registry is not None:
            self._m_rollbacks = registry.counter(
                "serving_auto_rollbacks_total",
                "Automatic activations of the prior resident version "
                "after an SLO burn-rate breach inside the post-swap "
                "probation window.",
            )
            self._m_warmup = registry.gauge(
                "serving_swap_warmup_seconds",
                "Wall time of the last swap's bucket warm-up (one CUDA "
                "graph captured per padded bucket, off the request path).",
            )
            self._m_aot_compiles = registry.counter(
                "serving_aot_compiles_total",
                "Bucket graphs captured at swap gates.",
            )
            self._m_aot_after_warm = registry.counter(
                "serving_aot_compiles_after_warm_total",
                "Predict-path shapes that missed the captured-step table "
                "after warm-up (budget: zero; the predict twin of "
                "serving_decode_compiles_after_warm_total).",
            )
        self.versions = ModelVersionManager(
            model_name,
            max_versions=max_versions,
            loader=loader,
            canary_fn=self._canary,
            registry=registry,
            device=self.device,
        )
        generative_cfg = None
        if model_type == "generative":
            # The engine arena is sized by the batcher's max_batch_size;
            # the page size shapes the KV buckets.
            generative_cfg = {
                "versions": self.versions,
                "engine_kwargs": {
                    "max_batch_size": max_batch_size,
                    "page_size": decode_page_size,
                    "max_queue_tokens": max_queue_tokens,
                    "slo_ms_per_token": slo_ms_per_token,
                    "hard_deadline": hard_deadline,
                    "prefix_cache_entries": prefix_cache_entries,
                    "prefill_chunk_pages": prefill_chunk_pages,
                    "spec_tokens": spec_tokens,
                },
            }
        supervised = supervisor_interval_s > 0
        if generative_cfg is not None and supervised:
            # Supervised fleets recover in-flight generations: a dying
            # replica's decode failures surface as DecodeSessionLost.
            generative_cfg["recover"] = True
        self.pool = ReplicaPool([
            Replica(
                i,
                self._leased_predict,
                max_batch_size=max_batch_size,
                batch_timeout_s=batch_timeout_s,
                slo_p99_s=slo_p99_s,
                device=self.device,
                registry=registry,
                generative_cfg=generative_cfg,
            )
            for i in range(max(1, int(replicas)))
        ])
        # Self-healing, opt-in via supervisor_interval_s: off leaves the
        # router ungated, the pool without failover, and none of the
        # supervisor's metric families registered.
        self.supervisor = None
        self._m_unavailable = self._m_sessions_recovered = None
        if supervised:
            from tpu_pipelines_torch.serving.fleet.supervisor import (
                ReplicaSupervisor,
            )

            slo_age = 10.0 * slo_p99_s if slo_p99_s > 0 else 0.0
            self.supervisor = ReplicaSupervisor(
                self.pool,
                interval_s=supervisor_interval_s,
                queue_age_s=(
                    supervisor_queue_age_s if supervisor_queue_age_s > 0
                    else max(slo_age, 2.0)
                ),
                breaker_failures=supervisor_breaker_failures,
                breaker_open_s=supervisor_breaker_open_s,
                registry=registry,
            )
            self.pool.router.gate = self.supervisor.allow
            self.pool.supervisor = self.supervisor
            if registry is not None:
                self.pool.on_failover = registry.counter(
                    "serving_failovers_total",
                    "Requests retried on a healthy replica after a "
                    "transient failure on the routed one.",
                ).inc
                self._m_unavailable = registry.counter(
                    "serving_fleet_unavailable_total",
                    "Requests refused because every replica was ejected "
                    "or breaker-open (HTTP 503 + Retry-After).",
                )
                self._m_sessions_recovered = registry.counter(
                    "serving_decode_sessions_recovered_total",
                    "In-flight generations re-prefilled onto a surviving "
                    "replica after their replica died.",
                )
            self.supervisor.start()
        # The live drift and skew plane, opt-in via monitor_sample_rate:
        # off constructs no sampler (no thread, no queue, none of the
        # serving_monitor_* / serving_drift_* families registered).
        self.sampler = None
        if monitor_sample_rate > 0:
            from tpu_pipelines_torch.observability.drift import (
                DEFAULT_WINDOW_S,
                TrafficSampler,
            )
            from tpu_pipelines_torch.observability.metrics_history import (
                MetricsHistory,
            )

            self.sampler = TrafficSampler(
                model_name,
                sample_rate=monitor_sample_rate,
                window_s=(
                    monitor_window_s if monitor_window_s > 0
                    else DEFAULT_WINDOW_S
                ),
                registry=registry,
                baseline_for=self._drift_baseline,
                # None unless TPP_METRICS_HISTORY is set.
                history=MetricsHistory.from_env(base_dir),
            )
            self.sampler.start()

    @property
    def generative(self) -> bool:
        return self.model_type == "generative"

    # ------------------------------------------------------------- predict

    def _predict_callable(self, loaded):
        return loaded.predict if self.raw else loaded.predict_transformed

    def _leased_predict(self, batch: Dict[str, Any]) -> np.ndarray:
        """Every device call runs under a version lease: a hot-swap during
        the call cannot evict the version mid-predict, and the drain the
        swap promises is the lease count reaching zero."""
        with self.versions.lease() as (version, loaded):
            # Runs in the batcher's worker, below the span emitter: the
            # thread-local note puts the leased version on the model.step
            # span (one global int read when tracing is off).
            request_trace.note("version", version)
            if self._uncaptured(loaded):
                with self._boot_warm_lock:
                    if self._uncaptured(loaded):
                        self._capture_buckets(loaded, batch)
            result = np.asarray(self._predict_callable(loaded)(batch))
            if self.sampler is not None:
                # Rate-gated, non-blocking handoff to the drift sampler: a
                # full queue drops the sample (counted), never the predict.
                # The lease still pins ``version``, so the sample is
                # attributed to the version that served it.
                self.sampler.offer(version, batch, result)
            return result

    def _uncaptured(self, loaded) -> bool:
        """A version on CUDA whose captured-step table is still empty: it
        went active with no canary batch to warm from."""
        if not _on_cuda(loaded):
            return False
        dispatch = getattr(loaded, "aot", None)
        return dispatch is None or not dispatch.entries

    def submit(
        self, batch: Dict[str, Any], n_rows: int, timeout_s: float = 300.0,
        ctx=None,
    ) -> np.ndarray:
        if ctx is None:
            ctx = request_trace.current()
        try:
            result = self.pool.submit(
                batch, n_rows, timeout_s=timeout_s, ctx=ctx
            )
        except Exception as e:  # noqa: BLE001 — count + re-raise
            self._note_unavailable(e)
            raise
        if self._canary_batch is None:
            with self._canary_lock:
                if self._canary_batch is None:
                    # The first successfully served request becomes the
                    # canary probe for later pushes (captured after the
                    # predict returned, so a malformed first request never
                    # becomes the probe).
                    self._canary_batch = {
                        k: np.asarray(v) for k, v in batch.items()
                    }
        return result

    # ---------------------------------------------------------- generative

    def generate_submit(
        self,
        batch: Dict[str, Any],
        gen_params: Optional[Dict[str, Any]] = None,
        timeout_s: float = 300.0,
    ) -> np.ndarray:
        """Continuous-batching generate for one request's rows: the router
        picks one replica (token-aware cost) and every row joins its
        engine as its own sequence.  Needs an ``inputs`` feature (token
        ids); ``input_mask`` optional."""
        if not self.generative:
            raise RuntimeError("fleet is not generative")
        if "inputs" not in batch:
            raise ValueError(
                "generative serving requires an 'inputs' feature "
                "(token ids per row)"
            )
        inputs = np.asarray(batch["inputs"])
        mask = batch.get("input_mask")
        rows = []
        for i in range(inputs.shape[0]):
            row = {"inputs": inputs[i]}
            if mask is not None:
                row["input_mask"] = np.asarray(mask)[i]
            rows.append(row)
        ctx = request_trace.current()
        try:
            if ctx is None:
                replica = self.pool.router.pick(self.pool.replicas)
            else:
                replica, costs = self.pool.router.pick_with_costs(
                    self.pool.replicas
                )
                ctx.instant("route", replica=replica.name, costs=costs)
        except Exception as e:  # noqa: BLE001 — count + re-raise
            self._note_unavailable(e)
            raise
        try:
            return replica.decode_submit(
                rows, dict(gen_params or {}), timeout_s=timeout_s, ctx=ctx
            )
        except Exception as e:  # noqa: BLE001 — classified below
            from tpu_pipelines_torch.serving.generative import (
                DecodeSessionLost,
            )

            if not isinstance(e, DecodeSessionLost):
                raise
            return self._recover_decode(
                replica, e, rows, dict(gen_params or {}), timeout_s, ctx
            )

    def _recover_decode(self, dead, lost, rows, gen_params, timeout_s,
                        ctx=None):
        """The routed replica died with this request's generations in
        flight: greedy decode is deterministic, so re-prefilling the
        prompts onto a surviving replica gives the streams an
        uninterrupted run would have.  One recovery per request."""
        sup = self.supervisor
        if sup is None:
            raise lost.cause
        sup.on_request_error(dead, lost.cause)
        survivors = [
            r for r in self.pool.replicas if r is not dead and sup.allow(r)
        ]
        if not survivors:
            from tpu_pipelines_torch.serving.fleet.supervisor import (
                FleetUnavailable,
            )

            err = FleetUnavailable(
                "decode session lost and no healthy replica remains"
            )
            self._note_unavailable(err)
            raise err from lost.cause
        replica = self.pool.router.pick(survivors)
        if ctx is not None:
            ctx.instant(
                "decode_recover", from_replica=dead.name,
                to_replica=replica.name, unfinished=lost.unfinished,
                error=f"{type(lost.cause).__name__}: {lost.cause}",
            )
        out = replica.decode_submit(
            rows, gen_params, timeout_s=timeout_s, ctx=ctx
        )
        # Continuity audit: each recovered stream must extend the tokens
        # the dead engine had committed.
        for i, partial in enumerate(lost.partial_tokens[: len(out)]):
            got = [int(t) for t in out[i][: len(partial)]]
            if partial and got != partial:
                log.warning(
                    "fleet: %s recovered stream %d diverged from the "
                    "accepted prefix (%r -> %r)",
                    self.model_name, i, partial, got,
                )
        if self._m_sessions_recovered is not None:
            self._m_sessions_recovered.inc(max(lost.unfinished, 1))
        sup.on_request_success(replica)
        return out

    def _note_unavailable(self, exc: BaseException) -> None:
        if self._m_unavailable is not None:
            from tpu_pipelines_torch.serving.fleet.supervisor import (
                FleetUnavailable,
            )

            if isinstance(exc, FleetUnavailable):
                self._m_unavailable.inc()

    def outstanding_tokens(self) -> int:
        """Fleet-wide decode work owed (token-level admission input)."""
        return sum(r.decode_outstanding_tokens() for r in self.pool.replicas)

    # -------------------------------------------------------------- canary

    def _canary(self, loaded, version: str) -> str:
        from tpu_pipelines_torch.components.infra_validator import canary_check

        # Gate 2 of the Rewriter's double-gated deploy: a variant payload
        # the quality gate refused carries spec["rewriter"]["blessed"] =
        # false, and the fleet refuses to serve it however it reached the
        # version directory (CanaryRefused, HTTP 409; the prior version
        # keeps serving).
        spec = getattr(loaded, "spec", None)
        rewrite = spec.get("rewriter") if isinstance(spec, dict) else None
        if isinstance(rewrite, dict) and rewrite.get("blessed") is False:
            return (
                f"rewriter variant {rewrite.get('variant', '?')!r} is "
                f"NOT_BLESSED (quality gate): "
                f"{rewrite.get('reason', 'outside quality_tolerance')}"
            )
        if self.generative:
            # Every replica's engine for this version is built here and
            # captures its (batch, kv) step graphs before the version
            # becomes eligible.
            try:
                for replica in self.pool.replicas:
                    replica.prepare_engine(version, loaded)
            except Exception as e:  # noqa: BLE001 — same verdict as canary
                return f"generative warmup failed: {type(e).__name__}: {e}"
        with self._canary_lock:
            batch = self._canary_batch
        if batch is None:
            return ""  # nothing served yet: a loadable payload is eligible
        error = canary_check(self._predict_callable(loaded), batch)
        if error:
            return error
        return self._warm_buckets(loaded, batch)

    def _warm_buckets(self, loaded, batch: Dict[str, Any]) -> str:
        """Capture one graph per padded bucket shape the replica batchers
        will pose, before the swap (``serving/aot.py``), outside every
        serving lock.  A bucket the version cannot capture fails the gate:
        it would fail in production."""
        try:
            self._capture_buckets(loaded, batch)
        except Exception as e:  # noqa: BLE001 — same verdict as the canary
            return f"bucket warmup failed: {type(e).__name__}: {e}"
        return ""

    def _capture_buckets(self, loaded, batch: Dict[str, Any]) -> None:
        """``aot.warm_loaded`` on ``loaded`` from ``batch``'s first row;
        on CUDA it raises unless every bucket was captured.  The wall time
        lands in ``serving_swap_warmup_seconds``."""
        from tpu_pipelines_torch.serving import aot

        t0 = time.monotonic()
        stats = aot.warm_loaded(
            loaded, batch, self._max_batch_size, raw=self.raw
        )
        if _on_cuda(loaded) and stats.get("fallback_warm"):
            raise RuntimeError(
                "the bucket warm-up captured no graph on CUDA"
            )
        self.last_warm = stats
        if self._m_warmup is not None:
            self._m_warmup.set(time.monotonic() - t0)
            self._m_aot_compiles.inc(stats.get("compiled", 0))
        dispatch = getattr(loaded, "aot", None)
        if dispatch is not None and self._m_aot_after_warm is not None:
            dispatch.on_compile_after_warm = self._m_aot_after_warm.inc
        log.info(
            "fleet: %s bucket warmup %.3fs (%d captured%s)",
            self.model_name, stats.get("seconds", 0.0),
            stats.get("compiled", 0),
            ", legacy warm-up" if stats.get("fallback_warm") else "",
        )

    # ---------------------------------------------------------- drift plane

    def _drift_baseline(self, version: str):
        """``(SplitStatistics, uri)`` of one resident version's training
        statistics, from the ``training_statistics_uri`` the Pusher stamps
        on the payload spec (its train split, else the first); None when
        the payload has no lineage (drift against the previous window
        still runs)."""
        loaded = self.versions.loaded_for(version)
        spec = getattr(loaded, "spec", None) or {}
        uri = str(spec.get("training_statistics_uri") or "")
        if not uri:
            return None
        from tpu_pipelines_torch.data.statistics import load_statistics

        stats = load_statistics(uri)
        baseline = stats.get("train")
        if baseline is None and stats:
            baseline = stats[sorted(stats)[0]]
        if baseline is None:
            return None
        return baseline, uri

    # -------------------------------------------------- SLO auto-rollback

    def on_slo_breach(self, breach: Dict[str, Any]) -> bool:
        """The default breach policy: a post-swap probation rollback.

        An SLO burn-rate breach (``observability/slo.py``) inside
        ``swap_probation_s`` of the last hot-swap is attributed to the
        swap: the prior resident version is re-activated (it never left
        the card, so its captured graphs replay and nothing is captured
        anew), the new version is quarantined so a repeat ``:reload`` of
        it answers 409 until :meth:`clear_quarantine`, and
        ``serving_auto_rollbacks_total`` counts it.  Returns True when a
        rollback happened; False for a drift breach (a property of the
        data, not of the swap), no recent swap, an expired probation, a
        prior version no longer resident, or a rollback already done."""
        if breach.get("slo") == "drift":
            return False
        with self._rollback_lock:
            swap = self.versions.last_swap()
            if swap is None or self.swap_probation_s <= 0:
                return False
            if swap.get("rollback"):
                return False    # our own rollback opened no probation
            age_s = time.monotonic() - swap["mono"]
            if age_s > self.swap_probation_s:
                return False
            bad, prior = swap["version"], swap["prior"]
            if prior is None or self.versions.active_version != bad:
                return False
            if prior not in self.versions.resident_versions():
                return False
            self.versions.quarantine(
                bad,
                reason=(
                    f"SLO breach ({breach.get('slo', '?')}) "
                    f"{age_s:.1f}s after swap"
                ),
            )
            self.versions.activate(prior, rollback=True)
            if self._m_rollbacks is not None:
                self._m_rollbacks.inc()
            log.warning(
                "fleet: %s auto-rollback %s -> %s (%s burn breach %.1fs "
                "into the %.0fs probation window)",
                self.model_name, bad, prior, breach.get("slo", "?"),
                age_s, self.swap_probation_s,
            )
            return True

    def clear_quarantine(self, version: Optional[str] = None) -> List[str]:
        return self.versions.clear_quarantine(version)

    # ----------------------------------------------------------- lifecycle

    def load_version(self, version_dir: str) -> str:
        return self.versions.load_version(version_dir)

    def reload(self) -> str:
        """Load-and-activate the newest version under ``base_dir``."""
        from tpu_pipelines_torch.serving.server import latest_version_dir

        vdir = latest_version_dir(self.base_dir)
        if vdir is None:
            raise FileNotFoundError(
                f"no model versions under {self.base_dir!r}"
            )
        return self.load_version(vdir)

    @property
    def active_version(self) -> Optional[str]:
        return self.versions.active_version

    def active_loaded(self):
        return self.versions.active_loaded()

    def queue_depth(self) -> int:
        return self.pool.queue_depth()

    @property
    def closed(self) -> bool:
        return self.pool.closed

    def health(self) -> Dict[str, Any]:
        health = {
            "replicas": len(self.pool),
            "versions_resident": self.versions.resident_versions(),
            "active_version": self.active_version,
            "slo_p99_ms": (
                round(self.slo_p99_s * 1e3, 3) if self.slo_p99_s else None
            ),
            "model_type": self.model_type,
        }
        quarantined = self.versions.quarantined()
        if quarantined:
            health["quarantined_versions"] = sorted(quarantined)
        if self.generative:
            health["outstanding_decode_tokens"] = self.outstanding_tokens()
        if self.supervisor is not None:
            health["replica_states"] = {
                r.name: self.supervisor.state(r) for r in self.pool.replicas
            }
        if self.sampler is not None:
            health["drift"] = self.sampler.summary()
        return health

    def close(self, timeout_s: float = 5.0) -> None:
        if self.sampler is not None:
            self.sampler.stop()
        if self.supervisor is not None:
            self.supervisor.stop()
        self.pool.close(timeout_s=timeout_s)
