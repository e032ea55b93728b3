"""ContinuousController: the long-lived span -> retrain -> deploy loop.

The port of ``tpu_pipelines/continuous/controller.py``.  One controller is
one continuously retrained service:

    poll {SPAN}/{VERSION} pattern          (SpanWatcher)
      -> per-span ingest pipeline          (new or re-delivered spans only;
                                            the execution cache is the
                                            incremental planner)
      -> window pipeline                   (RollingWindowResolver ->
                                            SpanWindow/WindowStatisticsMerger
                                            -> Trainer -> Evaluator ->
                                            Pusher(serving_push_url))
      -> deploy observation                (a fleet auto-rollback inside
                                            the probation window un-blesses
                                            the triggering model in the
                                            metadata store)

Every run the controller launches is an ordinary ``LocalDagRunner`` run on
``cfg.device`` (the card unless the config asks for the CPU): traced,
metered, retried under the pipeline's policies, bounded by its node
deadlines.  The controller records which pipeline it had in flight (an
``atomic_write_json`` marker), so a restart resumes the interrupted run
with ``resume_from="latest"`` instead of re-executing settled nodes.
Watcher acks persist after the span run succeeds: the loop is
at-least-once, idempotent through the cache.

Stopping: ``run(stop_event)`` drains: the current pipeline run finishes,
no new run starts, state is persisted.  The CLI (``python -m
tpu_pipelines_torch continuous``) maps SIGINT/SIGTERM onto the stop event;
a second signal aborts.

Training telemetry: with ``TPP_METRICS_HISTORY`` set, each window run's
Trainer writes the metrics-history ring, and the iteration's summary
carries ``train_telemetry`` (the ring's headline for that run) and, when
it regressed against the previous window's, ``train_telemetry_regressions``.
With the ring unset a summary has neither key.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
import urllib.parse
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Tuple

from tpu_pipelines_torch.continuous.watcher import SpanDelivery, SpanWatcher
from tpu_pipelines_torch.dsl.pipeline import Pipeline
from tpu_pipelines_torch.metadata.types import EventType
from tpu_pipelines_torch.robustness.atomic import (
    atomic_write_json,
    load_json_tolerant,
)
from tpu_pipelines_torch.utils.device import resolve_device

log = logging.getLogger("tpu_pipelines_torch.continuous")


@dataclasses.dataclass
class ContinuousConfig:
    """Everything a controller needs; built by the user's
    ``create_continuous()`` (the CLI's ``continuous`` module contract).

    The two pipeline factories must share one metadata store: the window
    pipeline's RollingWindowResolver reads the span pipeline's artifacts
    through it.  The controller checks this on first use and refuses
    otherwise.
    """

    # {SPAN} (optionally {VERSION}) input pattern the watcher polls.
    input_pattern: str
    # Per-span ingest pipeline: ExampleGen(span=..., version=...) ->
    # StatisticsGen(save_accumulators=True).
    make_span_pipeline: Callable[[int, Optional[int]], Pipeline]
    # Window pipeline: RollingWindowResolver -> SpanWindow /
    # WindowStatisticsMerger -> Trainer -> Evaluator -> Pusher.
    make_window_pipeline: Callable[[], Pipeline]
    poll_interval_s: float = 10.0
    # Serving base URL for deploy observation, e.g.
    # "http://127.0.0.1:8501/v1/models/bert" (the Pusher push-URL); ""
    # disables rollback observation.
    serving_url: str = ""
    # How long after a deploy to watch for the fleet's auto-rollback; < 0 =
    # the fleet's own probation default (TPP_SWAP_PROBATION_S, 120 s).
    probation_watch_s: float = -1.0
    probation_poll_s: float = 1.0
    # Directory for controller state (watcher acks, in-flight run marker);
    # "" = in memory only (no resume across controller restarts).
    state_dir: str = ""
    # Lint gate level ("error"/"warn"; None = env TPP_LINT); findings below
    # the gate are logged, TPP111 armed either way.
    lint: Optional[str] = None
    # Metrics registry for the controller series (None = process default).
    registry: Any = None
    # A drift breach handed in through notify_drift or read off the serving
    # /metrics scrape between ticks marks the window dirty and triggers an
    # out-of-cadence retrain (continuous_drift_triggered_runs_total).
    drift_retrain: bool = True
    # A training/serving skew breach at or above this distance arms strict
    # ExampleValidator on the next window run (fail_on_anomalies, and the
    # batch skew comparator at this threshold when the pipeline left it
    # off).  0 disables the escalation.
    skew_strict_threshold: float = 0.0
    # The device the launched runs' device nodes use ("cuda" unless the
    # caller asks for the CPU; without CUDA the default raises).
    device: Any = "cuda"


class ContinuousController:
    def __init__(self, cfg: ContinuousConfig):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        state_path = ""
        self._pending_path = ""
        if cfg.state_dir:
            os.makedirs(cfg.state_dir, exist_ok=True)
            state_path = os.path.join(cfg.state_dir, "watcher.json")
            self._pending_path = os.path.join(cfg.state_dir, "pending.json")
        self.watcher = SpanWatcher(cfg.input_pattern, state_path=state_path)
        # A failed window run retries next tick.  A persisted pending
        # marker means the prior controller died mid-run (or left a failed
        # window behind): start dirty, so the interrupted retrain resumes
        # on the first tick instead of waiting for the next span.
        self._window_dirty = bool(self._load_pending())
        self._metadata_path: Optional[str] = None
        self.last_deploy: Optional[Dict[str, Any]] = None
        self.last_iteration: Dict[str, Any] = {}
        self._iterations = 0
        # The previous window run's metrics-history headline: the baseline
        # the next retrain's telemetry is compared against.
        self._last_window_telemetry: Optional[Dict[str, Any]] = None
        # Drift-breach intake: callbacks land in _drift_pending under the
        # lock; consumed breaches move to _drift_evidence until a window
        # run succeeds and records them (a failed retrain keeps them armed
        # for the retry tick).
        self._drift_lock = threading.Lock()
        self._linted: set = set()
        self._drift_pending: List[Dict[str, Any]] = []
        self._drift_evidence: List[Dict[str, Any]] = []
        self._last_drift_alerts: Optional[float] = None
        self._skew_strict = False
        self._init_metrics(cfg.registry)

    # ------------------------------------------------------------- metrics

    def _init_metrics(self, registry) -> None:
        if registry is None:
            from tpu_pipelines_torch.observability.metrics import (
                default_registry,
            )

            registry = default_registry()
        self.registry = registry
        self._g_seen = registry.gauge(
            "continuous_spans_seen",
            "Spans the watcher has acknowledged (processed at least once).",
        )
        self._c_processed = registry.counter(
            "continuous_spans_processed_total",
            "Span deliveries whose ingest pipeline run succeeded "
            "(version re-deliveries re-count).",
        )
        self._c_runs = registry.counter(
            "continuous_runs_total",
            "Pipeline runs launched by the controller, by kind and "
            "outcome.",
            labels=("kind", "outcome"),
        )
        self._g_work_saved = registry.gauge(
            "continuous_incremental_work_saved",
            "Last active iteration's cache-satisfied fraction of node "
            "executions (1.0 = nothing recomputed).",
        )
        self._c_deploys = registry.counter(
            "continuous_deploys_total",
            "Blessed models deployed into the serving fleet (push-URL "
            "reload notified).",
        )
        self._c_rollbacks = registry.counter(
            "continuous_rollbacks_observed_total",
            "Fleet auto-rollbacks observed inside the probation window; "
            "each un-blessed the triggering model in the metadata store.",
        )
        self._c_iterations = registry.counter(
            "continuous_iterations_total",
            "Controller loop iterations, by activity.",
            labels=("activity",),
        )
        self._c_drift_runs = registry.counter(
            "continuous_drift_triggered_runs_total",
            "Out-of-cadence window retrains triggered by a live drift/"
            "skew breach, evidence recorded on the run's drift_evidence "
            "context.",
        )

    # ---------------------------------------------------------------- lint

    def _lint_once(self, pipeline: Pipeline) -> None:
        """Analyze a handed pipeline (continuous flag armed: TPP111); gate
        at ``cfg.lint`` / env ``TPP_LINT`` level, log the findings
        otherwise.  Once per pipeline name: the factories return fresh
        equivalent objects on every call."""
        if pipeline.name in self._linted:
            return
        from tpu_pipelines_torch.analysis import (
            analyze_pipeline,
            gate_or_raise,
            resolve_lint_level,
        )

        findings = analyze_pipeline(pipeline, continuous=True)
        level = resolve_lint_level(self.cfg.lint)
        if level:
            gate_or_raise(
                findings, level,
                f"continuous controller ({pipeline.name})",
            )
        for f in findings:
            log.warning("lint: %s", f.format())
        self._linted.add(pipeline.name)

    # --------------------------------------------------------------- drift

    def notify_drift(self, breach: Dict[str, Any]) -> None:
        """Drift-breach intake: the callback target of a co-located
        ``TrafficSampler(on_alert=...)`` or ``SLOMonitor(on_breach=...)``.
        Thread-safe; non-drift breaches (latency and error SLOs are the
        fleet's probation-rollback business) are ignored.  Consumed on the
        next tick: the window goes dirty and the retrain counts in
        ``continuous_drift_triggered_runs_total``."""
        if breach.get("slo") != "drift":
            return
        with self._drift_lock:
            self._drift_pending.append(dict(breach))

    def _serving_endpoint(self, path: str) -> str:
        parts = urllib.parse.urlsplit(self.cfg.serving_url)
        return urllib.parse.urlunsplit(
            (parts.scheme, parts.netloc, path, "", "")
        )

    def _poll_drift(self) -> Optional[Dict[str, Any]]:
        """Scrape-side breach detection for a fleet in another process: an
        increase in ``serving_drift_alerts_total`` since the last tick
        makes one breach (the first scrape only sets the baseline: alerts
        from before this controller are not its retrains to run)."""
        if not self.cfg.serving_url:
            return None
        from tpu_pipelines_torch.observability.drift import parse_drift_scrape

        try:
            with urllib.request.urlopen(
                self._serving_endpoint("/metrics"), timeout=5
            ) as r:
                text = r.read().decode("utf-8", "replace")
        except Exception as e:  # noqa: BLE001 — serving briefly unreachable
            log.debug("drift metrics poll failed: %s", e)
            return None
        report = parse_drift_scrape(text)
        alerts = float(report.get("alerts_total") or 0.0)
        prev, self._last_drift_alerts = self._last_drift_alerts, alerts
        if prev is None or alerts <= prev:
            return None
        return {
            "slo": "drift",
            "source": "scrape",
            "alerts_delta": alerts - prev,
            "max_distance": report.get("max_distance", 0.0),
            "max_skew": report.get("max_skew", 0.0),
        }

    @staticmethod
    def _breach_skew(breach: Dict[str, Any]) -> float:
        """The training/serving skew distance a breach carries (0 for a
        window-over-window drift breach)."""
        if "max_skew" in breach:
            return float(breach.get("max_skew") or 0.0)
        if str(breach.get("kind", "")).startswith("skew"):
            return float(breach.get("distance") or 0.0)
        return 0.0

    def _take_drift(self) -> List[Dict[str, Any]]:
        with self._drift_lock:
            breaches, self._drift_pending = self._drift_pending, []
        scraped = self._poll_drift()
        if scraped is not None:
            breaches.append(scraped)
        return breaches

    def _arm_strict_validation(self, pipeline: Pipeline) -> None:
        """Skew escalation: every ExampleValidator in the window pipeline
        turns strict (fail_on_anomalies), with the batch skew comparator
        armed at the controller's threshold when the pipeline left both
        skew knobs off."""
        for comp in pipeline.components:
            if type(comp).__name__ != "ExampleValidator":
                continue
            comp.exec_properties["fail_on_anomalies"] = True
            if not (
                comp.exec_properties.get("skew_linf_threshold")
                or comp.exec_properties.get("skew_js_threshold")
            ):
                comp.exec_properties["skew_linf_threshold"] = (
                    self.cfg.skew_strict_threshold
                )
            log.warning(
                "continuous: strict validation armed on %s (live skew "
                "breach >= %.3f)", comp.id, self.cfg.skew_strict_threshold,
            )

    def _record_drift_evidence(
        self, run_id: str, breaches: List[Dict[str, Any]]
    ) -> None:
        """Attach the breaches to the triggered run in the shared store: a
        ``drift_evidence`` context named after the run id, the audit trail
        of why an out-of-cadence retrain happened."""
        if self._metadata_path is None:
            return
        from tpu_pipelines_torch.metadata import open_store
        from tpu_pipelines_torch.metadata.types import Context

        try:
            store = open_store(self._metadata_path)
            try:
                store.put_context(Context(
                    type_name="drift_evidence",
                    name=run_id,
                    properties={"triggered_run": run_id, "breaches": breaches},
                ))
            finally:
                store.close()
        except Exception as e:  # noqa: BLE001 — evidence is best-effort
            log.warning(
                "could not record drift evidence for %s: %s", run_id, e
            )

    # ------------------------------------------------------------ run loop

    def run(
        self,
        stop_event: Optional[threading.Event] = None,
        max_iterations: int = 0,
    ) -> None:
        """The controller loop; returns when ``stop_event`` is set (after
        draining the in-flight iteration) or ``max_iterations`` elapsed."""
        stop = stop_event if stop_event is not None else threading.Event()
        done = 0
        while not stop.is_set():
            self.run_once(stop)
            done += 1
            if max_iterations and done >= max_iterations:
                break
            if stop.wait(self.cfg.poll_interval_s):
                break
        log.info(
            "continuous controller stopped after %d iteration(s) "
            "(drained)", done,
        )

    def run_once(self, stop: Optional[threading.Event] = None) -> Dict:
        """One watch -> ingest -> retrain -> deploy-observe iteration."""
        stop = stop if stop is not None else threading.Event()
        self._iterations += 1
        t0 = time.monotonic()
        deliveries = self.watcher.poll()
        statuses: List[str] = []
        processed = 0
        for d in deliveries:
            if stop.is_set():
                break  # drain: no new run starts after the stop signal
            result = self._run_pipeline(
                self.cfg.make_span_pipeline(d.span, d.version),
                kind="span", delivery=d,
            )
            if result is not None and result.succeeded:
                self.watcher.ack([d])
                processed += 1
                self._c_processed.inc()
                statuses.extend(nr.status for nr in result.nodes.values())
                self._window_dirty = True
        self._g_seen.set(len(self.watcher.seen_spans()))

        # A drift breach (callback or scrape delta) marks the window dirty
        # as a fresh span would: the same window pipeline, out of cadence.
        if self.cfg.drift_retrain and not stop.is_set():
            fresh = self._take_drift()
            if fresh:
                self._drift_evidence.extend(fresh)
                self._window_dirty = True
                if self.cfg.skew_strict_threshold > 0 and any(
                    self._breach_skew(b) >= self.cfg.skew_strict_threshold
                    for b in fresh
                ):
                    self._skew_strict = True
                log.warning(
                    "continuous: %d drift breach(es) consumed -> "
                    "out-of-cadence retrain armed%s",
                    len(fresh),
                    " (strict validation)" if self._skew_strict else "",
                )

        deployed: Optional[Dict[str, Any]] = None
        window_size = 0
        drift_recorded = 0
        telemetry: Optional[Dict[str, Any]] = None
        telemetry_flags: List[str] = []
        if (
            self._window_dirty
            and not stop.is_set()
            and self.watcher.seen_spans()
        ):
            window_pipeline = self.cfg.make_window_pipeline()
            if self._skew_strict:
                self._arm_strict_validation(window_pipeline)
            result = self._run_pipeline(window_pipeline, kind="window")
            if result is not None and result.succeeded:
                self._window_dirty = False
                if self._drift_evidence:
                    self._c_drift_runs.inc()
                    self._record_drift_evidence(
                        result.run_id, self._drift_evidence
                    )
                    drift_recorded = len(self._drift_evidence)
                    self._drift_evidence = []
                    self._skew_strict = False
                statuses.extend(nr.status for nr in result.nodes.values())
                deployed = self._detect_deploy(result)
                window_size = self._window_span_count(result)
                telemetry, telemetry_flags = self._window_telemetry(
                    window_pipeline.pipeline_root, result.run_id
                )
            else:
                # Survives a controller restart too: the marker re-arms
                # _window_dirty in __init__.
                self._store_pending({"window_dirty": True})

        active = bool(processed or deployed or statuses)
        self._c_iterations.labels("active" if active else "idle").inc()
        executed = statuses.count("COMPLETE")
        cached = statuses.count("CACHED")
        # Of the spans the window retrained over, the fraction whose ingest
        # and statistics were reused rather than recomputed this iteration
        # (a cold bootstrap reads 0.0, steady state with window K reads
        # (K-1)/K); the cache-satisfied node fraction when no window ran.
        if window_size:
            work_saved = max(0.0, 1.0 - processed / window_size)
        elif cached + executed:
            work_saved = cached / (cached + executed)
        else:
            work_saved = None
        if work_saved is not None:
            self._g_work_saved.set(work_saved)
        summary = {
            "iteration": self._iterations,
            "deliveries": [d.key for d in deliveries],
            "spans_processed": processed,
            "nodes_executed": executed,
            "nodes_cached": cached,
            "work_saved_ratio": (
                round(work_saved, 4) if work_saved is not None else None
            ),
            "deployed": deployed,
            "wall_s": round(time.monotonic() - t0, 3),
        }
        if telemetry is not None:
            summary["train_telemetry"] = telemetry
            if telemetry_flags:
                summary["train_telemetry_regressions"] = telemetry_flags
        if drift_recorded:
            summary["drift_triggered"] = True
            summary["drift_breaches"] = drift_recorded
        if deployed is not None:
            self._c_deploys.inc()
            deployed["deploy_latency_s"] = summary["wall_s"]
            self.last_deploy = deployed
            summary["rollback_observed"] = self._observe_probation(
                deployed, stop
            )
        self.last_iteration = summary
        log.info("continuous iteration: %s", json.dumps(summary))
        return summary

    def _window_telemetry(
        self, pipeline_root: str, run_id: str
    ) -> "Tuple[Optional[Dict[str, Any]], List[str]]":
        """The finished window run's training-telemetry headline from the
        metrics-history ring, and its regression flags against the previous
        window's; ``(None, [])`` when the ring recorded nothing."""
        from tpu_pipelines_torch.observability.export import diff_metrics
        from tpu_pipelines_torch.observability.metrics_history import (
            MetricsHistory,
        )

        if not pipeline_root:
            return None, []
        try:
            headline = MetricsHistory.for_pipeline_root(
                pipeline_root).headline(run_id)
        except OSError:
            return None, []
        if not headline:
            return None, []
        flags: List[str] = []
        prev = self._last_window_telemetry
        if prev:
            flags = diff_metrics(
                {"train_telemetry": prev}, {"train_telemetry": headline},
            )["regression_flags"]
            if flags:
                log.warning("window retrain %s telemetry regressed vs the "
                            "previous window: %s", run_id, flags)
        self._last_window_telemetry = headline
        return headline, flags

    # ----------------------------------------------------------- pipelines

    def _run_pipeline(self, pipeline: Pipeline, kind: str,
                      delivery: Optional[SpanDelivery] = None):
        """Run one pipeline with crash-resume and outcome metrics.

        A pipeline named in the persisted pending marker resumes with
        ``resume_from="latest"`` (the restart-after-crash path); a refused
        resume (changed DAG, no prior run) falls back to a fresh run."""
        from tpu_pipelines_torch.orchestration import LocalDagRunner

        if self._metadata_path is None:
            self._metadata_path = pipeline.metadata_path
        elif pipeline.metadata_path != self._metadata_path:
            raise ValueError(
                "continuous pipelines must share one metadata store "
                "(window resolver reads span artifacts through it): "
                f"{pipeline.metadata_path!r} != {self._metadata_path!r}"
            )
        self._lint_once(pipeline)
        resume = None
        if self._load_pending().get("pipeline") == pipeline.name:
            resume = "latest"
        self._store_pending({
            "pipeline": pipeline.name, "kind": kind,
            "delivery": delivery.key if delivery else None,
        })
        runner = LocalDagRunner(device=self.device)
        try:
            try:
                result = runner.run(
                    pipeline, resume_from=resume, raise_on_failure=False
                )
            except ValueError as e:
                if resume is None:
                    raise
                log.info(
                    "resume of %s refused (%s); running fresh",
                    pipeline.name, e,
                )
                result = runner.run(pipeline, raise_on_failure=False)
        except Exception:  # noqa: BLE001 — the loop must survive a bad run
            log.exception("%s pipeline %s crashed", kind, pipeline.name)
            self._c_runs.labels(kind, "error").inc()
            return None
        finally:
            self._store_pending({})
        self._c_runs.labels(
            kind, "succeeded" if result.succeeded else "failed"
        ).inc()
        if not result.succeeded:
            failed = [
                f"{nr.node_id}: {nr.error.splitlines()[-1] if nr.error else ''}"
                for nr in result.nodes.values() if nr.status == "FAILED"
            ]
            log.warning(
                "%s pipeline %s run %s failed at %s (will retry on the next "
                "tick via resume/caching)",
                kind, pipeline.name, result.run_id, failed,
            )
        return result

    def _load_pending(self) -> Dict[str, Any]:
        if not self._pending_path:
            return {}
        return load_json_tolerant(self._pending_path) or {}

    def _store_pending(self, marker: Dict[str, Any]) -> None:
        if self._pending_path:
            atomic_write_json(self._pending_path, marker)

    # -------------------------------------------------------------- deploy

    @staticmethod
    def _window_span_count(result) -> int:
        """Spans the window run's SpanWindow artifact covered (0 when the
        run carried no window artifact)."""
        for nr in result.nodes.values():
            for arts in nr.outputs.values():
                for art in arts:
                    spans = art.properties.get("window_spans")
                    if art.type_name == "Examples" and isinstance(spans, list):
                        return len(spans)
        return 0

    @staticmethod
    def _detect_deploy(result) -> Optional[Dict[str, Any]]:
        """Did this window run push and hot-reload a version into the
        fleet?  Read off the PushedModel artifact the Pusher published.  A
        CACHED Pusher is a prior push replayed by the execution cache, an
        adopted one a resumed run's already-published push: neither is a
        new deploy."""
        for nr in result.nodes.values():
            if nr.status != "COMPLETE" or nr.adopted:
                continue
            for arts in nr.outputs.values():
                for art in arts:
                    if art.type_name != "PushedModel":
                        continue
                    if not art.properties.get("pushed"):
                        return None  # the blessing gate said no
                    return {
                        "run_id": result.run_id,
                        # The fleet-confirmed reload version when the
                        # notify answered, else the push directory's name.
                        "version": str(
                            art.properties.get("reload_version")
                            or art.properties.get("pushed_version", "")
                        ),
                        "reload_notified": bool(
                            art.properties.get("reload_notified")
                        ),
                        "pushed_artifact_id": art.id,
                    }
        return None

    def _probation_window_s(self) -> float:
        if self.cfg.probation_watch_s >= 0:
            return self.cfg.probation_watch_s
        from tpu_pipelines_torch.serving.fleet.fleet import (
            DEFAULT_SWAP_PROBATION_S,
            ENV_SWAP_PROBATION,
        )

        try:
            return float(
                os.environ.get(ENV_SWAP_PROBATION, "").strip()
                or DEFAULT_SWAP_PROBATION_S
            )
        except ValueError:
            return DEFAULT_SWAP_PROBATION_S

    def _quarantined(self, version: str) -> bool:
        """Whether ``/healthz``'s ``fleet.quarantined_versions`` lists
        ``version`` (False while serving is unreachable)."""
        try:
            with urllib.request.urlopen(
                self._serving_endpoint("/healthz"), timeout=5
            ) as r:
                health = json.load(r)
        except Exception as e:  # noqa: BLE001 — serving briefly unreachable
            log.debug("healthz poll failed: %s", e)
            return False
        fleet = (health or {}).get("fleet") or {}
        return bool(version) and version in (
            fleet.get("quarantined_versions") or []
        )

    def _observe_probation(
        self, deployed: Dict[str, Any], stop: threading.Event
    ) -> bool:
        """Watch the fleet for ``probation_watch_s`` after a deploy: a
        quarantine of the pushed version means the SLO monitor breached and
        the fleet rolled back; record it and un-bless the triggering model,
        so the rolling resolver never baselines it.  True when a rollback
        was observed.

        On a stop the watch takes one last look and returns; a rollback
        after that is reconciled by the next deploy's quarantine check (the
        fleet keeps the version quarantined)."""
        if not self.cfg.serving_url or not deployed.get("reload_notified"):
            return False
        version = deployed.get("version", "")
        deadline = time.monotonic() + self._probation_window_s()
        while True:
            if self._quarantined(version):
                self._record_rollback(deployed)
                return True
            if stop.is_set() or time.monotonic() >= deadline:
                return False
            if stop.wait(self.cfg.probation_poll_s):
                if self._quarantined(version):
                    self._record_rollback(deployed)
                    return True
                return False

    def _record_rollback(self, deployed: Dict[str, Any]) -> None:
        """The fleet rolled the deploy back: un-bless the triggering model
        in the metadata store (properties and on-disk markers), so the
        resolver strategies, which walk blessed=True blessings, never pick
        it as a baseline, and the audit trail shows why."""
        self._c_rollbacks.inc()
        deployed["rolled_back"] = True
        reason = (
            f"serving fleet auto-rollback: version "
            f"{deployed.get('version')} quarantined inside the post-swap "
            f"probation window (run {deployed.get('run_id')})"
        )
        log.warning("continuous: %s", reason)
        from tpu_pipelines_torch.components.evaluator import (
            BLESSING_FILE,
            NOT_BLESSED_FILE,
        )
        from tpu_pipelines_torch.metadata import open_store

        store = open_store(self._metadata_path)
        try:
            pushed = store.get_artifact(
                int(deployed.get("pushed_artifact_id") or 0)
            )
            if pushed is None:
                return
            # Walk push -> producing execution -> its blessing and model
            # INPUTs: the artifacts of the run that deployed this version.
            ex_ids = [
                ev.execution_id
                for ev in store.get_events_by_artifact(pushed.id)
                if ev.type == EventType.OUTPUT
            ]
            for ex_id in ex_ids:
                for ev in store.get_events_by_execution(ex_id):
                    if ev.type != EventType.INPUT:
                        continue
                    art = store.get_artifact(ev.artifact_id)
                    if art is None:
                        continue
                    if art.type_name == "ModelBlessing":
                        art.properties.update({
                            "blessed": False, "unblessed_reason": reason,
                        })
                        store.put_artifact(art)
                        try:
                            marker = os.path.join(art.uri, BLESSING_FILE)
                            if os.path.exists(marker):
                                os.remove(marker)
                            with open(os.path.join(
                                    art.uri, NOT_BLESSED_FILE), "w") as f:
                                json.dump({"reasons": [reason]}, f)
                        except OSError as e:
                            log.warning(
                                "could not rewrite blessing markers under "
                                "%s: %s", art.uri, e,
                            )
                    elif art.type_name == "Model" and ev.path == "model":
                        art.properties.update({
                            "rollback_quarantined": True,
                            "unblessed_reason": reason,
                        })
                        store.put_artifact(art)
            pushed.properties.update({
                "rolled_back": True, "rollback_reason": reason,
            })
            store.put_artifact(pushed)
        finally:
            store.close()

    # -------------------------------------------------------------- status

    def status(self) -> Dict[str, Any]:
        return {
            "pattern": self.cfg.input_pattern,
            "spans_seen": self.watcher.seen_spans(),
            "iterations": self._iterations,
            "last_iteration": self.last_iteration,
            "last_deploy": self.last_deploy,
        }
