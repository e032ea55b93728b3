"""Live-traffic drift & skew plane: sample the serving stream, score it
against the training baseline.

The port's copy of ``tpu_pipelines/observability/drift.py``.  Batch-time
drift detection (ExampleValidator's L-inf/JS comparators over StatisticsGen
artifacts) only sees data a pipeline run ingested; this module watches the
live request stream with the same statistics algebra:

  request admitted -> ``ServingFleet._leased_predict`` offers the batch
  (+ the prediction output) to a :class:`TrafficSampler` -> a bounded
  queue hands it off the critical path -> a worker thread folds sampled
  rows into the ``SplitStatsAccumulator``s of ``data/statistics.py`` (over
  the port's numpy columns) over tumbling windows -> each closed window is
  scored against the deployed version's training-time statistics (the
  payload spec's ``training_statistics_uri``, stamped by the Pusher) with
  ``linf_categorical_distance`` / ``js_numeric_divergence`` -> distances
  publish as gauges, alert crossings count, breach callbacks fire.

Score kinds per window (the ``kind`` label on
``serving_drift_distance``):

  ==========  ========================================================
  skew_linf   categorical L-inf vs the TRAINING baseline (TFDV
              training/serving skew)
  skew_js     numeric JS divergence vs the TRAINING baseline
  drift_linf  categorical L-inf vs the PREVIOUS live window (TFDV
              span-over-span drift)
  drift_js    numeric JS divergence vs the previous live window
  ==========  ========================================================

Prediction outputs fold into their own accumulator and score against the
previous window (``serving_prediction_drift_distance{model,stat}``).

Zero footprint when off: with no ``monitor_sample_rate`` /
``TPP_SERVING_MONITOR_SAMPLE``, no sampler is constructed — no thread, no
metric family.  When on, the predict path pays one counter bump and a
``put_nowait``: a wedged queue drops the sample (counted), never blocks a
predict.  Alerts are ``drift/alert`` instants in the server's request
tracer when one exists (``observability/request_trace.py``), else in the
active run trace (``observability/trace.py``).  With ``history=`` (a
:class:`~tpu_pipelines_torch.observability.metrics_history.MetricsHistory`,
which the fleet passes when ``TPP_METRICS_HISTORY`` is set) every window
appends the registry to the ring under run id ``serving-<model>``.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import re
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from tpu_pipelines_torch.data.examples_io import Table
from tpu_pipelines_torch.observability import trace as _trace

log = logging.getLogger("tpu_pipelines_torch.observability")

# Fraction of admitted predict requests sampled into the monitor
# (0 < rate <= 1); unset/0 = the whole plane is off.
ENV_MONITOR_SAMPLE = "TPP_SERVING_MONITOR_SAMPLE"
# Tumbling-window length in seconds (default 60).
ENV_MONITOR_WINDOW = "TPP_SERVING_MONITOR_WINDOW_S"

DEFAULT_WINDOW_S = 60.0
# Alert thresholds mirror ExampleValidator's drift_threshold default.
DEFAULT_DRIFT_THRESHOLD = 0.3
# Windows with fewer sampled rows than this are folded but never alert
# (the SLO monitor's min_events guard, applied at the source).
DEFAULT_MIN_SAMPLES = 20

PREDICTION_COLUMN = "prediction"
PREDICTED_CLASS_COLUMN = "predicted_class"


@dataclasses.dataclass
class DriftScore:
    """One (feature, comparator) distance from a closed window."""

    feature: str
    kind: str            # skew_linf | skew_js | drift_linf | drift_js
    distance: float
    threshold: float

    @property
    def breached(self) -> bool:
        return self.threshold > 0 and self.distance > self.threshold

    def to_json(self) -> Dict[str, Any]:
        return {
            "feature": self.feature, "kind": self.kind,
            "distance": round(self.distance, 6),
            "threshold": self.threshold, "breached": self.breached,
        }


@dataclasses.dataclass
class DriftWindow:
    """One closed, scored tumbling window for one resident version."""

    model: str
    version: str
    index: int
    sampled: int
    scores: List[DriftScore]
    prediction_scores: Dict[str, float]
    statistics: Any = None          # SplitStatistics of the window's features
    baseline_uri: str = ""

    @property
    def alerts(self) -> List[DriftScore]:
        return [s for s in self.scores if s.breached]

    def max_distance(self, prefix: str = "") -> float:
        vals = [
            s.distance for s in self.scores if s.kind.startswith(prefix)
        ]
        return max(vals) if vals else 0.0

    def to_json(self) -> Dict[str, Any]:
        return {
            "model": self.model, "version": self.version,
            "window": self.index, "sampled": self.sampled,
            "scores": [s.to_json() for s in self.scores],
            "prediction_scores": {
                k: round(v, 6) for k, v in self.prediction_scores.items()
            },
            "alerts": [s.to_json() for s in self.alerts],
            "baseline_uri": self.baseline_uri,
        }


def batch_to_columns(batch: Any) -> Dict[str, np.ndarray]:
    """Foldable 1-D columns of a predict batch.

    Dict batches keep their feature names (2-D single-column arrays
    ravel; wider arrays are skipped — a distribution over flattened
    embedding cells is noise, not a feature).  Raw ndarray batches get
    positional names so raw-mode fleets still monitor.
    """
    cols: Dict[str, np.ndarray] = {}
    if isinstance(batch, Mapping):
        items = list(batch.items())
    else:
        arr = np.asarray(batch)
        if arr.ndim == 1:
            items = [("x", arr)]
        elif arr.ndim == 2:
            items = [(f"x{i}", arr[:, i]) for i in range(min(arr.shape[1], 32))]
        else:
            return cols
    for name, v in items:
        arr = np.asarray(v)
        if arr.ndim == 2 and arr.shape[1] == 1:
            arr = arr.ravel()
        if arr.ndim != 1 or not len(arr):
            continue
        cols[str(name)] = arr
    return cols


def prediction_columns(predictions: Any) -> Dict[str, np.ndarray]:
    """Prediction-output columns: scalar outputs fold directly; logit
    matrices fold as the max score (numeric) + argmax class
    (categorical), the two distributions concept drift moves first."""
    arr = np.asarray(predictions)
    if arr.ndim == 2 and arr.shape[1] == 1:
        arr = arr.ravel()
    if arr.ndim == 1 and len(arr) and arr.dtype != object:
        return {PREDICTION_COLUMN: arr.astype(np.float64, copy=False)}
    if arr.ndim == 2 and arr.shape[0]:
        return {
            PREDICTION_COLUMN: np.max(arr, axis=1).astype(np.float64),
            PREDICTED_CLASS_COLUMN: np.asarray(
                [str(int(i)) for i in np.argmax(arr, axis=1)], dtype=object
            ),
        }
    return {}


def _columns_to_table(cols: Dict[str, np.ndarray]) -> Optional[Table]:
    """The foldable columns as a ``data/examples_io.Table``: numeric and
    ``U`` columns as they are; an object column of strings (``None`` as a
    null) as a ``U`` column with its null mask; any other object column
    skipped, as the reference skips what Arrow cannot type."""
    columns: Dict[str, np.ndarray] = {}
    nulls: Dict[str, np.ndarray] = {}
    for name, arr in cols.items():
        if arr.dtype.kind == "S":
            arr = arr.astype(object)
        if arr.dtype == object:
            values = arr.tolist()
            none = np.asarray([v is None for v in values], bool)
            if not all(isinstance(v, str) for v, n in zip(values, none)
                       if not n):
                continue
            arr = np.asarray(["" if n else v for v, n in zip(values, none)],
                             dtype="U")
            if none.any():
                nulls[name] = none
        columns[name] = arr
    if not columns:
        return None
    return Table(columns, nulls)


def score_statistics(
    current, baseline, *, prefix: str,
    linf_threshold: float, js_threshold: float,
) -> List[DriftScore]:
    """Score every feature of ``current`` against ``baseline`` with the
    ExampleValidator comparators — one algebra, batch and live."""
    from tpu_pipelines_torch.components.example_validator import (
        js_numeric_divergence,
        linf_categorical_distance,
    )

    scores: List[DriftScore] = []
    if baseline is None:
        return scores
    for name in current.features:
        d = linf_categorical_distance(current, baseline, name)
        if d is not None:
            scores.append(DriftScore(
                name, f"{prefix}_linf", float(d), linf_threshold,
            ))
        d = js_numeric_divergence(current, baseline, name)
        if d is not None:
            scores.append(DriftScore(
                name, f"{prefix}_js", float(d), js_threshold,
            ))
    return scores


class TrafficSampler:
    """Rate-bounded sampling of the admitted predict stream into
    tumbling statistics windows, off the request critical path.

    ``offer()`` runs on the fleet's batcher threads: a deterministic
    credit sampler (exactly ``rate`` of offered requests long-run, no
    RNG on the hot path) and a ``put_nowait`` — a full queue counts a
    drop and returns.  Everything else — column conversion, accumulator
    folds, window scoring, metric publication — happens on the single
    ``tpp-drift-sampler`` worker thread (one per fleet, only when
    sampling is enabled).

    One accumulator pair per (model, resident version): the key is the
    leased version string, so a hot-swap opens fresh windows and an old
    version's tail traffic keeps scoring against ITS baseline.
    """

    def __init__(
        self,
        model_name: str,
        *,
        sample_rate: float,
        window_s: float = DEFAULT_WINDOW_S,
        registry=None,
        baseline_for: Optional[Callable[[str], Any]] = None,
        linf_threshold: float = DEFAULT_DRIFT_THRESHOLD,
        js_threshold: float = DEFAULT_DRIFT_THRESHOLD,
        min_samples: int = DEFAULT_MIN_SAMPLES,
        queue_max: int = 256,
        history=None,
        tracer=None,
        on_alert: Optional[Callable[[Dict[str, Any]], Any]] = None,
        on_window: Optional[Callable[[DriftWindow], Any]] = None,
    ):
        if not (0.0 < sample_rate <= 1.0):
            raise ValueError(
                f"sample_rate must be in (0, 1], got {sample_rate}"
            )
        self.model_name = model_name
        self.sample_rate = float(sample_rate)
        self.window_s = max(1e-3, float(window_s))
        self.linf_threshold = float(linf_threshold)
        self.js_threshold = float(js_threshold)
        self.min_samples = int(min_samples)
        self.baseline_for = baseline_for
        self.history = history
        self.tracer = tracer
        self.on_alert = on_alert
        self.on_window = on_window
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_max)
        self._credit = 0.0
        self._credit_lock = threading.Lock()
        # Worker-thread state: per-version (feature acc, prediction acc,
        # sampled rows), previous window stats for the drift comparator,
        # cached baselines.
        self._buckets: Dict[str, Tuple[Any, Any, int]] = {}
        self._prev: Dict[str, Any] = {}
        self._prev_pred: Dict[str, Any] = {}
        self._baselines: Dict[str, Any] = {}
        self._window_index = 0
        self._window_started = time.monotonic()
        self._last_window: Dict[str, DriftWindow] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._init_metrics(registry)

    # ------------------------------------------------------------- metrics

    def _init_metrics(self, registry) -> None:
        if registry is None:
            from tpu_pipelines_torch.observability.metrics import default_registry

            registry = default_registry()
        self.registry = registry
        self._c_sampled = registry.counter(
            "serving_monitor_sampled_total",
            "Predict requests sampled into the live drift monitor.",
            labels=("model",),
        )
        self._c_dropped = registry.counter(
            "serving_monitor_dropped_total",
            "Samples dropped because the monitor queue was full (the "
            "predict path never blocks on the sampler).",
            labels=("model",),
        )
        self._c_windows = registry.counter(
            "serving_monitor_windows_total",
            "Closed (scored) drift windows.",
            labels=("model",),
        )
        self._g_coverage = registry.gauge(
            "serving_monitor_coverage_ratio",
            "Sampled fraction of offered requests over the last closed "
            "window (sample_rate minus queue drops).",
            labels=("model",),
        )
        self._g_distance = registry.gauge(
            "serving_drift_distance",
            "Last closed window's comparator distance per feature: "
            "skew_* vs the training baseline, drift_* vs the previous "
            "live window (same L-inf/JS algebra as ExampleValidator).",
            labels=("model", "feature", "kind"),
        )
        self._g_pred_distance = registry.gauge(
            "serving_prediction_drift_distance",
            "Prediction-output drift vs the previous live window "
            "(js = histogram divergence, linf = class distribution, "
            "mean_shift = std-normalized mean delta).",
            labels=("model", "stat"),
        )
        self._c_alerts = registry.counter(
            "serving_drift_alerts_total",
            "Window scores breaching their threshold, by comparator "
            "family (skew = vs training baseline, drift = vs previous "
            "window).",
            labels=("model", "kind"),
        )
        # Offered counts live on instance state, not a metric family:
        # coverage is published as the ratio gauge above.
        self._offered_window = 0
        self._sampled_window = 0

    # ------------------------------------------------------- critical path

    def offer(self, version: str, batch: Any, predictions: Any) -> bool:
        """Called from the batcher thread after a successful predict.
        Never blocks: samples by deterministic credit, ``put_nowait``s,
        counts drops.  Returns True when the sample was enqueued."""
        with self._credit_lock:
            self._offered_window += 1
            self._credit += self.sample_rate
            if self._credit < 1.0:
                return False
            self._credit -= 1.0
        try:
            self._queue.put_nowait((str(version), batch, predictions))
        except queue.Full:
            self._c_dropped.labels(self.model_name).inc()
            return False
        self._c_sampled.labels(self.model_name).inc()
        with self._credit_lock:
            self._sampled_window += 1
        return True

    # ------------------------------------------------------ worker thread

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            tick = min(0.25, self.window_s / 4.0)
            while not self._stop.is_set():
                self.drain(timeout=tick)
                if time.monotonic() - self._window_started >= self.window_s:
                    try:
                        self.close_window()
                    except Exception:  # noqa: BLE001 — keep sampling alive
                        log.exception("drift window scoring failed")

        self._thread = threading.Thread(
            target=loop, name="tpp-drift-sampler", daemon=True
        )
        self._thread.start()

    def stop(self, flush: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if flush:
            self.drain()
            if any(n for _, _, n in self._buckets.values()):
                try:
                    self.close_window()
                except Exception:  # noqa: BLE001 — best-effort final window
                    log.exception("drift final window scoring failed")

    def drain(self, timeout: float = 0.0) -> int:
        """Fold queued samples into the current window's accumulators.
        Runs on the worker thread (or a test calling it directly)."""
        folded = 0
        while True:
            try:
                item = (
                    self._queue.get(timeout=timeout) if timeout
                    else self._queue.get_nowait()
                )
            except queue.Empty:
                return folded
            timeout = 0.0  # only the first get waits
            self._fold(*item)
            folded += 1

    def _fold(self, version: str, batch: Any, predictions: Any) -> None:
        from tpu_pipelines_torch.data.statistics import SplitStatsAccumulator

        feat_acc, pred_acc, n = self._buckets.get(version) or (
            SplitStatsAccumulator("serving"),
            SplitStatsAccumulator("serving"),
            0,
        )
        rows = 0
        table = _columns_to_table(batch_to_columns(batch))
        if table is not None:
            feat_acc.update(table)
            rows = table.num_rows
        pred_table = _columns_to_table(prediction_columns(predictions))
        if pred_table is not None:
            pred_acc.update(pred_table)
            rows = max(rows, pred_table.num_rows)
        self._buckets[version] = (feat_acc, pred_acc, n + rows)

    # ----------------------------------------------------- window scoring

    def _baseline(self, version: str):
        """(stats, uri) of the version's training baseline, cached.
        ``baseline_for`` may return stats alone or a ``(stats, uri)``
        pair; an unreadable baseline disables skew scoring for the
        version (drift-vs-previous-window still runs), never serving."""
        if version not in self._baselines:
            baseline, uri = None, ""
            if self.baseline_for is not None:
                try:
                    res = self.baseline_for(version)
                    if isinstance(res, tuple):
                        baseline, uri = res
                    else:
                        baseline = res
                except Exception:  # noqa: BLE001
                    log.exception(
                        "drift baseline resolution failed for version %s",
                        version,
                    )
            self._baselines[version] = (baseline, uri)
        return self._baselines[version]

    def close_window(self) -> List[DriftWindow]:
        """Close the current tumbling window: finalize, score, publish.
        Empty windows (no sampled rows) reset the clock and publish
        nothing."""
        self.drain()
        buckets, self._buckets = self._buckets, {}
        self._window_started = time.monotonic()
        with self._credit_lock:
            offered, self._offered_window = self._offered_window, 0
            sampled, self._sampled_window = self._sampled_window, 0
        if offered:
            self._g_coverage.labels(self.model_name).set(
                round(sampled / offered, 4)
            )
        windows: List[DriftWindow] = []
        for version, (feat_acc, pred_acc, n) in buckets.items():
            if not n:
                continue
            self._window_index += 1
            current = feat_acc.finalize()
            pred_stats = pred_acc.finalize()
            baseline, baseline_uri = self._baseline(version)
            scores = score_statistics(
                current, baseline, prefix="skew",
                linf_threshold=self.linf_threshold,
                js_threshold=self.js_threshold,
            )
            scores.extend(score_statistics(
                current, self._prev.get(version), prefix="drift",
                linf_threshold=self.linf_threshold,
                js_threshold=self.js_threshold,
            ))
            pred_scores = self._score_predictions(
                pred_stats, self._prev_pred.get(version)
            )
            self._prev[version] = current
            self._prev_pred[version] = pred_stats
            window = DriftWindow(
                model=self.model_name, version=version,
                index=self._window_index, sampled=n,
                scores=scores, prediction_scores=pred_scores,
                statistics=current,
                baseline_uri=baseline_uri,
            )
            self._publish(window)
            windows.append(window)
            self._last_window[version] = window
        return windows

    def _score_predictions(self, current, prev) -> Dict[str, float]:
        from tpu_pipelines_torch.components.example_validator import (
            js_numeric_divergence,
            linf_categorical_distance,
        )

        out: Dict[str, float] = {}
        if current is None or prev is None:
            return out
        d = js_numeric_divergence(current, prev, PREDICTION_COLUMN)
        if d is not None:
            out["js"] = float(d)
        d = linf_categorical_distance(current, prev, PREDICTED_CLASS_COLUMN)
        if d is not None:
            out["linf"] = float(d)
        cur_f = current.features.get(PREDICTION_COLUMN)
        prev_f = prev.features.get(PREDICTION_COLUMN)
        if cur_f and prev_f and cur_f.numeric and prev_f.numeric:
            out["mean_shift"] = abs(
                cur_f.numeric.mean - prev_f.numeric.mean
            ) / (prev_f.numeric.std_dev or 1.0)
        return out

    def _publish(self, window: DriftWindow) -> None:
        self._c_windows.labels(self.model_name).inc()
        for s in window.scores:
            self._g_distance.labels(
                self.model_name, s.feature, s.kind
            ).set(round(s.distance, 6))
        for stat, v in window.prediction_scores.items():
            self._g_pred_distance.labels(self.model_name, stat).set(
                round(v, 6)
            )
        if self.history is not None:
            try:
                self.history.append(
                    self.registry,
                    run_id=f"serving-{self.model_name}",
                    step=window.index,
                    labels={"version": window.version},
                )
            except OSError:
                log.exception("drift window history append failed")
        alerts = window.alerts
        if window.sampled < self.min_samples:
            alerts = []          # thin window: score, never page
        by_family: Dict[str, List[DriftScore]] = {}
        for s in alerts:
            by_family.setdefault(s.kind.split("_")[0], []).append(s)
        for family, scores in by_family.items():
            self._c_alerts.labels(self.model_name, family).inc()
            worst = max(scores, key=lambda s: s.distance / s.threshold)
            info = {
                "slo": "drift",
                "model": self.model_name,
                "version": window.version,
                "kind": family,
                "feature": worst.feature,
                "distance": round(worst.distance, 6),
                "threshold": worst.threshold,
                "window": window.index,
                "sampled": window.sampled,
            }
            log.warning(
                "live %s alert: %s feature %r distance %.4f > %.2f "
                "(window %d, %d samples)",
                family, self.model_name, worst.feature, worst.distance,
                worst.threshold, window.index, window.sampled,
            )
            if self.tracer is not None:
                self.tracer.instant("drift/alert", **info)
            else:
                _trace.instant("drift/alert", cat="drift", args=info)
            if self.on_alert is not None:
                try:
                    self.on_alert(dict(
                        info,
                        evidence=window.to_json(),
                    ))
                except Exception:  # noqa: BLE001 — a broken consumer must
                    # not kill the sampling loop; the alert is counted.
                    log.exception("drift on_alert callback failed")
        if self.on_window is not None:
            try:
                self.on_window(window)
            except Exception:  # noqa: BLE001
                log.exception("drift on_window callback failed")

    # -------------------------------------------------------------- status

    def summary(self) -> Dict[str, Any]:
        """Health-endpoint view: last closed window per resident version."""
        return {
            "sample_rate": self.sample_rate,
            "window_s": self.window_s,
            "windows": self._window_index,
            "queue_depth": self._queue.qsize(),
            "last_window": {
                v: w.to_json() for v, w in self._last_window.items()
            },
        }


# ------------------------------------------------------------ CLI report


_PROM_LINE = re.compile(
    r"^([a-z_][a-z0-9_]*)(?:\{([^}]*)\})? (\S+)$", re.M
)


def parse_drift_scrape(text: str) -> Dict[str, Any]:
    """Drift-plane families out of a Prometheus text exposition (what the
    CLI's ``drift`` reads)."""
    report: Dict[str, Any] = {
        "distances": [], "prediction": [], "alerts_total": 0.0,
        "sampled_total": 0.0, "dropped_total": 0.0, "windows_total": 0.0,
        "coverage_ratio": None, "max_distance": 0.0, "max_skew": 0.0,
    }
    for m in _PROM_LINE.finditer(text):
        name, raw_labels, raw_value = m.groups()
        if not name.startswith(("serving_drift", "serving_monitor",
                                "serving_prediction_drift")):
            continue
        try:
            value = float(raw_value)
        except ValueError:
            continue
        labels = dict(re.findall(r'(\w+)="([^"]*)"', raw_labels or ""))
        if name == "serving_drift_distance":
            report["distances"].append({**labels, "distance": value})
            report["max_distance"] = max(report["max_distance"], value)
            if labels.get("kind", "").startswith("skew"):
                report["max_skew"] = max(report["max_skew"], value)
        elif name == "serving_prediction_drift_distance":
            report["prediction"].append({**labels, "distance": value})
        elif name == "serving_drift_alerts_total":
            report["alerts_total"] += value
        elif name == "serving_monitor_sampled_total":
            report["sampled_total"] += value
        elif name == "serving_monitor_dropped_total":
            report["dropped_total"] += value
        elif name == "serving_monitor_windows_total":
            report["windows_total"] += value
        elif name == "serving_monitor_coverage_ratio":
            report["coverage_ratio"] = value
    return report


def format_drift_report(report: Dict[str, Any]) -> str:
    lines = [
        f"sampled={int(report['sampled_total'])} "
        f"dropped={int(report['dropped_total'])} "
        f"windows={int(report['windows_total'])} "
        f"coverage={report['coverage_ratio']} "
        f"alerts={int(report['alerts_total'])}"
    ]
    rows = sorted(
        report["distances"],
        key=lambda r: -r["distance"],
    )
    if rows:
        lines.append(f"{'feature':<24} {'kind':<12} distance")
        for r in rows:
            lines.append(
                f"{r.get('feature', ''):<24} {r.get('kind', ''):<12} "
                f"{r['distance']:.4f}"
            )
    for r in sorted(report["prediction"], key=lambda r: -r["distance"]):
        lines.append(
            f"{'<prediction>':<24} {r.get('stat', ''):<12} "
            f"{r['distance']:.4f}"
        )
    if not rows and not report["prediction"]:
        lines.append("no drift windows scored yet (monitor off or warming)")
    return "\n".join(lines)
