"""SLO burn-rate monitoring over the in-process metrics registry.

The port's copy of ``tpu_pipelines/observability/slo.py``.
:class:`SLOMonitor` evaluates multi-window **burn rates** (Google SRE
workbook style) over the registry's own histograms and counters and fires a
breach callback the fleet answers with a probation rollback
(``ServingFleet.on_slo_breach``).

Burn rate = (observed bad fraction over a window) / (the SLO's error
budget fraction).  1.0 means "spending budget exactly at the sustainable
rate"; 14.4 over an hour burns 2%% of a 30-day budget (the workbook's
page-now threshold).  A breach needs BOTH fast windows (default 1m+5m)
over ``fast_threshold`` — the short window proves the burn is happening
*now*, the longer one that it is not a blip — or the slow window
(default 30m) over ``slow_threshold``.

Watched SLOs (all read from the registry the serving stack already
publishes into; nothing new is instrumented):

  ==================  ==================================================
  slo label           bad / total
  ==================  ==================================================
  latency_p99         ``serving_request_latency_seconds`` observations
                      above ``slo_p99_s`` / all observations (budget:
                      1 - latency_target, default 1%%)
  errors_5xx          ``serving_requests_total{code=5xx}`` / all
                      (budget: 1 - availability_target, default 0.1%%)
  shed                ``serving_load_shed_total`` / all requests
                      (budget: ``max_shed_ratio``, default 5%%)
  compiles_after_warm ``serving_decode_compiles_after_warm_total`` delta
                      (budget zero: any capture after warm-up inside a
                      window is a breach — the warm() contract broke)
  drift               max ``serving_drift_distance`` reading inside the
                      window vs ``drift_threshold`` (observability/
                      drift.py's live plane; only when ``drift_threshold
                      > 0`` and the window sampled ``min_events`` rows)
  ==================  ==================================================

Zero footprint when unwired: the monitor only exists when explicitly
constructed (``ModelServer(slo_monitor_interval_s=...)`` / env
``TPP_SLO_MONITOR``).  When wired it publishes
``serving_slo_burn_rate{window,slo}`` gauges and
``serving_slo_breaches_total{slo}``, and emits a ``slo/burn_alert``
instant into the active run trace (``observability/trace.py``; the
reference's request tracer is ``ROADMAP.md`` A8b).

Bucket-boundary honesty: "above ``slo_p99_s``" is judged from cumulative
histogram buckets, so observations between the SLO and the enclosing
bucket's upper bound count as good — the monitor under-counts badness by
at most one bucket's width.  Alerts are therefore conservative, never
noisy.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from tpu_pipelines_torch.observability import trace as _trace

log = logging.getLogger("tpu_pipelines_torch.observability")

ENV_SLO_MONITOR = "TPP_SLO_MONITOR"   # seconds between evaluations; unset=off

# SRE-workbook thresholds: 14.4 = 2% of a 30-day budget per hour (page),
# 6 = 5% per 6 hours (ticket).  The windows here are shorter than the
# workbook's (1m/5m fast, 30m slow) because a serving fleet's probation
# rollback must fire within the post-swap window, not within hours.
DEFAULT_WINDOWS_S = (60.0, 300.0, 1800.0)
DEFAULT_FAST_WINDOWS_S = (60.0, 300.0)
DEFAULT_FAST_THRESHOLD = 14.4
DEFAULT_SLOW_THRESHOLD = 6.0


def _hist_totals(
    series: Dict[Any, Any], bounds: Sequence[float], slo_s: float
) -> Tuple[int, int]:
    """(total observations, observations above slo_s) summed over every
    label combination of one histogram snapshot."""
    total = 0
    bad = 0
    # First bucket whose upper bound covers the SLO: everything beyond
    # its cumulative count is certainly over budget.
    idx = len(bounds)
    for i, b in enumerate(bounds):
        if b >= slo_s:
            idx = i
            break
    for state in series.values():
        buckets = state["buckets"]
        count = int(state["count"])
        good = sum(int(n) for n in buckets[: idx + 1])
        total += count
        bad += max(0, count - good)
    return total, bad


class SLOMonitor:
    """Multi-window burn rates over a :class:`MetricsRegistry`.

    ``evaluate()`` is the whole engine (tests call it directly with a
    controlled clock); ``start(interval_s)`` runs it
    on a daemon thread.  ``on_breach(info)`` fires edge-triggered per
    SLO: once on the rising edge, re-armed when every window of that SLO
    falls back under half its threshold.
    """

    def __init__(
        self,
        registry,
        *,
        slo_p99_s: float = 0.0,
        latency_target: float = 0.99,
        availability_target: float = 0.999,
        max_shed_ratio: float = 0.05,
        drift_threshold: float = 0.0,
        windows_s: Sequence[float] = DEFAULT_WINDOWS_S,
        fast_windows_s: Sequence[float] = DEFAULT_FAST_WINDOWS_S,
        fast_threshold: float = DEFAULT_FAST_THRESHOLD,
        slow_threshold: float = DEFAULT_SLOW_THRESHOLD,
        min_events: int = 20,
        on_breach: Optional[Callable[[Dict[str, Any]], Any]] = None,
    ):
        self.registry = registry
        self.slo_p99_s = max(0.0, float(slo_p99_s))
        self.latency_target = float(latency_target)
        self.availability_target = float(availability_target)
        self.max_shed_ratio = float(max_shed_ratio)
        self.drift_threshold = max(0.0, float(drift_threshold))
        self.windows_s = tuple(sorted(float(w) for w in windows_s))
        self.fast_windows_s = tuple(sorted(float(w) for w in fast_windows_s))
        self.fast_threshold = float(fast_threshold)
        self.slow_threshold = float(slow_threshold)
        self.min_events = int(min_events)
        self.on_breach = on_breach
        # (mono_ts, snapshot) ring pruned past the slowest window; at a
        # few-second cadence this is dozens of small dicts, bounded.
        self._snaps: "collections.deque" = collections.deque()
        self._lock = threading.Lock()
        self._alerting: Dict[str, bool] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._m_burn = registry.gauge(
            "serving_slo_burn_rate",
            "Error-budget burn rate per evaluation window and SLO "
            "(1.0 = spending budget exactly at the sustainable rate).",
            labels=("window", "slo"),
        )
        self._m_breaches = registry.counter(
            "serving_slo_breaches_total",
            "Multi-window burn-rate breaches (edge-triggered per SLO).",
            labels=("slo",),
        )

    # ------------------------------------------------------------ snapshot

    def _collect(self) -> Dict[str, Any]:
        """One cumulative reading of everything the burn math needs.
        Reads the public registry snapshot — no private metric state."""
        snap = self.registry.snapshot()

        def series(name):
            payload = snap.get(name)
            return payload["series"] if payload else {}

        lat_total = lat_bad = 0
        if self.slo_p99_s > 0:
            payload = snap.get("serving_request_latency_seconds")
            if payload:
                lat_total, lat_bad = _hist_totals(
                    payload["series"], payload.get("buckets") or (),
                    self.slo_p99_s,
                )
        req_total = 0
        err_5xx = 0
        for key, v in series("serving_requests_total").items():
            # key = (endpoint, code); management/scrape endpoints do not
            # consume request budget.
            endpoint = key[0] if key else ""
            if endpoint in ("metrics", "healthz", "status", "other"):
                continue
            req_total += int(v)
            if str(key[1] if len(key) > 1 else "").startswith("5"):
                err_5xx += int(v)
        shed = sum(int(v) for v in series("serving_load_shed_total").values())
        compiles = sum(
            int(v)
            for v in series(
                "serving_decode_compiles_after_warm_total"
            ).values()
        )
        # Decode-speed lever counters (informational, not burn inputs; the
        # levers themselves are ROADMAP.md A8b, so these read 0 until then):
        # windowed deltas of prefix hits and speculative acceptance, as
        # the reference's evaluate() table carries them.
        prefix_hits = sum(
            int(v) for v in series("serving_decode_prefix_hit_total").values()
        )
        prefix_misses = sum(
            int(v)
            for v in series("serving_decode_prefix_miss_total").values()
        )
        spec_proposed = sum(
            int(v)
            for v in series("serving_decode_spec_proposed_total").values()
        )
        spec_accepted = sum(
            int(v)
            for v in series("serving_decode_spec_accept_total").values()
        )
        # Live drift plane (observability/drift.py): the burn input is
        # the worst per-feature distance gauge, paired with the sampled
        # counter so the min-events guard applies to SAMPLED rows.
        drift_vals = [
            float(v) for v in series("serving_drift_distance").values()
        ]
        monitor_sampled = sum(
            int(v)
            for v in series("serving_monitor_sampled_total").values()
        )
        return {
            "lat_total": lat_total, "lat_bad": lat_bad,  # tpp: disable=TPP214 (dict key)
            "req_total": req_total, "err_5xx": err_5xx,  # tpp: disable=TPP214 (dict key)
            "shed": shed, "compiles": compiles,
            "prefix_hits": prefix_hits, "prefix_misses": prefix_misses,
            "spec_proposed": spec_proposed, "spec_accepted": spec_accepted,
            "drift_distance": max(drift_vals) if drift_vals else 0.0,
            "monitor_sampled": monitor_sampled,
        }

    # ------------------------------------------------------------ evaluate

    @staticmethod
    def _burn(bad: int, total: int, budget: float) -> Optional[float]:
        if total <= 0 or budget <= 0:
            return None
        return (bad / total) / budget

    def _window_delta(
        self, now: float, window_s: float, cur: Dict[str, Any]
    ) -> Tuple[Dict[str, int], float]:
        """Counter deltas between now and the snapshot nearest to
        ``now - window_s`` (the oldest one inside the window, so a young
        monitor reports over the data it actually has)."""
        base = None
        span = 0.0
        for ts, snap in self._snaps:
            if ts <= now - window_s:
                base, span = snap, now - ts
            else:
                if base is None:
                    base, span = snap, now - ts
                break
        if base is None:
            base, span = cur, 0.0
        return {k: cur[k] - base.get(k, 0) for k in cur}, span

    def _window_max(
        self, now: float, window_s: float, cur: Dict[str, Any], key: str
    ) -> float:
        """Largest reading of a GAUGE key across the window (deltas are
        meaningless for level signals like the drift distance — a spike
        that decays before evaluation must still count)."""
        worst = float(cur.get(key, 0.0))
        for ts, snap in self._snaps:
            if ts >= now - window_s:
                worst = max(worst, float(snap.get(key, 0.0)))
        return worst

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One evaluation pass: collect, compute every (window, slo)
        burn rate, publish gauges, fire edge-triggered breaches.
        Returns the full result table."""
        now = time.monotonic() if now is None else float(now)
        cur = self._collect()
        with self._lock:
            result: Dict[str, Any] = {"windows": {}, "breaches": []}
            rates_by_slo: Dict[str, Dict[float, Optional[float]]] = {}
            for window in self.windows_s:
                delta, span = self._window_delta(now, window, cur)
                rates: Dict[str, Optional[float]] = {}
                if delta["lat_total"] >= self.min_events:  # tpp: disable=TPP214 (dict key)
                    rates["latency_p99"] = self._burn(
                        delta["lat_bad"], delta["lat_total"],  # tpp: disable=TPP214 (dict key)
                        1.0 - self.latency_target,
                    )
                if delta["req_total"] >= self.min_events:  # tpp: disable=TPP214 (dict key)
                    rates["errors_5xx"] = self._burn(
                        delta["err_5xx"], delta["req_total"],  # tpp: disable=TPP214 (dict key)
                        1.0 - self.availability_target,
                    )
                    rates["shed"] = self._burn(
                        delta["shed"], delta["req_total"],  # tpp: disable=TPP214 (dict key)
                        self.max_shed_ratio,
                    )
                # Budget zero: the raw post-warm compile count IS the
                # burn signal (any positive value breaches).
                rates["compiles_after_warm"] = (
                    float(delta["compiles"]) * self.fast_threshold
                    if delta["compiles"] > 0 else 0.0
                )
                # Drift: a level signal, scaled so distance == threshold
                # lands exactly on the page line (the budget-zero idiom
                # above, but proportional — a 2x-threshold excursion
                # burns twice as hot).  Gated on sampled rows so a
                # near-empty window can't page.
                if (
                    self.drift_threshold > 0
                    and delta["monitor_sampled"] >= self.min_events
                ):
                    dmax = self._window_max(
                        now, window, cur, "drift_distance"
                    )
                    rates["drift"] = (
                        (dmax / self.drift_threshold) * self.fast_threshold
                        if dmax >= self.drift_threshold else 0.0
                    )
                result["windows"][window] = {
                    "span_s": round(span, 3), "delta": delta,
                    "burn": rates,
                }
                label = str(int(window))
                for slo, rate in rates.items():
                    if rate is not None:
                        self._m_burn.labels(label, slo).set(round(rate, 4))
                    rates_by_slo.setdefault(slo, {})[window] = rate
            breaches = self._detect(rates_by_slo)
            result["breaches"] = breaches
            # Record BEFORE firing callbacks so a callback reading the
            # registry (or re-evaluating) sees consistent history.
            self._snaps.append((now, cur))
            horizon = now - (self.windows_s[-1] * 1.5 + 60.0)
            while self._snaps and self._snaps[0][0] < horizon:
                self._snaps.popleft()
        for breach in breaches:
            self._fire(breach)
        return result

    def _detect(
        self, rates_by_slo: Dict[str, Dict[float, Optional[float]]]
    ) -> List[Dict[str, Any]]:
        breaches = []
        for slo, per_window in rates_by_slo.items():
            fast = [
                per_window.get(w) for w in self.fast_windows_s
                if w in per_window
            ]
            slow = [
                per_window.get(w) for w in self.windows_s
                if w not in self.fast_windows_s and w in per_window
            ]
            fast_hit = bool(fast) and all(
                r is not None and r >= self.fast_threshold for r in fast
            )
            slow_hit = any(
                r is not None and r >= self.slow_threshold for r in slow
            )
            over = fast_hit or slow_hit
            was = self._alerting.get(slo, False)
            if over and not was:
                self._alerting[slo] = True
                breaches.append({
                    "slo": slo,
                    "trigger": "fast" if fast_hit else "slow",
                    "burn": {
                        str(int(w)): (round(r, 3) if r is not None else None)
                        for w, r in per_window.items()
                    },
                })
            elif not over and was:
                # Re-arm only once every window cooled to half threshold:
                # a rate oscillating around the line alerts once, not
                # per evaluation.
                rates = [r for r in per_window.values() if r is not None]
                if all(r < self.fast_threshold / 2 for r in rates):
                    self._alerting[slo] = False
        return breaches

    def _fire(self, breach: Dict[str, Any]) -> None:
        self._m_breaches.labels(breach["slo"]).inc()
        log.warning(
            "SLO burn-rate breach: %s (%s windows) burn=%s",
            breach["slo"], breach["trigger"], breach["burn"],
        )
        _trace.instant("slo/burn_alert", cat="slo", args=breach)
        if self.on_breach is not None:
            try:
                self.on_breach(breach)
            except Exception:  # noqa: BLE001 — a broken policy must not
                # kill the monitor loop; the breach is already counted.
                log.exception("on_slo_breach callback failed")

    # ----------------------------------------------------------- lifecycle

    def start(self, interval_s: float = 5.0) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.evaluate()
                except Exception:  # noqa: BLE001 — keep the watchdog alive
                    log.exception("SLO evaluation failed")

        self._thread = threading.Thread(
            target=loop, name="tpp-slo-monitor", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
