"""Durable metrics history: a crash-safe snapshot ring under the run root.

The port of ``tpu_pipelines/observability/metrics_history.py``.  Registry
snapshots persist as an append-only ring:

    <pipeline_root>/.runs/_metrics/<run_id>/snap-00000042.json

Each file is one :func:`atomic_write_json`; readers use
``load_json_tolerant`` and skip anything torn.  Retention is bounded per run
(``TPP_METRICS_HISTORY_KEEP``, default 128): after every append the oldest
files past ``keep`` are deleted.  The query API (``entries``, ``series``,
``run_delta``, ``merged_registry``, ``headline``) reads the files with no
live process.  The format is the reference's, so either package reads the
other's ring.

Nothing writes unless ``TPP_METRICS_HISTORY`` is set: no ``_metrics/``
directory, no files.  Reading works on any existing ring.
"""

from __future__ import annotations

import os
import re
import time
from typing import Any, Dict, List, Optional, Tuple

from tpu_pipelines_torch.observability.federation import (
    decode_snapshot,
    encode_snapshot,
)
from tpu_pipelines_torch.observability.metrics import MetricsRegistry
from tpu_pipelines_torch.robustness.atomic import (
    atomic_write_json,
    load_json_tolerant,
)

__all__ = [
    "ENV_METRICS_HISTORY",
    "ENV_METRICS_HISTORY_KEEP",
    "DEFAULT_KEEP",
    "MetricsHistory",
    "history_enabled",
    "metrics_history_root",
    "snapshot_value",
]

# Opt-in: any non-empty value enables the ring.
ENV_METRICS_HISTORY = "TPP_METRICS_HISTORY"
# Per-run retention (snapshots kept); oldest beyond this are deleted.
ENV_METRICS_HISTORY_KEEP = "TPP_METRICS_HISTORY_KEEP"
DEFAULT_KEEP = 128

_SNAP_RE = re.compile(r"snap-(\d{8})\.json\Z")
_RUN_SAFE_RE = re.compile(r"[^A-Za-z0-9._-]+")


def history_enabled() -> bool:
    return bool(os.environ.get(ENV_METRICS_HISTORY, "").strip())


def metrics_history_root(pipeline_root: str) -> str:
    """Where a pipeline's ring lives (exists only once something wrote)."""
    return os.path.join(pipeline_root, ".runs", "_metrics")


def snapshot_value(
    snapshot: Dict[str, Any],
    metric: str,
    labels: Optional[Dict[str, str]] = None,
) -> Optional[float]:
    """One number out of a decoded snapshot: the sum over every series
    of ``metric`` whose label values match ``labels`` (a subset match
    on the declared label names).  Histograms read as their ``count``.
    None when the metric (or a matching series) is absent."""
    payload = snapshot.get(metric)
    if payload is None:
        return None
    names = tuple(payload["labels"])
    total = 0.0
    found = False
    for key, value in payload["series"].items():
        if labels:
            bound = dict(zip(names, key))
            if any(bound.get(k) != str(v) for k, v in labels.items()):
                continue
        found = True
        if payload["type"] == "histogram":
            total += float(value["count"])
        else:
            total += float(value)
    return total if found else None


class MetricsHistory:
    """Append/query interface over one pipeline's snapshot ring."""

    def __init__(self, root_dir: str, keep: int = DEFAULT_KEEP):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.root_dir = root_dir
        self.keep = keep

    @classmethod
    def for_pipeline_root(
        cls, pipeline_root: str, keep: Optional[int] = None
    ) -> "MetricsHistory":
        if keep is None:
            env = os.environ.get(ENV_METRICS_HISTORY_KEEP, "").strip()
            keep = int(env) if env else DEFAULT_KEEP
        return cls(metrics_history_root(pipeline_root), keep=keep)

    @classmethod
    def from_env(cls, pipeline_root: str) -> Optional["MetricsHistory"]:
        """The writer-side constructor: None unless the env opts in —
        the zero-footprint gate every publisher goes through."""
        if not history_enabled():
            return None
        return cls.for_pipeline_root(pipeline_root)

    # ------------------------------------------------------------ write

    def _run_dir(self, run_id: str) -> str:
        return os.path.join(
            self.root_dir, _RUN_SAFE_RE.sub("_", str(run_id)) or "run"
        )

    def append(
        self,
        registry_or_snapshot: Any,
        run_id: str,
        step: Optional[int] = None,
        labels: Optional[Dict[str, str]] = None,
    ) -> str:
        """Persist one snapshot for ``run_id`` and enforce retention.
        Accepts a registry (or anything with ``.snapshot()``) or an
        already-taken snapshot dict.  Returns the path written."""
        snap = (
            registry_or_snapshot.snapshot()
            if hasattr(registry_or_snapshot, "snapshot")
            else registry_or_snapshot
        )
        run_dir = self._run_dir(run_id)
        os.makedirs(run_dir, exist_ok=True)
        seqs = self._seqs(run_dir)
        seq = (seqs[-1][0] + 1) if seqs else 0
        path = os.path.join(run_dir, f"snap-{seq:08d}.json")
        atomic_write_json(
            path,
            {
                "version": 1,
                "run_id": str(run_id),
                "seq": seq,
                "step": step,
                "unix_time": time.time(),
                "labels": dict(labels or {}),
                "snapshot": encode_snapshot(snap),
            },
        )
        for _seq, old_name in seqs[: max(0, len(seqs) + 1 - self.keep)]:
            try:
                os.unlink(os.path.join(run_dir, old_name))
            except OSError:
                pass  # concurrent reaper; retention is best-effort
        return path

    # ------------------------------------------------------------- read

    @staticmethod
    def _seqs(run_dir: str) -> List[Tuple[int, str]]:
        try:
            names = os.listdir(run_dir)
        except OSError:
            return []
        out = []
        for name in names:
            m = _SNAP_RE.match(name)
            if m:
                out.append((int(m.group(1)), name))
        return sorted(out)

    def runs(self) -> List[str]:
        """Run ids with at least one snapshot, oldest ring first."""
        try:
            names = os.listdir(self.root_dir)
        except OSError:
            return []
        return sorted(
            n for n in names
            if self._seqs(os.path.join(self.root_dir, n))
        )

    def entries(
        self,
        run_id: str,
        t_start: Optional[float] = None,
        t_end: Optional[float] = None,
    ) -> List[Dict[str, Any]]:
        """Decoded payloads for ``run_id`` in sequence order, optionally
        clipped to a ``[t_start, t_end]`` unix-time window.  Torn or
        foreign files are skipped, never raised on."""
        run_dir = self._run_dir(run_id)
        out: List[Dict[str, Any]] = []
        for _seq, name in self._seqs(run_dir):
            payload = load_json_tolerant(os.path.join(run_dir, name))
            if not isinstance(payload, dict) or "snapshot" not in payload:
                continue
            t = float(payload.get("unix_time", 0.0))
            if t_start is not None and t < t_start:
                continue
            if t_end is not None and t > t_end:
                continue
            payload = dict(payload)
            payload["snapshot"] = decode_snapshot(payload["snapshot"])
            out.append(payload)
        return out

    def latest(self, run_id: str) -> Optional[Dict[str, Any]]:
        entries = self.entries(run_id)
        return entries[-1] if entries else None

    def series(
        self,
        run_id: str,
        metric: str,
        labels: Optional[Dict[str, str]] = None,
        t_start: Optional[float] = None,
        t_end: Optional[float] = None,
    ) -> List[Dict[str, Any]]:
        """One metric over time: ``{unix_time, step, value}`` rows (label-
        filtered via :func:`snapshot_value`), rows where the metric is
        absent skipped — the replayable input to a Tuner/Rewriter loop."""
        rows = []
        for entry in self.entries(run_id, t_start=t_start, t_end=t_end):
            value = snapshot_value(entry["snapshot"], metric, labels)
            if value is None:
                continue
            rows.append(
                {
                    "unix_time": entry.get("unix_time"),
                    "step": entry.get("step"),
                    "value": value,
                }
            )
        return rows

    def run_delta(
        self,
        run_a: str,
        run_b: str,
        metrics: Optional[List[str]] = None,
    ) -> Dict[str, Dict[str, Optional[float]]]:
        """Cross-run comparison from each run's LATEST snapshot: metric
        -> {a, b, delta} (delta None when either side is absent).  With
        ``metrics=None``, every metric either run recorded is compared."""
        last_a = self.latest(run_a)
        last_b = self.latest(run_b)
        snap_a = last_a["snapshot"] if last_a else {}
        snap_b = last_b["snapshot"] if last_b else {}
        names = metrics or sorted(set(snap_a) | set(snap_b))
        out: Dict[str, Dict[str, Optional[float]]] = {}
        for name in names:
            a = snapshot_value(snap_a, name)
            b = snapshot_value(snap_b, name)
            out[name] = {
                "a": a,
                "b": b,
                "delta": (b - a) if a is not None and b is not None
                else None,
            }
        return out

    def merged_registry(self, run_id: str) -> Optional[MetricsRegistry]:
        """The latest snapshot rehydrated into a registry (scrapeable /
        diffable offline)."""
        last = self.latest(run_id)
        if last is None:
            return None
        reg = MetricsRegistry()
        reg.merge(last["snapshot"])
        return reg

    # ------------------------------------------------- trace-diff bridge

    def headline(self, run_id: str) -> Dict[str, Any]:
        """The scrape-derived headline numbers ``trace diff`` compares:
        window-phase shares, compile-after-warm count, MFU, and peak
        device memory, read from the run's latest snapshot.  Keys are
        present only when the run recorded them."""
        last = self.latest(run_id)
        if last is None:
            return {}
        snap = last["snapshot"]
        out: Dict[str, Any] = {}
        phases: Dict[str, float] = {}
        payload = snap.get("train_window_time_seconds")
        if payload and payload["type"] == "counter":
            names = tuple(payload["labels"])
            for key, value in payload["series"].items():
                phase = dict(zip(names, key)).get("phase", "?")
                phases[phase] = phases.get(phase, 0.0) + float(value)
        total = sum(phases.values())
        if total > 0:
            out["window_phase_seconds"] = phases
            out["infeed_wait_share"] = (
                phases.get("infeed_wait", 0.0) / total
            )
        for key, metric in (
            ("compiles_after_warm", "train_compiles_after_warm_total"),
            ("mfu", "train_mfu"),
            ("steps", "train_steps_total"),
        ):
            value = snapshot_value(snap, metric)
            if value is not None:
                out[key] = value
        mem = snap.get("device_memory_peak_bytes")
        if mem and mem["series"]:
            out["device_memory_peak_bytes"] = max(
                float(v) for v in mem["series"].values()
            )
        return out
