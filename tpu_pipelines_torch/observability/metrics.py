"""Live telemetry: a dependency-free metrics registry + Prometheus text.

The port's copy of ``Counter``, ``Gauge``, ``Histogram`` and
``MetricsRegistry`` from ``tpu_pipelines/observability/metrics.py``: what
the model server's ``GET /metrics`` route, the micro-batcher and the train
loop publish (the loop into :func:`default_registry`).
Stdlib only; one registry lock serializes every update and the
exposition snapshot; exposition follows the Prometheus text format
v0.0.4.  The standalone metrics server, fork-pool snapshot/merge and
federation wait for later slices.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "latency_buckets",
]

CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"


def latency_buckets(
    start_s: float = 1e-4, factor: float = 2.0, count: int = 18
) -> List[float]:
    """Fixed log-spaced latency buckets: 100µs … ~13s at factor 2.

    Log spacing keeps relative quantile error constant across four
    decades — the serving path cares about 1ms as much as 1s — and a
    FIXED ladder means two runs' histograms are always mergeable and
    diffable bucket-by-bucket.
    """
    return [round(start_s * factor**i, 10) for i in range(count)]


def _validate_name(name: str) -> str:
    if not name or not all(c.isalnum() or c in "_:" for c in name):
        raise ValueError(f"invalid metric name {name!r}")
    if name[0].isdigit():
        raise ValueError(f"invalid metric name {name!r}")
    return name


def _escape_label_value(v: Any) -> str:
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if isinstance(v, float) and v != v:  # NaN
        return "NaN"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class _Metric:
    """One named metric family: label-keyed series behind the registry
    lock.  Series keys are tuples of label VALUES in declared order."""

    type_name = ""

    def __init__(
        self,
        name: str,
        help_text: str,
        label_names: Tuple[str, ...],
        lock: threading.Lock,
    ):
        self.name = _validate_name(name)
        self.help_text = help_text
        self.label_names = label_names
        self._lock = lock
        self._series: Dict[Tuple[str, ...], Any] = {}

    # -- label plumbing ---------------------------------------------------

    def labels(self, *values: Any, **kv: Any) -> "_Bound":
        if kv:
            if values:
                raise ValueError("pass label values OR keywords, not both")
            try:
                values = tuple(kv[n] for n in self.label_names)
            except KeyError as e:
                raise ValueError(
                    f"{self.name}: missing label {e} "
                    f"(declared: {self.label_names})"
                ) from None
            if len(kv) != len(self.label_names):
                extra = set(kv) - set(self.label_names)
                raise ValueError(f"{self.name}: unknown labels {extra}")
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: needs {len(self.label_names)} label "
                f"value(s) {self.label_names}, got {len(values)}"
            )
        return _Bound(self, tuple(str(v) for v in values))

    def _key(self) -> Tuple[str, ...]:
        if self.label_names:
            raise ValueError(
                f"{self.name} declares labels {self.label_names}; "
                "use .labels(...)"
            )
        return ()

    def _samples(self) -> List[Tuple[str, Dict[str, str], float]]:
        """(suffix, labels, value) rows for exposition."""
        raise NotImplementedError


class _Bound:
    """A metric bound to concrete label values."""

    __slots__ = ("_metric", "_key_values")

    def __init__(self, metric: _Metric, key: Tuple[str, ...]):
        self._metric = metric
        self._key_values = key

    def inc(self, amount: float = 1.0) -> None:
        self._metric._inc(self._key_values, amount)

    def set(self, value: float) -> None:
        self._metric._set(self._key_values, value)

    def observe(self, value: float) -> None:
        self._metric._observe(self._key_values, value)

    def get(self) -> float:
        return self._metric._get(self._key_values)


class Counter(_Metric):
    """Monotonically increasing count (resets only with the process)."""

    type_name = "counter"

    def inc(self, amount: float = 1.0) -> None:
        self._inc(self._key(), amount)

    def get(self) -> float:
        return self._get(self._key())

    def _inc(self, key: Tuple[str, ...], amount: float) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def _set(self, key, value):  # noqa: ARG002
        raise TypeError(f"{self.name} is a counter; use inc()")

    _observe = _set

    def _get(self, key: Tuple[str, ...]) -> float:
        with self._lock:
            return float(self._series.get(key, 0.0))

    def _samples(self):
        return [
            ("", dict(zip(self.label_names, key)), v)
            for key, v in sorted(self._series.items())
        ]


class Gauge(_Metric):
    """Point-in-time value.  ``set_function`` registers a callable read
    at collection time (queue depths and other values owned elsewhere)."""

    type_name = "gauge"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        self._set(self._key(), value)

    def inc(self, amount: float = 1.0) -> None:
        key = self._key()
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def set_function(self, fn: Optional[Callable[[], float]]) -> None:
        """Collect-time callback (unlabeled gauges only); the callback
        must not touch the registry (the lock is held at collection)."""
        self._key()  # enforce no labels
        with self._lock:
            self._fn = fn

    def get(self) -> float:
        return self._get(self._key())

    def _set(self, key: Tuple[str, ...], value: float) -> None:
        with self._lock:
            self._series[key] = float(value)

    def _inc(self, key: Tuple[str, ...], amount: float) -> None:
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def _observe(self, key, value):  # noqa: ARG002
        raise TypeError(f"{self.name} is a gauge; use set()/inc()")

    def _get(self, key: Tuple[str, ...]) -> float:
        with self._lock:
            if self._fn is not None and not key:
                return self._eval_fn()
            return float(self._series.get(key, 0.0))

    def _eval_fn(self) -> float:
        try:
            return float(self._fn())  # type: ignore[misc]
        except Exception:  # noqa: BLE001 — a dead provider reads as 0
            return 0.0

    def _samples(self):
        series = dict(self._series)
        if self._fn is not None:
            series[()] = self._eval_fn()
        return [
            ("", dict(zip(self.label_names, key)), v)
            for key, v in sorted(series.items())
        ]


class Histogram(_Metric):
    """Cumulative-bucket histogram over a fixed ladder (default:
    :func:`latency_buckets`), exposed Prometheus-style with ``+Inf``."""

    type_name = "histogram"

    def __init__(self, name, help_text, label_names, lock, buckets=None):
        super().__init__(name, help_text, label_names, lock)
        bounds = sorted(float(b) for b in (buckets or latency_buckets()))
        if not bounds:
            raise ValueError(f"{name}: needs at least one bucket bound")
        self.bucket_bounds: Tuple[float, ...] = tuple(bounds)

    def observe(self, value: float) -> None:
        self._observe(self._key(), value)

    def _new_state(self) -> Dict[str, Any]:
        return {
            "buckets": [0] * (len(self.bucket_bounds) + 1),  # + overflow
            "sum": 0.0,
            "count": 0,
        }

    def _observe(self, key: Tuple[str, ...], value: float) -> None:
        value = float(value)
        with self._lock:
            state = self._series.get(key)
            if state is None:
                state = self._series[key] = self._new_state()
            idx = len(self.bucket_bounds)
            for i, bound in enumerate(self.bucket_bounds):
                if value <= bound:
                    idx = i
                    break
            state["buckets"][idx] += 1
            state["sum"] += value
            state["count"] += 1

    def _inc(self, key, amount):  # noqa: ARG002
        raise TypeError(f"{self.name} is a histogram; use observe()")

    _set = _inc

    def _get(self, key: Tuple[str, ...]) -> float:
        with self._lock:
            state = self._series.get(key)
            return float(state["count"]) if state else 0.0

    def _samples(self):
        rows: List[Tuple[str, Dict[str, str], float]] = []
        for key, state in sorted(self._series.items()):
            base = dict(zip(self.label_names, key))
            cum = 0
            for bound, n in zip(self.bucket_bounds, state["buckets"]):
                cum += n
                rows.append(
                    ("_bucket", {**base, "le": _fmt_value(bound)}, cum)
                )
            rows.append(
                ("_bucket", {**base, "le": "+Inf"}, state["count"])
            )
            rows.append(("_sum", base, state["sum"]))
            rows.append(("_count", base, state["count"]))
        return rows


class MetricsRegistry:
    """Thread-safe home for a set of named metrics.

    Re-registering an existing name with the same type returns the same
    instrument (modules can declare their metrics independently);
    conflicting re-registration raises.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _register(self, cls, name, help_text, labels, **kwargs) -> _Metric:
        labels = tuple(labels or ())
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (
                    type(existing) is not cls
                    or existing.label_names != labels
                ):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.type_name}{existing.label_names}"
                    )
                return existing
            metric = cls(name, help_text, labels, self._lock, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(
        self, name: str, help_text: str = "", labels: Sequence[str] = ()
    ) -> Counter:
        return self._register(Counter, name, help_text, labels)

    def gauge(
        self, name: str, help_text: str = "", labels: Sequence[str] = ()
    ) -> Gauge:
        return self._register(Gauge, name, help_text, labels)

    def histogram(
        self,
        name: str,
        help_text: str = "",
        labels: Sequence[str] = (),
        buckets: Optional[Sequence[float]] = None,
    ) -> Histogram:
        return self._register(
            Histogram, name, help_text, labels, buckets=buckets
        )

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    # -- exposition -------------------------------------------------------

    def to_prometheus(self) -> str:
        """Prometheus text exposition v0.0.4 of every metric."""
        lines: List[str] = []
        with self._lock:
            for name in sorted(self._metrics):
                metric = self._metrics[name]
                if metric.help_text:
                    lines.append(f"# HELP {name} {metric.help_text}")
                lines.append(f"# TYPE {name} {metric.type_name}")
                for suffix, labels, value in metric._samples():
                    if labels:
                        label_str = ",".join(
                            f'{k}="{_escape_label_value(v)}"'
                            for k, v in labels.items()
                        )
                        lines.append(
                            f"{name}{suffix}{{{label_str}}} "
                            f"{_fmt_value(value)}"
                        )
                    else:
                        lines.append(
                            f"{name}{suffix} {_fmt_value(value)}"
                        )
        return "\n".join(lines) + "\n"


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry every layer publishes into by default."""
    return _DEFAULT
