"""Metric federation: many processes, hosts and replicas, one ``/metrics``.

The port of ``tpu_pipelines/observability/federation.py``.  Every
:class:`~tpu_pipelines_torch.observability.metrics.MetricsRegistry` is
process-local; this module turns them into one endpoint:

  * **Publish.**  A process serializes its registry's ``snapshot()`` and
    writes it atomically (:func:`atomic_write_json`) into a spool
    directory, one file per source.  Forked shard-pool workers publish a
    delta against their fork-time baseline (:func:`note_fork_baseline` /
    :func:`publish_fork_delta`), since a child inherits the parent's counts.
  * **Aggregate.**  :class:`FederatedRegistry` merges the local registry and
    every spooled snapshot at scrape time (counters and histograms add,
    gauges last-write-wins), extending each metric with ``host`` /
    ``replica`` / ``tenant`` labels.  It has the ``to_prometheus()`` a
    :class:`MetricsServer` calls.

The files on disk keep the reference's format, so either package reads
what the other wrote.  Everything is gated on ``TPP_FEDERATION_DIR``:
unset, no file or directory is written and a scrape is the plain
registry's.
"""

from __future__ import annotations

import os
import re
import socket
import time
from typing import Any, Dict, List, Optional, Tuple

from tpu_pipelines_torch.observability.metrics import (
    MetricsRegistry,
    default_registry,
)
from tpu_pipelines_torch.robustness.atomic import (
    atomic_write_json,
    load_json_tolerant,
)

__all__ = [
    "ENV_FEDERATION_DIR",
    "ENV_FED_REPLICA",
    "ENV_FED_TENANT",
    "FEDERATION_LABELS",
    "FederatedRegistry",
    "decode_snapshot",
    "delta_snapshot",
    "encode_snapshot",
    "federation_dir",
    "federation_labels",
    "note_fork_baseline",
    "publish_fork_delta",
    "publish_registry",
    "publish_snapshot",
]

# Spool directory for published snapshots; setting it IS the opt-in.
ENV_FEDERATION_DIR = "TPP_FEDERATION_DIR"
# Identity labels stamped on every published snapshot.
ENV_FED_REPLICA = "TPP_FED_REPLICA"
ENV_FED_TENANT = "TPP_TENANT"

# Labels the aggregator appends to every federated metric (in this
# order), skipping any name the metric already declares — replica.py
# series already carry their own ``replica`` label, and the source's
# value must win there.
FEDERATION_LABELS: Tuple[str, ...] = ("host", "replica", "tenant")

_SOURCE_SAFE_RE = re.compile(r"[^A-Za-z0-9._-]+")


def federation_dir() -> Optional[str]:
    """The spool directory, or None when federation is off."""
    spool = os.environ.get(ENV_FEDERATION_DIR, "").strip()
    return spool or None


def federation_labels(**overrides: str) -> Dict[str, str]:
    """This process's identity labels: host (always), replica and
    tenant (env-provided, empty when unset), plus caller overrides."""
    labels = {
        "host": socket.gethostname(),
        "replica": os.environ.get(ENV_FED_REPLICA, ""),
        "tenant": os.environ.get(ENV_FED_TENANT, ""),
    }
    labels.update({k: str(v) for k, v in overrides.items()})
    return labels


# --------------------------------------------------------------- codec
#
# snapshot() series are keyed by TUPLES of label values — picklable but
# not JSON-safe.  On disk each series dict becomes sorted rows of
# ``[list(key), value]``; everything else in the payload is already
# plain data.


def encode_snapshot(snapshot: Dict[str, Any]) -> Dict[str, Any]:
    """JSON-safe form of a ``MetricsRegistry.snapshot()`` payload."""
    out: Dict[str, Any] = {}
    for name, payload in snapshot.items():
        enc = dict(payload)
        enc["labels"] = list(payload["labels"])
        enc["series"] = [
            [list(key), value]
            for key, value in sorted(payload["series"].items())
        ]
        out[name] = enc
    return out


def decode_snapshot(obj: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`encode_snapshot` (tuple keys restored)."""
    out: Dict[str, Any] = {}
    for name, payload in obj.items():
        dec = dict(payload)
        dec["labels"] = tuple(payload["labels"])
        dec["series"] = {
            tuple(key): value for key, value in payload["series"]
        }
        out[name] = dec
    return out


# --------------------------------------------------------------- delta


def _series_delta(
    type_name: str, current: Dict[Tuple, Any], base: Dict[Tuple, Any]
) -> Dict[Tuple, Any]:
    out: Dict[Tuple, Any] = {}
    for key, value in current.items():
        prev = base.get(key)
        if type_name == "counter":
            d = float(value) - float(prev or 0.0)
            if d > 0:
                out[key] = d
        elif type_name == "histogram":
            if prev is None:
                if value["count"]:
                    out[key] = value
                continue
            buckets = [
                a - b for a, b in zip(value["buckets"], prev["buckets"])
            ]
            count = int(value["count"]) - int(prev["count"])
            if count > 0 and all(b >= 0 for b in buckets):
                out[key] = {
                    "buckets": buckets,
                    "sum": float(value["sum"]) - float(prev["sum"]),
                    "count": count,
                }
        else:  # gauge: changed-only (last-write-wins on merge)
            if prev is None or float(value) != float(prev):
                out[key] = value
    return out


def delta_snapshot(
    current: Dict[str, Any], baseline: Dict[str, Any]
) -> Dict[str, Any]:
    """What ``current`` observed SINCE ``baseline`` — the snapshot a
    forked worker publishes so its inherited parent counts are not
    counted twice.  Counters/histogram series subtract (negative deltas
    — a restarted source — are dropped rather than published as
    nonsense); gauges keep only series that changed."""
    out: Dict[str, Any] = {}
    for name, payload in current.items():
        base = baseline.get(name)
        base_series = (
            base["series"]
            if base is not None and base["type"] == payload["type"]
            else {}
        )
        series = _series_delta(
            payload["type"], payload["series"], base_series
        )
        if series:
            out[name] = {**payload, "series": series}
    return out


# ------------------------------------------------------------- publish


def _source_path(spool_dir: str, source: str) -> str:
    safe = _SOURCE_SAFE_RE.sub("_", source) or "source"
    return os.path.join(spool_dir, f"{safe}.json")


def publish_snapshot(
    snapshot: Dict[str, Any],
    spool_dir: Optional[str] = None,
    source: Optional[str] = None,
    labels: Optional[Dict[str, str]] = None,
    writer_id: Optional[int] = None,
) -> Optional[str]:
    """Atomically write one source's snapshot into the spool.

    One file per source (last write wins — each publish supersedes the
    previous one from the same source, so counters must be published
    cumulatively per source, or as deltas under a fresh source name).
    The ``writer`` stamp (host, pid, registry identity) lets a
    :class:`FederatedRegistry` in the SAME process skip the file its
    own local registry produced — without it a process that both
    publishes and serves would double-count itself.
    Returns the path written, or None when federation is off.
    """
    spool = spool_dir or federation_dir()
    if not spool:
        return None
    src = source or f"pid-{os.getpid()}"
    os.makedirs(spool, exist_ok=True)
    path = _source_path(spool, src)
    atomic_write_json(
        path,
        {
            "version": 1,
            "source": src,
            "labels": dict(labels or federation_labels()),
            "unix_time": time.time(),
            "writer": {
                "host": socket.gethostname(),
                "pid": os.getpid(),
                "registry_id": writer_id,
            },
            "snapshot": encode_snapshot(snapshot),
        },
        do_fsync=False,  # scrape freshness, not durability (see history)
    )
    return path


def publish_registry(
    registry: Optional[MetricsRegistry] = None,
    spool_dir: Optional[str] = None,
    source: Optional[str] = None,
    labels: Optional[Dict[str, str]] = None,
    baseline: Optional[Dict[str, Any]] = None,
) -> Optional[str]:
    """Publish ``registry`` (default: the process registry), optionally
    as a delta against ``baseline``.  No-op (returns None) when off."""
    spool = spool_dir or federation_dir()
    if not spool:
        return None
    reg = registry or default_registry()
    snap = reg.snapshot()
    if baseline is not None:
        snap = delta_snapshot(snap, baseline)
    return publish_snapshot(
        snap, spool_dir=spool, source=source, labels=labels,
        writer_id=id(reg),
    )


# ------------------------------------------- forked-worker delta hooks
#
# A fork-pool child INHERITS the parent registry's counts; the pair
# below is called by the shard-pool wrapper (data/shard_plan.py) so the
# child publishes only what it observed itself.  Keyed by pid: the
# baseline dict itself is inherited across fork, so the child's first
# call records its own fork-time state without colliding with the
# parent's entry.

_FORK_BASELINE: Dict[int, Dict[str, Any]] = {}


def note_fork_baseline(
    registry: Optional[MetricsRegistry] = None,
) -> None:
    """Record this process's registry state once (before any task work)
    — the subtrahend for :func:`publish_fork_delta`."""
    if federation_dir() is None:
        return
    pid = os.getpid()
    if pid not in _FORK_BASELINE:
        _FORK_BASELINE[pid] = (registry or default_registry()).snapshot()


def publish_fork_delta(
    registry: Optional[MetricsRegistry] = None,
    source: Optional[str] = None,
) -> Optional[str]:
    """Publish this worker's delta-vs-fork-baseline snapshot."""
    spool = federation_dir()
    if spool is None:
        return None
    return publish_registry(
        registry,
        spool_dir=spool,
        source=source or f"worker-{os.getpid()}",
        baseline=_FORK_BASELINE.get(os.getpid(), {}),
    )


# ----------------------------------------------------------- aggregate


def _extend_labels(
    snapshot: Dict[str, Any], labels: Dict[str, str]
) -> Dict[str, Any]:
    """Append the federation labels (those not already declared) to
    every metric in ``snapshot``.  The transformation depends only on
    the metric's declared labels, so every source maps a given metric
    to the SAME extended label set — the precondition for merge."""
    out: Dict[str, Any] = {}
    for name, payload in snapshot.items():
        declared = tuple(payload["labels"])
        extra = tuple(
            n for n in FEDERATION_LABELS if n not in declared
        )
        extra_values = tuple(str(labels.get(n, "")) for n in extra)
        out[name] = {
            **payload,
            "labels": declared + extra,
            "series": {
                tuple(key) + extra_values: value
                for key, value in payload["series"].items()
            },
        }
    return out


class FederatedRegistry:
    """Scrape-time aggregator over the local registry + the spool.

    Duck-types the surface ``MetricsServer`` and scrape helpers
    use (``to_prometheus()``/``snapshot()``), so
    ``start_http_server(registry=FederatedRegistry(...))`` turns the
    existing opt-in metrics port into the fleet-wide endpoint.  Sources
    older than ``max_age_s`` (a departed replica's last snapshot) are
    dropped from the merge when a limit is set.
    """

    def __init__(
        self,
        local: Optional[MetricsRegistry] = None,
        spool_dir: Optional[str] = None,
        labels: Optional[Dict[str, str]] = None,
        max_age_s: Optional[float] = None,
    ):
        self.local = local
        self.spool_dir = spool_dir or federation_dir()
        self.labels = dict(labels or federation_labels())
        self.max_age_s = max_age_s

    def sources(self) -> List[Dict[str, Any]]:
        """Every live spooled payload (torn/stale files skipped)."""
        if not self.spool_dir or not os.path.isdir(self.spool_dir):
            return []
        out: List[Dict[str, Any]] = []
        now = time.time()
        for fname in sorted(os.listdir(self.spool_dir)):
            if not fname.endswith(".json"):
                continue
            payload = load_json_tolerant(
                os.path.join(self.spool_dir, fname)
            )
            if not isinstance(payload, dict) or "snapshot" not in payload:
                continue
            if (
                self.max_age_s is not None
                and now - float(payload.get("unix_time", now))
                > self.max_age_s
            ):
                continue
            out.append(payload)
        return out

    def merged(self) -> MetricsRegistry:
        """One fresh registry holding every source, federation-labeled."""
        out = MetricsRegistry()
        n_sources = 0
        me = None
        if self.local is not None:
            out.merge(_extend_labels(self.local.snapshot(), self.labels))
            n_sources += 1
            # This process may ALSO publish self.local into the spool
            # (e.g. a trainer feeding remote scrapes while the runner in
            # the same process serves this endpoint).  That file is a
            # stale subset of the live registry just merged — skip it or
            # every local series counts twice.
            me = {
                "host": socket.gethostname(),
                "pid": os.getpid(),
                "registry_id": id(self.local),
            }
        for payload in self.sources():
            if me is not None and payload.get("writer") == me:
                continue
            labels = {**self.labels, **payload.get("labels", {})}
            out.merge(
                _extend_labels(
                    decode_snapshot(payload["snapshot"]), labels
                )
            )
            out.gauge(
                "federation_source_age_seconds",
                "Seconds since each federated source last published.",
                labels=("source",),
            ).labels(str(payload.get("source", "?"))).set(
                max(0.0, time.time() - float(payload.get("unix_time", 0)))
            )
            n_sources += 1
        out.gauge(
            "federation_sources",
            "Sources (local + spooled) merged into this scrape.",
        ).set(n_sources)
        return out

    def snapshot(self) -> Dict[str, Any]:
        return self.merged().snapshot()

    def to_prometheus(self) -> str:
        return self.merged().to_prometheus()
