"""ModelVersionManager: N resident versions with atomic canary-gated swap.

The port of ``tpu_pipelines/serving/fleet/versions.py``.  The
single-server reload (server.py) holds ONE model and swaps the
reference; this manager keeps up to ``max_versions`` loaded payloads
resident so a hot-swap is instant, a rollback needs no disk read, and the
outgoing version keeps answering every request that already leased it.

The swap contract (the fleet half of docs/RECOVERY.md's zero-drop story):

  1. **Load outside the lock.**  ``load_version()`` reads the payload (and
     the canary captures its graphs) while holding no lock the predict
     path touches — a multi-second load never stalls a request.
  2. **Canary before eligibility.**  When a canary batch is configured
     (the fleet captures the first served request; see fleet.py), the new
     version must pass the same smoke check InfraValidator runs
     (``infra_validator.canary_check``: prediction count + finiteness)
     BEFORE it can become active.  A failing version raises
     :class:`CanaryRefused` and the prior version keeps serving.
  3. **Swap under the lock.**  Activation is one reference assignment.
  4. **Drain, then evict.**  In-flight requests hold a lease on the
     version they started on; an evicted-but-leased version is only
     dropped when its last lease releases.  Python references keep the
     payload alive mid-predict regardless — the lease makes the drain
     *observable* (``serving_versions_resident``) and bounds resident
     memory deterministically instead of leaving it to GC timing.

For the SLO auto-rollback (``ServingFleet.on_slo_breach``) the manager
records the last swap (who replaced whom, when, and whether the swap was
itself a rollback, which opens no probation window) and keeps a
quarantine: a quarantined version answers load and activate with
:class:`CanaryRefused` (HTTP 409) until ``clear_quarantine``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

log = logging.getLogger("tpu_pipelines_torch.serving")


class CanaryRefused(RuntimeError):
    """A freshly loaded version failed the canary smoke check and was NOT
    made eligible; the previously active version keeps serving.  Maps to
    a non-5xx verdict on the reload surface (HTTP 409): the server is
    healthy, the pushed payload is not."""


def _default_loader(version_dir: str, device: Any = "cuda"):
    from tpu_pipelines_torch.trainer.export import load_exported_model

    return load_exported_model(version_dir, device=device)


class ModelVersionManager:
    """Holds model versions resident; one is active, the rest are warm.

    ``canary_fn(loaded, version)`` returns an error string ('' = pass);
    ``loader(version_dir)`` returns the loaded payload (default:
    ``load_exported_model(version_dir, device=device)``).  All public methods are thread-safe;
    ``load_version`` serializes on its own load lock so concurrent pushes
    cannot interleave their load/swap halves.
    """

    def __init__(
        self,
        model_name: str,
        *,
        max_versions: int = 2,
        loader: Optional[Callable[[str], Any]] = None,
        canary_fn: Optional[Callable[[Any, str], str]] = None,
        registry=None,
        device: Any = "cuda",
    ):
        self.model_name = model_name
        self.max_versions = max(1, int(max_versions))
        self.device = device
        self._loader = loader
        self._canary_fn = canary_fn
        self._lock = threading.Lock()        # guards the maps + active ref
        self._load_lock = threading.Lock()   # serializes load/swap sequences
        self._versions: Dict[str, Any] = {}  # insertion order = load order
        self._leases: Dict[str, int] = {}
        self._dtypes: Dict[str, str] = {}    # for gauge zeroing at drop
        self._evict_pending: set = set()
        self._active: Optional[str] = None
        # SLO auto-rollback state: the last swap bounds the probation
        # window, and a quarantined version is refused until cleared — a
        # burn-rate rollback must not be undone by the next :reload of the
        # same bad payload.
        self._last_swap: Optional[Dict[str, Any]] = None
        self._quarantined: Dict[str, str] = {}
        self._m_swaps = self._m_evictions = self._m_canary = None
        self._m_resident = self._m_info = None
        self._m_memory = self._m_dtype = None
        if registry is not None:
            self._m_swaps = registry.counter(
                "serving_version_swaps_total",
                "Successful version activations (hot-swaps + initial load).",
            )
            self._m_evictions = registry.counter(
                "serving_version_evictions_total",
                "Versions evicted after draining (beyond max_versions).",
            )
            self._m_canary = registry.counter(
                "serving_canary_failures_total",
                "Version loads refused by the canary smoke check.",
            )
            self._m_resident = registry.gauge(
                "serving_versions_resident",
                "Model versions currently held in memory by the fleet.",
            )
            self._m_info = registry.gauge(
                "serving_model_info",
                "1 for the currently served model version, 0 for prior "
                "ones.",
                labels=("model", "version"),
            )
            self._m_memory = registry.gauge(
                "serving_version_memory_bytes",
                "Resident parameter bytes per loaded model version "
                "(the loaded tensors' bytes).  0 after eviction.",
                labels=("model", "version"),
            )
            self._m_dtype = registry.gauge(
                "serving_version_dtype",
                "1 for each resident version at its serving dtype "
                "(float32 | bfloat16 | aqt_int8); 0 after eviction.",
                labels=("model", "version", "dtype"),
            )

    # ------------------------------------------------------------ queries

    @property
    def active_version(self) -> Optional[str]:
        with self._lock:
            return self._active

    def active_loaded(self):
        """The active version's loaded payload (None before first load)."""
        with self._lock:
            return self._versions.get(self._active)

    def resident_versions(self) -> List[str]:
        with self._lock:
            return [
                v for v in self._versions if v not in self._evict_pending
            ]

    def loaded_for(self, version: str):
        """The resident payload for one version (None if not resident) —
        what a replica rebuild re-creates its engines from."""
        with self._lock:
            if version in self._evict_pending:
                return None
            return self._versions.get(version)

    def lease_count(self, version: str) -> int:
        with self._lock:
            return self._leases.get(version, 0)

    def last_swap(self) -> Optional[Dict[str, Any]]:
        """``{"version", "prior", "mono", "rollback"}`` of the most recent
        activation that changed the served version (None before the
        second one)."""
        with self._lock:
            return dict(self._last_swap) if self._last_swap else None

    def quarantined(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._quarantined)

    # -------------------------------------------------------- quarantine

    def quarantine(self, version: str, reason: str = "") -> None:
        """Refuse future ``load_version`` / ``activate`` of ``version``
        with :class:`CanaryRefused` (HTTP 409 on ``:reload``) until
        :meth:`clear_quarantine` — the half of an SLO auto-rollback that
        keeps the next push of the same bad payload out."""
        with self._lock:
            self._quarantined[version] = reason or "quarantined"
        log.warning(
            "fleet: %s version %s quarantined (%s)",
            self.model_name, version, reason,
        )

    def clear_quarantine(self, version: Optional[str] = None) -> List[str]:
        """Lift the quarantine on ``version`` (None = all); returns the
        versions cleared."""
        with self._lock:
            if version is None:
                cleared = list(self._quarantined)
                self._quarantined.clear()
            else:
                cleared = (
                    [version] if self._quarantined.pop(version, None)
                    is not None else []
                )
        return cleared

    def _check_quarantine(self, version: str) -> None:
        with self._lock:
            reason = self._quarantined.get(version)
        if reason is not None:
            raise CanaryRefused(
                f"version {version!r} of {self.model_name!r} is "
                f"quarantined ({reason}); clear_quarantine() to re-admit"
            )

    # ----------------------------------------------------------- lifecycle

    def load_version(self, version_dir: str) -> str:
        """Load + canary + activate ``version_dir``; returns the version.

        Already-resident versions just re-activate (instant rollback /
        roll-forward).  Raises :class:`CanaryRefused` when the canary
        rejects the fresh payload — nothing about the serving state
        changes in that case.
        """
        version = os.path.basename(version_dir.rstrip("/")) or version_dir
        self._check_quarantine(version)
        with self._load_lock:
            with self._lock:
                resident = (
                    version in self._versions
                    and version not in self._evict_pending
                )
            if resident:
                self._activate(version)
                return version
            loaded = (                                # slow: outside locks
                self._loader(version_dir) if self._loader is not None
                else _default_loader(version_dir, self.device)
            )
            if self._canary_fn is not None:
                error = self._canary_fn(loaded, version)
                if error:
                    if self._m_canary is not None:
                        self._m_canary.inc()
                    raise CanaryRefused(
                        f"version {version!r} of {self.model_name!r} "
                        f"failed the canary check: {error}"
                    )
            dtype = str(getattr(loaded, "dtype", "") or "float32")
            with self._lock:
                self._versions[version] = loaded
                self._leases.setdefault(version, 0)
                self._evict_pending.discard(version)
                self._dtypes[version] = dtype
            if self._m_memory is not None:
                self._m_memory.labels(self.model_name, version).set(
                    int(getattr(loaded, "params_bytes", 0) or 0)
                )
                self._m_dtype.labels(
                    self.model_name, version, dtype
                ).set(1)
            self._activate(version)
            return version

    def _activate(self, version: str, rollback: bool = False) -> None:
        with self._lock:
            prior = self._active
            if version not in self._versions:
                raise KeyError(f"version {version!r} is not resident")
            self._active = version
            if prior != version:
                # ``rollback`` marks swaps the SLO policy itself made: they
                # open no probation window (a breach after a rollback must
                # not ping-pong back onto the bad version).
                self._last_swap = {
                    "version": version, "prior": prior,
                    "mono": time.monotonic(), "rollback": rollback,
                }
            self._evict_excess_locked()
        if self._m_info is not None:
            if prior is not None and prior != version:
                self._m_info.labels(self.model_name, prior).set(0)
            self._m_info.labels(self.model_name, version).set(1)
        if self._m_swaps is not None and prior != version:
            self._m_swaps.inc()
        self._publish_resident()
        if prior != version:
            log.info(
                "fleet: %s active version %s -> %s",
                self.model_name, prior, version,
            )

    def activate(self, version: str, *, rollback: bool = False) -> str:
        """Swap to an already-resident version (rollback without a load).
        ``rollback=True`` (the SLO policy's own activation) opens no
        probation window."""
        self._check_quarantine(version)
        self._activate(version, rollback=rollback)
        return version

    def _evict_excess_locked(self) -> None:
        """Mark oldest non-active versions beyond ``max_versions`` for
        eviction; drop immediately when fully drained (lease count 0).
        Caller holds ``self._lock``."""
        keep = [
            v for v in self._versions if v not in self._evict_pending
        ]
        excess = len(keep) - self.max_versions
        for version in list(self._versions):
            if excess <= 0:
                break
            if version == self._active or version in self._evict_pending:
                continue
            self._evict_pending.add(version)
            excess -= 1
            if self._leases.get(version, 0) == 0:
                self._drop_locked(version)

    def _drop_locked(self, version: str) -> None:
        self._versions.pop(version, None)
        self._leases.pop(version, None)
        self._evict_pending.discard(version)
        dtype = self._dtypes.pop(version, None)
        if self._m_memory is not None:
            self._m_memory.labels(self.model_name, version).set(0)
            if dtype:
                self._m_dtype.labels(
                    self.model_name, version, dtype
                ).set(0)
        if self._m_evictions is not None:
            self._m_evictions.inc()
        log.info("fleet: %s evicted drained version %s",
                 self.model_name, version)

    def _publish_resident(self) -> None:
        if self._m_resident is not None:
            with self._lock:
                n = len([
                    v for v in self._versions
                    if v not in self._evict_pending
                ])
            self._m_resident.set(n)

    # -------------------------------------------------------------- leases

    @contextlib.contextmanager
    def lease(self):
        """Pin the CURRENT active version for the duration of one request.

        Yields ``(version, loaded)``.  A hot-swap mid-request does not
        touch this lease: the request finishes on the version it started
        on, and an evicted version is only dropped once every lease on it
        has released (drain-then-evict)."""
        with self._lock:
            version = self._active
            loaded = self._versions.get(version)
            if loaded is None:
                raise RuntimeError("no model loaded")
            self._leases[version] = self._leases.get(version, 0) + 1
        try:
            yield version, loaded
        finally:
            evicted = False
            with self._lock:
                self._leases[version] = self._leases.get(version, 1) - 1
                if (
                    version in self._evict_pending
                    and self._leases.get(version, 0) <= 0
                ):
                    self._drop_locked(version)
                    evicted = True
            if evicted:
                self._publish_resident()
