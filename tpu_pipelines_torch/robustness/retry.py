"""RetryPolicy: bounded, jittered, deadline-aware, observable retries.

One policy object serves every layer that retries (docs/RECOVERY.md
"Retry policies & error taxonomy"):

  * the local runner's per-node executor loop
    (``@component(retry_policy=...)`` > ``Pipeline(retry_policy=...)`` >
    env ``TPP_RETRY_*`` > the legacy ``LocalDagRunner(max_retries=)``);
  * ``ShardPlan`` per-shard work (retry + poison-shard quarantine);
  * metadata-store publishes (multi-writer SQLITE_BUSY contention);
  * the InfraValidator's serving canary (``_urlopen_backoff``).

Backoff is exponential with **full jitter** (AWS-style: sleep a uniform
draw from ``[0, min(max_delay, base * 2**n)]``) so N workers retrying the
same contended resource decorrelate instead of stampeding in lockstep.
``deadline_s`` bounds the *whole* retry budget — attempts plus sleeps —
so a policy can never stretch a node past what its watchdog deadline or
its caller's patience allows.

Every retry is counted in ``retry_attempts_total{site=...}`` on the
process metrics registry, so backoff lands on every ``/metrics`` scrape.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Any, Callable, Dict, Optional

from tpu_pipelines_torch.robustness.errors import classify_error

# Env knobs — the fleet-wide outermost fallback rung of the precedence
# ladder (component > pipeline > env), mirroring TPP_NODE_TIMEOUT_S.
ENV_MAX_ATTEMPTS = "TPP_RETRY_MAX_ATTEMPTS"
ENV_BASE_DELAY_S = "TPP_RETRY_BASE_DELAY_S"
ENV_MAX_DELAY_S = "TPP_RETRY_MAX_DELAY_S"
ENV_DEADLINE_S = "TPP_RETRY_DEADLINE_S"


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How many attempts, how long between them, and a total budget.

    ``max_attempts`` counts ATTEMPTS, not retries: 1 means run once and
    never retry; 3 means up to two retries.  ``deadline_s`` (0 = none)
    caps the whole loop — elapsed work plus backoff sleeps — and a sleep
    that would overrun it is skipped in favor of failing now.
    ``jitter=False`` makes backoff deterministic (tests; single-writer
    paths where decorrelation buys nothing).
    """

    max_attempts: int = 3
    base_delay_s: float = 0.2
    max_delay_s: float = 10.0
    deadline_s: float = 0.0
    jitter: bool = True

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}"
            )
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise ValueError("retry delays must be >= 0")
        if self.deadline_s < 0:
            raise ValueError("deadline_s must be >= 0 (0 = no budget)")

    @property
    def retries(self) -> int:
        """Retries after the first attempt — what Argo calls ``limit``."""
        return self.max_attempts - 1

    def backoff_s(
        self, failures: int, rng: Optional[random.Random] = None
    ) -> float:
        """Sleep before the attempt following the ``failures``-th failure
        (1-based).  Full jitter: uniform in [0, exponential cap]."""
        if failures < 1:
            return 0.0
        cap = min(
            self.max_delay_s, self.base_delay_s * (2.0 ** (failures - 1))
        )
        if cap <= 0:
            return 0.0
        if not self.jitter:
            return cap
        return (rng or random).uniform(0.0, cap)

    # ------------------------------------------------------- serialization

    def to_json(self) -> Dict[str, Any]:
        """Plain-dict form carried on the IR (NodeIR.retry_policy) —
        operational metadata, excluded from the DAG fingerprint like
        deadlines and resource classes."""
        return {
            "max_attempts": self.max_attempts,
            "base_delay_s": self.base_delay_s,
            "max_delay_s": self.max_delay_s,
            "deadline_s": self.deadline_s,
            "jitter": self.jitter,
        }

    @classmethod
    def from_json(cls, d: Optional[Dict[str, Any]]) -> Optional["RetryPolicy"]:
        if not d:
            return None
        return cls(
            max_attempts=int(d.get("max_attempts", 3)),
            base_delay_s=float(d.get("base_delay_s", 0.2)),
            max_delay_s=float(d.get("max_delay_s", 10.0)),
            deadline_s=float(d.get("deadline_s", 0.0)),
            jitter=bool(d.get("jitter", True)),
        )

    @classmethod
    def from_env(cls) -> Optional["RetryPolicy"]:
        """Fleet-wide fallback policy, or None when TPP_RETRY_MAX_ATTEMPTS
        is unset/invalid (the no-policy/byte-identical-trace default)."""
        import os

        raw = os.environ.get(ENV_MAX_ATTEMPTS, "").strip()
        if not raw:
            return None
        try:
            attempts = int(raw)
        except ValueError:
            import logging

            logging.getLogger("tpu_pipelines_torch.robustness").warning(
                "ignoring non-numeric %s=%r", ENV_MAX_ATTEMPTS, raw
            )
            return None
        if attempts <= 1:
            return None

        def _f(name: str, default: float) -> float:
            v = os.environ.get(name, "").strip()
            try:
                return float(v) if v else default
            except ValueError:
                return default

        return cls(
            max_attempts=attempts,
            base_delay_s=_f(ENV_BASE_DELAY_S, 0.2),
            max_delay_s=_f(ENV_MAX_DELAY_S, 10.0),
            deadline_s=_f(ENV_DEADLINE_S, 0.0),
        )


def _retry_counter():
    from tpu_pipelines_torch.observability.metrics import default_registry

    return default_registry().counter(
        "retry_attempts_total",
        "Retries (re-attempts after a transient failure) per call site.",
        labels=("site",),
    )


def record_retry(site: str, n: int = 1) -> None:
    """Count ``n`` retries against ``site`` on the process registry."""
    _retry_counter().labels(site).inc(n)


def retry_call(
    fn: Callable[..., Any],
    *args: Any,
    policy: RetryPolicy,
    site: str,
    classify: Callable[[BaseException], str] = classify_error,
    cancel_event: Optional[threading.Event] = None,
    sleep: Optional[Callable[[float], None]] = None,
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    **kwargs: Any,
) -> Any:
    """``fn(*args, **kwargs)`` under ``policy``.

    Retries only failures the classifier calls transient; permanent
    failures, the last attempt, and a spent ``deadline_s`` budget re-raise
    immediately.  Each retry increments
    ``retry_attempts_total{site=site}`` and calls ``on_retry(attempt,
    exc, backoff_s)`` before sleeping.  ``cancel_event`` (the runner's
    cooperative cancellation handle) aborts the backoff sleep early and
    stops retrying.
    """
    t0 = time.monotonic()
    failures = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except Exception as exc:
            failures += 1
            if failures >= policy.max_attempts:
                raise
            if classify(exc) != "transient":
                raise
            delay = policy.backoff_s(failures)
            if policy.deadline_s > 0:
                remaining = policy.deadline_s - (time.monotonic() - t0)
                if remaining <= 0:
                    raise
                delay = min(delay, max(0.0, remaining))
            if cancel_event is not None and cancel_event.is_set():
                raise
            record_retry(site)
            if on_retry is not None:
                on_retry(failures, exc, delay)
            if delay > 0:
                if cancel_event is not None:
                    if cancel_event.wait(delay):
                        raise  # cancelled mid-backoff: stop retrying
                elif sleep is not None:
                    sleep(delay)
                else:
                    time.sleep(delay)
