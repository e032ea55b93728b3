"""Unified fault-tolerance layer (docs/RECOVERY.md).

The reference stack delegates transient-failure handling to its substrate
(Argo ``retryStrategy``, k8s backoff); this repro increasingly *is* the
substrate, so the policy lives here and every layer shares it:

  * :class:`RetryPolicy` — attempts, exponential backoff + full jitter,
    deadline-aware budget; one precedence ladder everywhere
    (``@component(retry_policy=...)`` > ``Pipeline(retry_policy=...)`` >
    env ``TPP_RETRY_*``), mapped by the cluster runner onto Argo
    ``retryStrategy`` / JobSet restarts.
  * :class:`TransientError` / :class:`PermanentError` /
    :func:`classify_error` — the shared transient-vs-permanent taxonomy.
  * :func:`retry_call` — the loop itself, counting every retry in
    ``retry_attempts_total{site=...}``.
  * :func:`atomic_write_json` / :class:`FileLock` — crash-consistent file
    writes and the cross-process writer lock the multi-writer metadata
    store serializes on.

Consumers: the local runner's per-node executor loop, ``ShardPlan``'s
per-shard retry + poison-shard quarantine, ``MetadataStore`` publish
contention, the ModelServer's load shedding, and the InfraValidator
canary backoff.
"""

from tpu_pipelines_torch.robustness.atomic import (  # noqa: F401
    FileLock,
)
from tpu_pipelines_torch.robustness.errors import (  # noqa: F401
    PERMANENT,
    TRANSIENT,
    TRANSIENT_ERRNOS,
    PermanentError,
    TransientError,
    classify_error,
    is_transient,
)
from tpu_pipelines_torch.robustness.retry import (  # noqa: F401
    RetryPolicy,
    record_retry,
    retry_call,
)

__all__ = [
    "FileLock",
    "PERMANENT",
    "PermanentError",
    "RetryPolicy",
    "TRANSIENT",
    "TRANSIENT_ERRNOS",
    "TransientError",
    "classify_error",
    "is_transient",
    "record_retry",
    "retry_call",
]
