"""Continuous pipelines: span-driven incremental runs that deploy into the
live serving fleet; the port of ``tpu_pipelines/continuous/``.

  * :class:`SpanWatcher` polls a ``{SPAN}``/``{VERSION}`` input pattern
    and reports new spans, and version re-deliveries of old ones, as work,
    with crash-durable acknowledgement state.
  * :class:`~tpu_pipelines_torch.components.resolver.RollingWindowResolver`
    selects the last-K-spans Examples window, their per-span statistics
    and the latest blessed baseline model.
  * :class:`SpanWindow` / :class:`WindowStatisticsMerger` give downstream
    nodes a logically complete artifact: the window Examples is a hard-link
    union of the per-span shard files, and the merged statistics fold the
    per-span pre-merge accumulators in global shard order, so the
    incremental result reproduces a cold full-window pass exactly at the
    cost of only the new span's computation.
  * :class:`ContinuousController` is the long-lived loop: watch, run the
    per-span ingest pipeline, run the window pipeline, deploy through the
    Pusher's push URL into the fleet's canary-gated hot swap, and watch the
    fleet: a rollback inside the probation window un-blesses the
    triggering model in the metadata store.
"""

from tpu_pipelines_torch.continuous.controller import (  # noqa: F401
    ContinuousConfig,
    ContinuousController,
)
from tpu_pipelines_torch.continuous.watcher import (  # noqa: F401
    SpanDelivery,
    SpanWatcher,
)
from tpu_pipelines_torch.continuous.window import (  # noqa: F401
    SpanWindow,
    WindowStatisticsMerger,
    assemble_window,
)
