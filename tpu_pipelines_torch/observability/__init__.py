"""Observability: run-scoped tracing, live telemetry, Perfetto export.

Every layer of a run emits structured span events into one append-only
JSONL (``<pipeline_root>/.runs/<run_id>/trace/events.jsonl``, trace.py),
and the exporters (export.py) turn it into a Perfetto-loadable
``trace.json``, a ``metrics.json`` summary (measured critical path,
queue/gate waits, cache-hit ratio, shard skew) and a run-to-run diff.
``TPP_TRACE=0`` disables tracing.  ``metrics.py`` is the registry with
Prometheus exposition and the ``TPP_METRICS_PORT`` server; ``health.py``
the heartbeat and NaN watchdogs.
"""

from tpu_pipelines_torch.observability.trace import (  # noqa: F401
    ENV_TRACE,
    RunContextFilter,
    TraceRecorder,
    activate,
    active_recorder,
    events_path,
    install_log_correlation,
    instant,
    node_log_context,
    run_trace_dir,
    set_run_id,
    span,
    trace_enabled,
)
from tpu_pipelines_torch.observability.export import (  # noqa: F401
    compute_metrics,
    diff_metrics,
    export_metrics,
    export_perfetto,
    format_diff,
    format_summary,
    read_events,
    to_perfetto,
)
from tpu_pipelines_torch.observability.metrics import (  # noqa: F401
    MetricsRegistry,
    default_registry,
    fine_latency_buckets,
    latency_buckets,
    start_http_server,
)
