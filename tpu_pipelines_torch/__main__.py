"""The port's CLI: ``python -m tpu_pipelines_torch
{run,lint,continuous,inspect,trace,drift} ...``, the twin of ``python -m
tpu_pipelines``.

``run`` executes a pipeline module through the port's ``LocalDagRunner``,
on the card unless ``--device cpu`` is given (without CUDA the default
raises, naming the device); ``--resume-from latest|RUN_ID`` continues a
crashed run, adopting what it published:

    python -m tpu_pipelines_torch run \
        --pipeline-module tpu_pipelines_torch/examples/bert_pipeline.py
    python -m tpu_pipelines_torch run --pipeline-module p.py --device cpu \
        --param steps=500
    python -m tpu_pipelines_torch run --pipeline-module p.py --resume-from latest
    python -m tpu_pipelines_torch run --pipeline-module p.py \
        --from-node Trainer          # partial run, upstream from the store
    python -m tpu_pipelines_torch run --pipeline-module p.py --lint error

``lint`` is the static pipeline and executor analysis (``analysis/``): it
compiles the module's pipeline and runs the TPP1xx graph rules on the IR
and the TPP2xx code rules on every executor and module-file entry point,
without executing anything.  Exit 0 = clean at the ``--fail-on`` level
(default error), 3 = blocking findings, 1 = the module failed to load:

    python -m tpu_pipelines_torch lint --pipeline-module p.py [--json] \
        [--fail-on warn] [--continuous] [--spmd-sync]

``continuous`` runs the continuous controller over a module defining
``create_continuous() -> ContinuousConfig``: watch a ``{SPAN}`` pattern,
ingest new spans, retrain over a rolling window, deploy into the fleet.
The first SIGINT or SIGTERM drains (the in-flight run finishes, state
persists), a second aborts:

    python -m tpu_pipelines_torch continuous --pipeline-module m.py \
        [--poll-interval S] [--once | --max-iterations N] [--state-dir D] \
        [--device cpu] [--lint error|warn|off]

``inspect`` reads the metadata store back:

    python -m tpu_pipelines_torch inspect runs <pipeline> --metadata md.sqlite
    python -m tpu_pipelines_torch inspect lineage <artifact-id> --metadata md.sqlite
    python -m tpu_pipelines_torch inspect artifacts [--type Model] --metadata md.sqlite

``trace`` summarizes, exports and compares a run's trace
(``<pipeline_root>/.runs/<run_id>/trace/events.jsonl``):

    python -m tpu_pipelines_torch trace latest --pipeline-root /pipe/root
    python -m tpu_pipelines_torch trace <run-id> --pipeline-root /pipe/root \
        --perfetto trace.json --metrics metrics.json
    python -m tpu_pipelines_torch trace diff <run-a> <run-b> \
        --pipeline-root /pipe/root [--threshold 0.2]

``drift`` reads a serving fleet's ``/metrics`` scrape and prints its live
drift and skew report (exit 3 with ``--fail-on-alert`` once any alert
counted):

    python -m tpu_pipelines_torch drift --url http://127.0.0.1:8501/v1/models/bert

``trace diff`` exits 3 when a node or the critical path regressed past
the threshold.  ``--json`` on ``trace``, ``trace diff`` and ``inspect
runs`` prints one JSON object instead of the tables.

Not ported yet: ``trace serve`` prints the ``ROADMAP.md`` item it waits
for (A8b) and exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from tpu_pipelines_torch.metadata.store import MetadataStore

EXIT_UNPORTED = 2
# A gate that found something (``drift --fail-on-alert``).
EXIT_GATED = 3


def _unported(what: str, item: str) -> int:
    print(f"{what} is not ported yet (ROADMAP.md {item})", file=sys.stderr)
    return EXIT_UNPORTED


def _fmt_props(props: dict, keys=None) -> str:
    items = [
        (k, v) for k, v in sorted(props.items())
        if keys is None or k in keys
    ]
    return " ".join(f"{k}={v}" for k, v in items)


def _run_trace_metrics(pipeline_root: str, run_id: str) -> dict:
    """Per-node trace metrics for a run, {} when no trace exists."""
    if not pipeline_root:
        return {}
    from tpu_pipelines_torch.observability import (
        compute_metrics,
        events_path,
        read_events,
    )

    path = events_path(pipeline_root, run_id)
    if not os.path.exists(path):
        return {}
    return compute_metrics(read_events(path))


def cmd_runs(
    store: MetadataStore,
    pipeline: str,
    pipeline_root: str = "",
    as_json: bool = False,
) -> int:
    prefix = f"{pipeline}."
    runs = [
        c for c in store.get_contexts("pipeline_run")
        if c.name.startswith(prefix)
    ]
    if not runs:
        print(f"no runs recorded for pipeline {pipeline!r}", file=sys.stderr)
        return 1
    json_runs = []
    for ctx in runs:
        run_id = ctx.properties.get("run_id") or ctx.name[len(prefix):]
        # Trace-derived per-node columns (queue wait) when the run's trace
        # is reachable through --pipeline-root.
        trace_nodes = _run_trace_metrics(pipeline_root, run_id).get(
            "per_node", {}
        )
        if as_json:
            json_runs.append({
                "run_id": run_id,
                "context_id": ctx.id,
                "nodes": [
                    {
                        "node": ex.node_id or ex.type_name,
                        "state": ex.state.value,
                        "execution_id": ex.id,
                        "properties": ex.properties,
                        **(
                            {"trace": trace_nodes[ex.node_id]}
                            if ex.node_id in trace_nodes else {}
                        ),
                    }
                    for ex in store.get_executions_by_context(ctx.id)
                ],
            })
            continue
        print(f"run {run_id}  (context #{ctx.id})")
        header = f"  {'node':<24} {'state':<10} {'dur_s':>9}"
        if trace_nodes:
            header += f" {'queue_s':>8}"
        print(header)
        for ex in store.get_executions_by_context(ctx.id):
            wall = ex.properties.get("wall_clock_s", "")
            dur = f"{wall}s" if wall != "" else "-"
            extra = _fmt_props(
                ex.properties,
                keys=(
                    "examples_per_sec_per_chip", "retries", "cache_hit",
                    "error",
                ),
            )
            line = (
                f"  {ex.node_id or ex.type_name:<24} "
                f"{ex.state.value:<10} {dur:>9}"
            )
            if trace_nodes:
                q = trace_nodes.get(ex.node_id, {}).get("queue_wait_s")
                line += f" {q if q is not None else '-':>8}"
            print(f"{line}  {extra}".rstrip())
    if as_json:
        print(json.dumps({"pipeline": pipeline, "runs": json_runs},
                         indent=1, sort_keys=True, default=str))
    return 0


def _resolve_run_id(pipeline_root: str, run_id: str):
    """Resolve 'latest' to the newest run dir; (run_id, error)."""
    if run_id != "latest":
        return run_id, None
    runs_dir = os.path.join(pipeline_root, ".runs")
    candidates = sorted(
        (d for d in (os.listdir(runs_dir) if os.path.isdir(runs_dir)
                     else [])
         # "_"-prefixed dirs are cross-run stores, not runs.
         if not d.startswith("_")
         and os.path.isdir(os.path.join(runs_dir, d))),
        key=lambda d: os.path.getmtime(os.path.join(runs_dir, d)),
    )
    if not candidates:
        return None, f"no traced runs under {runs_dir}"
    return candidates[-1], None


def _load_run_metrics(pipeline_root: str, run_id: str):
    """((run_id, events, metrics), error) for one traced run."""
    from tpu_pipelines_torch.observability import (
        compute_metrics,
        events_path,
        read_events,
    )

    run_id, err = _resolve_run_id(pipeline_root, run_id)
    if err:
        return None, err
    events_file = events_path(pipeline_root, run_id)
    if not os.path.exists(events_file):
        return None, (
            f"no trace event log at {events_file} (was the run traced? "
            "TPP_TRACE=0 disables tracing)"
        )
    events = read_events(events_file)
    if not events:
        return None, f"trace event log {events_file} is empty"
    return (run_id, events, compute_metrics(events)), None


def cmd_trace(args) -> int:
    from tpu_pipelines_torch.observability import (
        export_metrics,
        export_perfetto,
        format_summary,
    )

    if args.run_id[0] == "diff":
        return cmd_trace_diff(args)
    if args.run_id[0] == "serve":
        return _unported("trace serve (the serving tier's request traces)",
                         "A8b")
    if len(args.run_id) != 1:
        print("trace takes one run id (or: trace diff <a> <b>)",
              file=sys.stderr)
        return 2
    if not args.pipeline_root:
        print("trace <run-id> requires --pipeline-root", file=sys.stderr)
        return 2
    loaded, err = _load_run_metrics(args.pipeline_root, args.run_id[0])
    if err:
        print(err, file=sys.stderr)
        return 1
    run_id, events, metrics = loaded
    if args.json:
        print(json.dumps(
            {"run_id": run_id, "events": len(events), **metrics},
            indent=1, sort_keys=True,
        ))
    else:
        print(f"run {run_id}  ({len(events)} events)")
        print(format_summary(metrics))
    if args.perfetto:
        path = export_perfetto(events, args.perfetto)
        if not args.json:
            print(
                f"perfetto timeline: {path} "
                "(load in https://ui.perfetto.dev)"
            )
    if args.metrics:
        path = export_metrics(events, args.metrics)
        if not args.json:
            print(f"metrics summary: {path}")
    return 0


def cmd_trace_diff(args) -> int:
    """``trace diff <run_a> <run_b>``: per-node deltas and regression
    flags; exit 0 = clean, 3 = regressed past threshold, 1 = error."""
    from tpu_pipelines_torch.observability import diff_metrics, format_diff

    ids = args.run_id[1:]
    if len(ids) != 2:
        print("trace diff needs exactly two run ids: trace diff <a> <b>",
              file=sys.stderr)
        return 2
    if not args.pipeline_root:
        print("trace diff requires --pipeline-root", file=sys.stderr)
        return 2
    loaded = []
    for rid in ids:
        got, err = _load_run_metrics(args.pipeline_root, rid)
        if err:
            print(err, file=sys.stderr)
            return 1
        loaded.append(got)
    (id_a, _, metrics_a), (id_b, _, metrics_b) = loaded
    diff = diff_metrics(metrics_a, metrics_b, threshold=args.threshold)
    if args.json:
        print(json.dumps(
            {"run_a": id_a, "run_b": id_b, **diff},
            indent=1, sort_keys=True,
        ))
    else:
        print(f"trace diff: {id_a} (baseline) -> {id_b}")
        print(format_diff(diff))
    return 3 if diff["regressed"] else 0


def cmd_lineage(store: MetadataStore, artifact_id: int) -> int:
    text = store.format_lineage(artifact_id)
    print(text)
    return 1 if text.startswith("<no artifact") else 0


def cmd_artifacts(store: MetadataStore, type_name: str) -> int:
    arts = store.get_artifacts(type_name=type_name or None)
    if not arts:
        print("no artifacts", file=sys.stderr)
        return 1
    for a in arts:
        print(f"#{a.id:<5} {a.type_name:<16} [{a.state.value}] {a.uri}")
    return 0


def cmd_drift(args) -> int:
    """``drift --url U [--json] [--fail-on-alert]``: scrape a live fleet's
    /metrics and print the drift and skew report."""
    import urllib.parse
    import urllib.request

    from tpu_pipelines_torch.observability.drift import (
        format_drift_report,
        parse_drift_scrape,
    )

    parts = urllib.parse.urlsplit(args.url)
    url = urllib.parse.urlunsplit(
        (parts.scheme, parts.netloc, "/metrics", "", "")
    )
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            text = r.read().decode("utf-8", "replace")
    except Exception as e:  # noqa: BLE001 — tool error, not a verdict
        print(f"drift: cannot scrape {url}: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    report = parse_drift_scrape(text)
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(format_drift_report(report))
    if args.fail_on_alert and report.get("alerts_total", 0) > 0:
        return EXIT_GATED
    return 0


def cmd_run(args) -> int:
    import logging

    from tpu_pipelines_torch.orchestration import LocalDagRunner
    from tpu_pipelines_torch.utils.module_loader import load_fn

    from tpu_pipelines_torch.analysis import LintGateError

    logging.basicConfig(level=logging.INFO)
    params = {}
    for spec in args.param:
        name, eq, raw = spec.partition("=")
        if not eq:
            print(f"--param needs NAME=VALUE, got {spec!r}")
            return 2
        try:
            params[name] = json.loads(raw)
        except json.JSONDecodeError:
            params[name] = raw  # plain string value
    runner = LocalDagRunner(
        max_retries=args.max_retries,
        max_parallel_nodes=args.max_parallel_nodes,
        device=args.device,
    )
    pipeline = load_fn(args.pipeline_module, "create_pipeline")()
    try:
        result = runner.run(
            pipeline, runtime_parameters=params, raise_on_failure=False,
            from_nodes=args.from_node or None,
            to_nodes=args.to_node or None,
            resume_from=args.resume_from, lint=args.lint,
        )
    except LintGateError as e:
        print(str(e), file=sys.stderr)
        return EXIT_GATED
    except ValueError as e:
        # A refused combination or bound (resume with partial-run bounds,
        # an unknown node, a changed DAG): a usage error, nothing ran.
        print(f"run: {e}", file=sys.stderr)
        return 2
    print(f"run {result.run_id}: "
          f"{'OK' if result.succeeded else 'FAILED'}")
    for node_id, nr in result.nodes.items():
        mark = {"COMPLETE": "done", "CACHED": "cached"}.get(
            nr.status, nr.status
        )
        if nr.adopted:
            mark = f"adopted ({mark})"
        wall = f" ({nr.wall_clock_s:.1f}s)" if nr.wall_clock_s else ""
        err = f"  !! {nr.error}" if nr.error else ""
        print(f"  {node_id}: {mark}{wall}{err}")
    print(f"metadata: {pipeline.metadata_path}")
    return 0 if result.succeeded else 1


def cmd_lint(args) -> int:
    """``lint --pipeline-module M [--json] [--fail-on error|warn]``."""
    from tpu_pipelines_torch.analysis import (
        analyze_pipeline,
        check_metric_docs,
        check_serving_metric_docs,
        format_findings,
        gated,
        lint_report,
        sort_findings,
    )
    from tpu_pipelines_torch.utils.module_loader import load_fn

    try:
        pipeline = load_fn(args.pipeline_module, "create_pipeline")()
        findings = analyze_pipeline(
            pipeline, spmd_sync=args.spmd_sync, continuous=args.continuous,
        )
        # TPP211/TPP214 are repo-scoped (metric emissions against the
        # catalogs), not pipeline-scoped: they ride along with every lint.
        findings = sort_findings(
            list(findings)
            + check_serving_metric_docs()
            + check_metric_docs()
        )
    except Exception as e:  # noqa: BLE001 — a tool error (1), not a verdict
        print(f"lint: cannot analyze {args.pipeline_module}: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return 1
    blocking = gated(findings, args.fail_on)
    if args.json:
        report = lint_report(findings)
        report["fail_on"] = args.fail_on
        report["gated"] = len(blocking)
        print(json.dumps(report, indent=1, sort_keys=True))
    else:
        print(format_findings(findings))
        if blocking:
            print(f"lint: {len(blocking)} finding(s) at/above "
                  f"--fail-on={args.fail_on}; refusing (exit {EXIT_GATED})")
    return EXIT_GATED if blocking else 0


def cmd_continuous(args) -> int:
    """``continuous --pipeline-module M``: the long-lived controller loop.
    The first SIGINT/SIGTERM lets the in-flight pipeline run finish and
    persists state before exiting (no half-acked span, no orphaned pending
    marker); a second signal aborts through the default handler."""
    import dataclasses
    import logging
    import signal
    import threading

    from tpu_pipelines_torch.continuous import ContinuousController
    from tpu_pipelines_torch.utils.module_loader import load_fn

    logging.basicConfig(level=logging.INFO)
    try:
        cfg = load_fn(args.pipeline_module, "create_continuous")()
    except Exception as e:  # noqa: BLE001 — tool error, not a verdict
        print(f"continuous: cannot load {args.pipeline_module}: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return 1
    overrides = {}
    for field, value in (("poll_interval_s", args.poll_interval),
                         ("state_dir", args.state_dir),
                         ("lint", args.lint), ("device", args.device)):
        if value is not None:
            overrides[field] = value
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    stop = threading.Event()
    default_handlers = {}

    def on_signal(signum, frame):  # noqa: ARG001
        print(
            f"continuous: signal {signum} — draining (in-flight run "
            "finishes, state persists; signal again to abort hard)",
            file=sys.stderr,
        )
        stop.set()
        # Re-arm the default handler: the second signal kills us.
        for sig, handler in default_handlers.items():
            signal.signal(sig, handler)

    for sig in (signal.SIGINT, signal.SIGTERM):
        default_handlers[sig] = signal.getsignal(sig)
        signal.signal(sig, on_signal)
    try:
        controller = ContinuousController(cfg)
        controller.run(
            stop_event=stop,
            max_iterations=1 if args.once else args.max_iterations,
        )
    finally:
        for sig, handler in default_handlers.items():
            signal.signal(sig, handler)
    status = controller.status()
    print(f"continuous: stopped after {status['iterations']} iteration(s); "
          f"spans seen: {status['spans_seen']}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpu_pipelines_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="run a pipeline module locally")
    p_run.add_argument("--pipeline-module", required=True,
                       help="file defining create_pipeline() -> Pipeline")
    p_run.add_argument("--param", action="append", default=[],
                       metavar="NAME=VALUE",
                       help="runtime parameter override (JSON value or "
                            "string); repeatable")
    p_run.add_argument("--max-retries", type=int, default=0)
    p_run.add_argument("--max-parallel-nodes", type=int, default=None,
                       help="scheduler worker-pool size (default: DAG root "
                            "count, or TPP_MAX_PARALLEL_NODES; 1 = strict "
                            "sequential)")
    p_run.add_argument("--device", default="cuda",
                       help="device the pipeline's device nodes run on "
                            "(default cuda; cpu to run on the CPU)")
    p_run.add_argument("--from-node", action="append", default=[],
                       help="partial run: start here, upstreams from store")
    p_run.add_argument("--to-node", action="append", default=[],
                       help="partial run: stop here")
    p_run.add_argument("--resume-from", default=None, metavar="RUN_ID",
                       help="resume a crashed run ('latest' or a run id): "
                            "published nodes are adopted, orphaned ones "
                            "fenced and re-run")
    p_run.add_argument("--lint", default=None, choices=["error", "warn", "off"],
                       help="pre-flight static analysis gate (default: env "
                            "TPP_LINT, else off); 'error' refuses to run on "
                            "ERROR findings, 'warn' on any finding")

    p_lint = sub.add_parser(
        "lint",
        help="static pipeline + executor analysis; exit 0 clean, 3 on "
             "blocking findings",
    )
    p_lint.add_argument("--pipeline-module", required=True,
                        help="file defining create_pipeline() -> Pipeline")
    p_lint.add_argument("--spmd-sync", action="store_true",
                        help="lint as if running under the multi-host "
                             "spmd runner (arms TPP108: in-runner retry "
                             "policies are refused there)")
    p_lint.add_argument("--continuous", action="store_true",
                        help="lint as if handed to the continuous "
                             "controller (arms TPP111: nodes with no "
                             "deadline and no retry policy wedge the "
                             "always-on loop)")
    p_lint.add_argument("--json", action="store_true",
                        help="machine-readable output (one JSON object)")
    p_lint.add_argument("--fail-on", default="error",
                        choices=["error", "warn"],
                        help="findings at/above this severity exit 3 "
                             "(default: error)")

    p_cont = sub.add_parser(
        "continuous",
        help="run the continuous controller: watch a {SPAN} pattern, "
             "ingest new spans incrementally, retrain over a rolling "
             "window, deploy blessed models into the serving fleet",
    )
    p_cont.add_argument("--pipeline-module", required=True,
                        help="file defining create_continuous() -> "
                             "ContinuousConfig")
    p_cont.add_argument("--poll-interval", type=float, default=None,
                        metavar="SECONDS",
                        help="override the config's watcher poll interval")
    p_cont.add_argument("--state-dir", default=None,
                        help="override the config's controller state dir "
                             "(watcher acks and the in-flight run marker; "
                             "enables resume across restarts)")
    p_cont.add_argument("--max-iterations", type=int, default=0,
                        help="stop after N loop iterations (0 = run until "
                             "signalled)")
    p_cont.add_argument("--once", action="store_true",
                        help="run exactly one iteration and exit")
    p_cont.add_argument("--device", default=None,
                        help="override the config's device (cuda unless "
                             "the config says otherwise; cpu to run on the "
                             "CPU)")
    p_cont.add_argument("--lint", default=None,
                        choices=["error", "warn", "off"],
                        help="lint gate level for handed pipelines "
                             "(default: config, then env TPP_LINT); "
                             "TPP111 is armed either way")

    inspect = sub.add_parser("inspect", help="read the metadata store")
    # On the parent AND each leaf, so both argument orders work.
    inspect.add_argument("--metadata", default=None,
                         help="path to the pipeline's metadata sqlite")
    md_parent = argparse.ArgumentParser(add_help=False)
    # SUPPRESS: a leaf parse without --metadata must not clobber the value
    # the parent-level option already set.
    md_parent.add_argument("--metadata", default=argparse.SUPPRESS)
    isub = inspect.add_subparsers(dest="what", required=True)

    p_runs = isub.add_parser("runs", parents=[md_parent],
                             help="runs + per-node duration/state columns")
    p_runs.add_argument("pipeline", help="pipeline name")
    p_runs.add_argument("--pipeline-root", default="",
                        help="pipeline root; adds trace-derived columns "
                             "(queue wait) from <root>/.runs/<id>/trace")
    p_runs.add_argument("--json", action="store_true",
                        help="machine-readable output (one JSON object)")

    p_lin = isub.add_parser("lineage", parents=[md_parent],
                            help="provenance chain of an artifact")
    p_lin.add_argument("artifact_id", type=int)

    p_art = isub.add_parser("artifacts", parents=[md_parent],
                            help="list artifacts")
    p_art.add_argument("--type", default="", help="filter by artifact type")

    p_trace = sub.add_parser(
        "trace",
        help="summarize/export a run's trace, or compare two runs "
             "(trace diff <a> <b>)",
    )
    p_trace.add_argument(
        "run_id", nargs="+",
        help="run id or 'latest'; or: diff <run-a> <run-b>",
    )
    p_trace.add_argument("--pipeline-root", default="",
                         help="pipeline root containing .runs/<run-id>/")
    p_trace.add_argument("--perfetto", default="", metavar="OUT_JSON",
                         help="write a Chrome/Perfetto trace.json here")
    p_trace.add_argument("--metrics", default="", metavar="OUT_JSON",
                         help="write the metrics.json summary here")
    p_trace.add_argument("--json", action="store_true",
                         help="machine-readable output (one JSON object)")
    p_trace.add_argument(
        "--threshold", type=float, default=0.2,
        help="diff regression threshold as a fraction (default 0.2 = "
             "20%% slower flags; exit code 3 on any flag)",
    )

    p_drift = sub.add_parser(
        "drift",
        help="live drift and skew report off a serving fleet's /metrics "
             "scrape (observability/drift.py)",
    )
    p_drift.add_argument(
        "--url", required=True,
        help="serving base URL (the Pusher push-URL works, e.g. "
             "http://127.0.0.1:8501/v1/models/bert — only scheme+host are "
             "used; /metrics is derived)",
    )
    p_drift.add_argument("--json", action="store_true",
                         help="machine-readable output (one JSON object)")
    p_drift.add_argument(
        "--fail-on-alert", action="store_true",
        help="exit 3 when the fleet has counted any drift/skew alert",
    )

    args = parser.parse_args(argv)
    if args.cmd == "run":
        return cmd_run(args)
    if args.cmd == "lint":
        return cmd_lint(args)
    if args.cmd == "continuous":
        return cmd_continuous(args)
    if args.cmd == "trace":
        return cmd_trace(args)
    if args.cmd == "drift":
        return cmd_drift(args)
    if not args.metadata:
        inspect.error("the following arguments are required: --metadata")
    store = MetadataStore(args.metadata)
    try:
        if args.what == "runs":
            return cmd_runs(
                store, args.pipeline, args.pipeline_root,
                as_json=args.json,
            )
        if args.what == "lineage":
            return cmd_lineage(store, args.artifact_id)
        return cmd_artifacts(store, args.type)
    finally:
        store.close()


if __name__ == "__main__":
    sys.exit(main())
