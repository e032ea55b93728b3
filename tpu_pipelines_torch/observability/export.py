"""RunTrace exporters, the run half of
``tpu_pipelines/observability/export.py``: Perfetto timeline, metrics
summary, run diff.

Consumers of ``events.jsonl`` (see trace.py for the event schema):

  * :func:`export_perfetto`: Chrome trace-event JSON (``trace.json``)
    loadable in https://ui.perfetto.dev or ``chrome://tracing``, one track
    per thread (the scheduler thread, the ``tpp-node-*`` workers, the
    shard pool's threads).
  * :func:`compute_metrics`: the machine-readable summary
    (``metrics.json``): per-node durations and states, the *measured*
    critical path (longest upstream chain by scheduler-span durations),
    queue and device-gate wait totals, cache-hit ratio, executor/publish
    phase totals, metadata-op latencies, per-pool shard skew and the
    train loop's goodput and telemetry summaries.
  * :func:`diff_metrics` / :func:`format_diff`: two runs node by node,
    with regression flags past a threshold (``trace diff``).

The request-trace half reads the serving event log
(``<trace_dir>/serving/events.jsonl``, observability/request_trace.py):

  * :func:`to_perfetto_requests` / :func:`export_perfetto_requests`: one
    process per replica (its batch groups as threads) and one frontend
    process whose threads are the traced requests;
  * :func:`summarize_request_traces` / :func:`format_request_traces`: the
    ``trace serve`` payload and table, one entry per trace id.

Readers are truncation-tolerant: :func:`read_events` skips anything that
does not parse.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional


def read_events(path: str) -> List[Dict[str, Any]]:
    """Parse an events.jsonl, skipping truncated/corrupt lines."""
    events: List[Dict[str, Any]] = []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue  # SIGKILL mid-append: at most the tail line
            if isinstance(obj, dict) and "ev" in obj:
                events.append(obj)
    return events


# ------------------------------------------------------------- perfetto


def to_perfetto(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Chrome trace-event document for a run's event list."""
    trace_events: List[Dict[str, Any]] = []
    seen_threads: set = set()
    seen_procs: set = set()
    run_id = next((e.get("run", "") for e in events if e.get("run")), "")
    orchestrator_pid = events[0]["pid"] if events else 0
    for e in events:
        pid, tid = e.get("pid", 0), e.get("tid", 0)
        if pid not in seen_procs:
            seen_procs.add(pid)
            label = (
                f"pipeline run {run_id}" if pid == orchestrator_pid
                else f"shard pool worker {pid}"
            )
            trace_events.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": label},
            })
        if (pid, tid) not in seen_threads:
            seen_threads.add((pid, tid))
            trace_events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": e.get("thread", str(tid))},
            })
        args = dict(e.get("args") or {})
        if e.get("node"):
            args["node"] = e["node"]
        base = {
            "name": e.get("name", ""),
            "cat": e.get("cat", "") or "trace",
            "pid": pid,
            "tid": tid,
            "ts": round(e.get("ts", 0.0) * 1e6, 1),   # wall epoch µs
            "args": args,
        }
        if e.get("ev") == "span":
            base["ph"] = "X"
            base["dur"] = round(e.get("dur", 0.0) * 1e6, 1)
        else:
            base["ph"] = "i"
            base["s"] = "t"  # thread-scoped instant
        trace_events.append(base)
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def export_perfetto(events: List[Dict[str, Any]], out_path: str) -> str:
    doc = to_perfetto(events)
    parent = os.path.dirname(os.path.abspath(out_path))
    os.makedirs(parent, exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return out_path


# ----------------------------------------------- request-trace exporters


def to_perfetto_requests(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Chrome trace-event document for a serving request-trace event log
    (observability/request_trace.py schema).

    Track layout mirrors how serving time is actually spent: one process
    group per REPLICA (its batch groups as threads — every coalesced
    device call is its own track, so the gather window and the step are
    visually adjacent), one "frontend" process whose threads are the
    traced requests (root span + admission/route per trace).
    """
    trace_events: List[Dict[str, Any]] = []
    FRONTEND_PID = 1
    replica_pids: Dict[str, int] = {}
    group_tids: Dict[tuple, int] = {}
    trace_tids: Dict[str, int] = {}
    named: set = set()

    def _name(pid: int, tid: int, kind: str, label: str) -> None:
        if (kind, pid, tid) in named:
            return
        named.add((kind, pid, tid))
        trace_events.append({
            "name": f"{kind}_name", "ph": "M", "pid": pid,
            "tid": tid if kind == "thread" else 0,
            "args": {"name": label},
        })

    def _replica_pid(replica: str) -> int:
        pid = replica_pids.get(replica)
        if pid is None:
            pid = replica_pids[replica] = 100 + len(replica_pids)
            _name(pid, 0, "process", f"replica {replica}")
        return pid

    _name(FRONTEND_PID, 0, "process", "serving frontend")
    for e in events:
        args = dict(e.get("args") or {})
        trace_id = e.get("trace", "")
        replica = str(args.get("replica", "")) if args.get(
            "replica", ""
        ) != "" else ""
        group = args.get("group")
        if replica and group is not None:
            pid = _replica_pid(replica)
            key = (replica, str(group))
            tid = group_tids.get(key)
            if tid is None:
                tid = group_tids[key] = len(group_tids) + 1
                _name(pid, tid, "thread", f"group {group}")
        elif replica:
            pid = _replica_pid(replica)
            tid = 0
            _name(pid, tid, "thread", "replica")
        else:
            pid = FRONTEND_PID
            tid = trace_tids.get(trace_id)
            if tid is None:
                tid = trace_tids[trace_id] = len(trace_tids) + 1
                _name(pid, tid, "thread", f"trace {trace_id[:8]}")
        if trace_id:
            args["trace"] = trace_id
        base = {
            "name": e.get("name", ""),
            "cat": e.get("cat", "") or "request",
            "pid": pid,
            "tid": tid,
            "ts": round(e.get("ts", 0.0) * 1e6, 1),
            "args": args,
        }
        if e.get("ev") == "span":
            base["ph"] = "X"
            base["dur"] = round(e.get("dur", 0.0) * 1e6, 1)
        else:
            base["ph"] = "i"
            base["s"] = "t"
        trace_events.append(base)
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def export_perfetto_requests(
    events: List[Dict[str, Any]], out_path: str
) -> str:
    doc = to_perfetto_requests(events)
    parent = os.path.dirname(os.path.abspath(out_path))
    os.makedirs(parent, exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return out_path


def summarize_request_traces(
    events: List[Dict[str, Any]]
) -> Dict[str, Any]:
    """Per-trace summary of a serving event log: the ``trace serve`` CLI
    payload.  One entry per trace id (root request span + its child
    spans/instants folded in), plus the exemplar markers scrapes left."""
    traces: Dict[str, Dict[str, Any]] = {}
    exemplars: List[Dict[str, Any]] = []
    for e in events:
        trace_id = e.get("trace", "")
        name = e.get("name", "")
        args = dict(e.get("args") or {})
        if name == "exemplar":
            exemplars.append({
                "trace_id": args.get("trace_id", trace_id),
                "endpoint": args.get("endpoint", ""),
                "latency_s": args.get("latency_s"),
                "ts": e.get("ts"),
            })
            continue
        if name == "slo/burn_alert":
            continue
        if not trace_id:
            continue
        t = traces.setdefault(trace_id, {
            "trace_id": trace_id, "spans": [], "instants": [],
        })

        def _put(key: str, value: Any) -> None:
            if value is not None and t.get(key) is None:
                t[key] = value

        if name == "request" and e.get("ev") == "span":
            t["endpoint"] = args.get("endpoint", e.get("endpoint", ""))
            t["code"] = args.get("code")
            t["latency_s"] = e.get("dur")
            t["start_ts"] = e.get("ts")
            _put("version", args.get("version"))
            _put("replica", args.get("replica"))
        elif e.get("ev") == "span":
            t["spans"].append({
                "name": name, "dur_s": e.get("dur"), "ts": e.get("ts"),
                **args,
            })
            if name == "model.step":
                _put("version", args.get("version"))
            _put("replica", args.get("replica"))
            _put("group", args.get("group"))
        else:
            t["instants"].append({
                "name": name, "ts": e.get("ts"), **args,
            })
            if name == "route":
                _put("replica", args.get("replica"))
    return {
        "schema_version": 1,
        "traces": traces,
        "trace_count": len(traces),
        "exemplars": exemplars,
    }


def format_request_traces(summary: Dict[str, Any]) -> str:
    """Human-readable ``trace serve`` table (newest last)."""
    lines: List[str] = []
    lines.append(
        f"{'trace':<34} {'endpoint':<9} {'code':>5} {'ms':>9} "
        f"{'replica':>7} {'version':>8}  spans"
    )
    traces = sorted(
        summary.get("traces", {}).values(),
        key=lambda t: t.get("start_ts") or 0.0,
    )
    for t in traces:
        dur = t.get("latency_s")
        spans = ",".join(sorted({s["name"] for s in t.get("spans", [])}))
        lines.append(
            f"{t['trace_id']:<34} {t.get('endpoint', '') or '-':<9} "
            f"{str(t.get('code', '-')):>5} "
            f"{(dur * 1e3 if dur is not None else float('nan')):>9.2f} "
            f"{str(t.get('replica', '-') or '-'):>7} "
            f"{str(t.get('version', '-') or '-'):>8}  {spans}"
        )
    return "\n".join(lines)


# -------------------------------------------------------------- metrics


def _critical_path(per_node: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Longest upstream chain by measured node durations.

    Edges come from the ``upstream`` list each scheduler node span
    carries; nodes whose span never landed (crash) contribute nothing.
    Kahn-style relaxation — the recorded DAG is acyclic by construction.
    """
    best: Dict[str, float] = {}
    prev: Dict[str, Optional[str]] = {}
    remaining = dict(per_node)
    # Repeated passes until fixpoint (bounded by node count): settle any
    # node all of whose recorded upstreams are settled.
    for _ in range(len(remaining) + 1):
        progressed = False
        for nid, info in list(remaining.items()):
            ups = [u for u in info.get("upstream", []) if u in per_node]
            if any(u not in best for u in ups):
                continue
            base = max((best[u] for u in ups), default=0.0)
            prev[nid] = max(ups, key=lambda u: best[u]) if ups else None
            best[nid] = base + info.get("wall_s", 0.0)
            del remaining[nid]
            progressed = True
        if not progressed:
            break
    if not best:
        return {"nodes": [], "seconds": 0.0}
    end = max(best, key=lambda n: best[n])
    path = [end]
    while prev.get(path[-1]):
        path.append(prev[path[-1]])  # type: ignore[arg-type]
    return {
        "nodes": list(reversed(path)),
        "seconds": round(best[end], 4),
    }


def compute_metrics(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """metrics.json content: the run's measured time decomposition."""
    per_node: Dict[str, Dict[str, Any]] = {}
    queue_wait_total = 0.0
    gate_wait_total = 0.0
    cache_hits = 0
    cache_misses = 0
    phase_totals: Dict[str, float] = {}
    store_ops: Dict[str, Dict[str, Any]] = {}
    shard_pools: Dict[str, List[float]] = {}
    goodput: Optional[Dict[str, Any]] = None
    train_telemetry: Optional[Dict[str, Any]] = None
    run_span = {"start": None, "end": None, "succeeded": None}
    deadline_expiries: List[str] = []
    adopted: List[str] = []

    for e in events:
        name, cat, ev = e.get("name"), e.get("cat"), e.get("ev")
        node = e.get("node", "")
        args = e.get("args") or {}
        dur = float(e.get("dur", 0.0) or 0.0)
        if cat == "scheduler" and name == "node" and ev == "span":
            info = {
                "status": args.get("status", ""),
                "wall_s": round(dur, 4),
                "queue_wait_s": round(float(args.get("queue_wait_s", 0.0)), 4),
                "gate_wait_s": round(float(args.get("gate_wait_s", 0.0)), 4),
                "upstream": list(args.get("upstream", [])),
                "execution_id": args.get("execution_id", 0),
                "start_ts": e.get("ts", 0.0),
                "end_ts": e.get("ts", 0.0) + dur,
            }
            # A resumed run appends a second span for re-run nodes; the
            # latest verdict wins (same rule as the metadata store).
            per_node[node] = info
            queue_wait_total += info["queue_wait_s"]
            gate_wait_total += info["gate_wait_s"]
        elif cat == "scheduler" and name == "cache_hit":
            cache_hits += 1
        elif cat == "scheduler" and name == "cache_miss":
            cache_misses += 1
        elif cat == "scheduler" and name == "deadline_expired":
            deadline_expiries.append(node)
        elif cat == "run" and name == "resume_adopt":
            adopted.append(node)
        elif cat in ("executor", "scheduler") and ev == "span" and name in (
            "executor", "fingerprint", "publish", "driver"
        ):
            phase_totals[name] = phase_totals.get(name, 0.0) + dur
        elif cat == "metadata" and ev == "span":
            op = store_ops.setdefault(
                name or "op", {"count": 0, "total_s": 0.0}
            )
            op["count"] += 1
            op["total_s"] += dur
        elif cat == "data" and name == "shard" and ev == "span":
            shard_pools.setdefault(
                str(args.get("label", "shards")), []
            ).append(dur)
        elif cat == "trainer" and name == "goodput_summary":
            goodput = args or None
        elif cat == "trainer" and name == "train_telemetry_summary":
            train_telemetry = args or None
        elif cat == "run" and name == "run_start":
            if run_span["start"] is None:
                run_span["start"] = e.get("ts")
        elif cat == "run" and name == "run_end":
            run_span["end"] = e.get("ts")
            run_span["succeeded"] = args.get("succeeded")

    for op in store_ops.values():
        op["total_s"] = round(op["total_s"], 4)
    shards = {
        label: {
            "count": len(durs),
            "total_s": round(sum(durs), 4),
            "max_s": round(max(durs), 4),
            "mean_s": round(sum(durs) / len(durs), 4),
            # Straggler factor: 1.0 = perfectly balanced shards.
            "skew": round(
                max(durs) / (sum(durs) / len(durs)), 3
            ) if sum(durs) else None,
        }
        for label, durs in shard_pools.items() if durs
    }
    walls = [i["wall_s"] for i in per_node.values()]
    cp = _critical_path(per_node)
    measured_wall = None
    if run_span["start"] is not None and run_span["end"] is not None:
        measured_wall = round(run_span["end"] - run_span["start"], 4)
    return {
        "schema_version": 1,
        "per_node": per_node,
        "node_count": len(per_node),
        "span_duration_total_s": round(sum(walls), 4),
        "longest_node_s": round(max(walls), 4) if walls else 0.0,
        "longest_node": (
            max(per_node, key=lambda n: per_node[n]["wall_s"])
            if per_node else None
        ),
        "critical_path_nodes": cp["nodes"],
        "critical_path_measured_s": cp["seconds"],
        "queue_wait_total_s": round(queue_wait_total, 4),
        "gate_wait_total_s": round(gate_wait_total, 4),
        "cache_hits": cache_hits,
        "cache_misses": cache_misses,
        "cache_hit_ratio": (
            round(cache_hits / (cache_hits + cache_misses), 4)
            if (cache_hits + cache_misses) else None
        ),
        "phase_totals_s": {
            k: round(v, 4) for k, v in sorted(phase_totals.items())
        },
        "store_ops": store_ops,
        "shard_pools": shards,
        "deadline_expiries": deadline_expiries,
        "adopted_nodes": sorted(set(adopted)),
        "goodput": goodput,
        "train_telemetry": train_telemetry,
        "run_wall_s": measured_wall,
        "run_succeeded": run_span["succeeded"],
    }


def export_metrics(events: List[Dict[str, Any]], out_path: str) -> str:
    metrics = compute_metrics(events)
    parent = os.path.dirname(os.path.abspath(out_path))
    os.makedirs(parent, exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(metrics, f, indent=1, sort_keys=True)
    return out_path


# ----------------------------------------------------------- trace diff


def diff_metrics(
    run_a: Dict[str, Any],
    run_b: Dict[str, Any],
    threshold: float = 0.2,
    min_abs_s: float = 0.05,
) -> Dict[str, Any]:
    """Compare two runs' ``compute_metrics`` summaries: per-node
    duration/wait deltas, cache-hit delta, critical-path delta, and
    regression flags.

    ``run_a`` is the baseline, ``run_b`` the candidate.  A node (or the
    critical path) is flagged as a regression when the candidate is more
    than ``threshold`` slower AND the absolute growth exceeds
    ``min_abs_s`` (relative thresholds alone flag microsecond noise on
    tiny nodes).  Inputs are duck-typed: any dict carrying ``per_node``
    and the headline keys works, so bench summaries diff as well as full
    metrics.json payloads.
    """
    nodes_a = run_a.get("per_node") or {}
    nodes_b = run_b.get("per_node") or {}
    per_node: Dict[str, Dict[str, Any]] = {}
    regressions: List[Dict[str, Any]] = []

    def rel(a: float, b: float):
        return round(b / a - 1.0, 4) if a else None

    for nid in sorted(set(nodes_a) | set(nodes_b)):
        a, b = nodes_a.get(nid), nodes_b.get(nid)
        if a is None or b is None:
            per_node[nid] = {
                "only_in": "b" if a is None else "a",
                "wall_a_s": a.get("wall_s") if a else None,
                "wall_b_s": b.get("wall_s") if b else None,
            }
            continue
        wall_a = float(a.get("wall_s", 0.0))
        wall_b = float(b.get("wall_s", 0.0))
        entry = {
            "wall_a_s": round(wall_a, 4),
            "wall_b_s": round(wall_b, 4),
            "wall_delta_s": round(wall_b - wall_a, 4),
            "wall_delta_frac": rel(wall_a, wall_b),
            "queue_wait_delta_s": round(
                float(b.get("queue_wait_s", 0.0))
                - float(a.get("queue_wait_s", 0.0)), 4,
            ),
            "status_a": a.get("status", ""),
            "status_b": b.get("status", ""),
            # CACHED<->COMPLETE flips explain most wall deltas; surface
            # them next to the numbers instead of leaving a mystery.
            "cache_flip": (
                a.get("status") != b.get("status")
                and "CACHED" in (a.get("status"), b.get("status"))
            ),
            "regressed": False,
        }
        if (
            wall_b - wall_a > min_abs_s
            and wall_a > 0
            and wall_b > wall_a * (1.0 + threshold)
            and not entry["cache_flip"]
        ):
            entry["regressed"] = True
            regressions.append({
                "metric": f"{nid}.wall_s",
                "a": round(wall_a, 4),
                "b": round(wall_b, 4),
                "frac": entry["wall_delta_frac"],
            })
        per_node[nid] = entry

    cp_a = float(run_a.get("critical_path_measured_s") or 0.0)
    cp_b = float(run_b.get("critical_path_measured_s") or 0.0)
    if cp_b - cp_a > min_abs_s and cp_a > 0 and cp_b > cp_a * (
        1.0 + threshold
    ):
        regressions.append({
            "metric": "critical_path_measured_s",
            "a": round(cp_a, 4),
            "b": round(cp_b, 4),
            "frac": rel(cp_a, cp_b),
        })

    def _get(d, key):
        v = d.get(key)
        return float(v) if v is not None else None

    # Training-telemetry regressions (from the train_telemetry_summary
    # instant or a MetricsHistory headline — both carry the same keys).
    tt_a = run_a.get("train_telemetry") or {}
    tt_b = run_b.get("train_telemetry") or {}
    train_telemetry_diff: Dict[str, Any] = {}
    if tt_a or tt_b:
        def _share(tt: Dict[str, Any]) -> Optional[float]:
            if tt.get("infeed_wait_share") is not None:
                return float(tt["infeed_wait_share"])
            phases = tt.get("window_phase_seconds") or {}
            total = sum(phases.values())
            if not total:
                return None
            return float(phases.get("infeed_wait", 0.0)) / total

        share_a, share_b = _share(tt_a), _share(tt_b)
        comp_a = float(tt_a.get("compiles_after_warm") or 0.0)
        comp_b = float(tt_b.get("compiles_after_warm") or 0.0)
        train_telemetry_diff = {
            "infeed_wait_share_a": (
                round(share_a, 4) if share_a is not None else None
            ),
            "infeed_wait_share_b": (
                round(share_b, 4) if share_b is not None else None
            ),
            "compiles_after_warm_a": int(comp_a),
            "compiles_after_warm_b": int(comp_b),
            "mfu_a": _get(tt_a, "mfu"),
            "mfu_b": _get(tt_b, "mfu"),
        }
        # Input-bound drift: the candidate spends a materially larger
        # share of the window waiting on the host pipeline.  The 0.05
        # absolute floor plays the min_abs_s role for a ratio.
        if (
            share_a is not None and share_b is not None
            and share_b - share_a > max(0.05, share_a * threshold)
        ):
            regressions.append({
                "metric": "train_telemetry.infeed_wait_share",
                "a": round(share_a, 4),
                "b": round(share_b, 4),
                "frac": rel(share_a, share_b),
            })
        # Any growth in mid-run recompiles is a stall regression.
        if comp_b > comp_a:
            regressions.append({
                "metric": "train_telemetry.compiles_after_warm",
                "a": comp_a,
                "b": comp_b,
                "frac": rel(comp_a, comp_b),
            })

    cache_a = _get(run_a, "cache_hit_ratio")
    cache_b = _get(run_b, "cache_hit_ratio")
    return {
        "schema_version": 1,
        "threshold": threshold,
        "min_abs_s": min_abs_s,
        "per_node": per_node,
        "critical_path_a_s": round(cp_a, 4),
        "critical_path_b_s": round(cp_b, 4),
        "critical_path_delta_s": round(cp_b - cp_a, 4),
        "critical_path_delta_frac": rel(cp_a, cp_b),
        "queue_wait_delta_s": round(
            (float(run_b.get("queue_wait_total_s") or 0.0))
            - (float(run_a.get("queue_wait_total_s") or 0.0)), 4,
        ),
        "cache_hit_ratio_a": cache_a,
        "cache_hit_ratio_b": cache_b,
        "train_telemetry": train_telemetry_diff,
        "regression_flags": [r["metric"] for r in regressions],
        "regressions": regressions,
        "regressed": bool(regressions),
    }


def format_diff(diff: Dict[str, Any]) -> str:
    """Human-readable ``trace diff`` table."""
    lines: List[str] = []
    lines.append(
        f"critical path {diff['critical_path_a_s']}s -> "
        f"{diff['critical_path_b_s']}s "
        f"(delta {diff['critical_path_delta_s']:+}s"
        + (
            f", {diff['critical_path_delta_frac']:+.1%}"
            if diff["critical_path_delta_frac"] is not None else ""
        )
        + f") · threshold {diff['threshold']:.0%}"
    )
    lines.append(
        f"{'node':<24} {'a_s':>9} {'b_s':>9} {'delta_s':>9} "
        f"{'delta%':>8}  flag"
    )
    for nid, e in sorted(
        diff["per_node"].items(),
        key=lambda kv: -(kv[1].get("wall_delta_s") or 0.0),
    ):
        if "only_in" in e:
            lines.append(
                f"{nid:<24} {'-':>9} {'-':>9} {'-':>9} {'-':>8}  "
                f"only in run {e['only_in']}"
            )
            continue
        frac = e["wall_delta_frac"]
        flag = (
            "REGRESSED" if e["regressed"]
            else ("cache-flip" if e["cache_flip"] else "")
        )
        lines.append(
            f"{nid:<24} {e['wall_a_s']:>9.3f} {e['wall_b_s']:>9.3f} "
            f"{e['wall_delta_s']:>+9.3f} "
            f"{(f'{frac:+.1%}' if frac is not None else '-'):>8}  {flag}"
        )
    tt = diff.get("train_telemetry") or {}
    if tt:
        def _fmt(v, pct=False):
            if v is None:
                return "-"
            return f"{v:.1%}" if pct else f"{v}"

        lines.append(
            "train telemetry: infeed_wait "
            f"{_fmt(tt.get('infeed_wait_share_a'), pct=True)} -> "
            f"{_fmt(tt.get('infeed_wait_share_b'), pct=True)} · "
            "compiles_after_warm "
            f"{tt.get('compiles_after_warm_a', 0)} -> "
            f"{tt.get('compiles_after_warm_b', 0)} · mfu "
            f"{_fmt(tt.get('mfu_a'))} -> {_fmt(tt.get('mfu_b'))}"
        )
    if diff["regressions"]:
        # frac is None when the baseline was 0 (e.g. compiles_after_warm
        # 0 -> N) — show the absolute move instead of crashing on it.
        lines.append(
            "regressions: " + ", ".join(
                f"{r['metric']} ({r['frac']:+.1%})"
                if r.get("frac") is not None
                else f"{r['metric']} ({r['a']} -> {r['b']})"
                for r in diff["regressions"]
            )
        )
    else:
        lines.append("no regressions at this threshold")
    return "\n".join(lines)


def format_summary(metrics: Dict[str, Any]) -> str:
    """Human-readable run profile for the ``trace`` CLI."""
    lines: List[str] = []
    wall = metrics.get("run_wall_s")
    lines.append(
        f"run wall {wall}s · critical path "
        f"{metrics['critical_path_measured_s']}s "
        f"({' -> '.join(metrics['critical_path_nodes']) or '<none>'})"
    )
    lines.append(
        f"queue wait {metrics['queue_wait_total_s']}s · tpu-gate wait "
        f"{metrics['gate_wait_total_s']}s · cache hit ratio "
        f"{metrics['cache_hit_ratio']}"
    )
    header = (
        f"{'node':<24} {'status':<12} {'wall_s':>9} {'queue_s':>8} "
        f"{'gate_s':>8}"
    )
    lines.append(header)
    for nid, info in sorted(
        metrics.get("per_node", {}).items(),
        key=lambda kv: -kv[1]["wall_s"],
    ):
        lines.append(
            f"{nid:<24} {info['status']:<12} {info['wall_s']:>9.3f} "
            f"{info['queue_wait_s']:>8.3f} {info['gate_wait_s']:>8.3f}"
        )
    if metrics.get("phase_totals_s"):
        lines.append(
            "phases: " + "  ".join(
                f"{k}={v}s" for k, v in metrics["phase_totals_s"].items()
            )
        )
    for label, pool in (metrics.get("shard_pools") or {}).items():
        lines.append(
            f"shards[{label}]: n={pool['count']} total={pool['total_s']}s "
            f"max={pool['max_s']}s skew={pool['skew']}"
        )
    if metrics.get("store_ops"):
        lines.append(
            "store:  " + "  ".join(
                f"{k}x{v['count']}={v['total_s']}s"
                for k, v in sorted(metrics["store_ops"].items())
            )
        )
    gp = metrics.get("goodput")
    if gp:
        lines.append(f"goodput: {gp}")
    tt = metrics.get("train_telemetry")
    if tt:
        phases = tt.get("window_phase_seconds") or {}
        total = sum(phases.values())
        if total > 0:
            lines.append(
                "train phases: " + "  ".join(
                    f"{k}={v}s ({v / total:.0%})"
                    for k, v in sorted(phases.items())
                )
            )
        tail = []
        if tt.get("mfu") is not None:
            tail.append(f"mfu={tt['mfu']}")
        tail.append(
            f"compiles_after_warm={tt.get('compiles_after_warm', 0)}"
        )
        lines.append("train telemetry: " + "  ".join(tail))
    return "\n".join(lines)
