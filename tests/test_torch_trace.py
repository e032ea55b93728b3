"""Port parity: the run trace (``tpu_pipelines_torch/observability/trace.py``
and the run half of ``export.py``) and the runner's tracing and run
telemetry, against the reference's ``tpu_pipelines/observability``, on the
CPU.  Mirrors tests/test_observability.py.

  - the recorder writes the reference's event schema for the same calls
    (every key and value equal but the clocks: ``ts``, ``mono``, ``dur``);
  - ``compute_metrics``, ``to_perfetto``, ``diff_metrics``,
    ``format_summary`` and ``format_diff`` on one fixed event log equal the
    reference's exactly;
  - a host-only DAG (CsvExampleGen -> StatisticsGen -> SchemaGen over
    tests/testdata/taxi_sample.csv) through both runners gives the same set
    of (cat, name, node) events, statuses, critical-path nodes and
    cache-hit ratio, 0.0 cold and 1.0 warm.  One event of the reference
    has no counterpart: the ``map_shards`` pool span of its resilient
    shard map (the port's data plane maps shards with ``thread_map``; the
    resilient pools are ROADMAP.md A21).  The reference runs its pool on
    threads here (``TPP_DATA_POOL=thread``): a fork in a process where JAX
    runs threads can deadlock;
  - ``TPP_TRACE=0`` leaves no ``.runs/``;
  - ``TPP_METRICS_PORT`` serves the ``pipeline_nodes_*`` gauges and
    ``pipeline_run_info`` during a run, as the reference's runner does.
"""

import copy
import json
import os
import socket
import threading
import urllib.request

import pytest

from tpu_pipelines import components as ref_components
from tpu_pipelines.dsl import component as ref_component_mod
from tpu_pipelines.dsl.pipeline import Pipeline as RefPipeline
from tpu_pipelines.observability import export as ref_export
from tpu_pipelines.observability import trace as ref_trace
from tpu_pipelines.orchestration import LocalDagRunner as RefRunner
from tpu_pipelines_torch import components as port_components
from tpu_pipelines_torch.dsl import component as port_component_mod
from tpu_pipelines_torch.dsl.pipeline import Pipeline as PortPipeline
from tpu_pipelines_torch.observability import export as port_export
from tpu_pipelines_torch.observability import trace as port_trace
from tpu_pipelines_torch.orchestration import LocalDagRunner as PortRunner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSV = os.path.join(REPO, "tests", "testdata", "taxi_sample.csv")
CLOCKS = ("ts", "mono", "dur")
# The reference's process-pool span (ROADMAP.md A21 in the port).
REF_ONLY = {("data", "map_shards", "")}


def _drive(recorder):
    recorder.instant("run_start", cat="run", args={"pipeline": "p", "n": 3})
    recorder.instant("cache_miss", cat="scheduler", node="A")
    recorder.complete("node", "scheduler", "A", 100.0, 5.0, 0.25,
                      args={"status": "COMPLETE", "upstream": []})
    with recorder.span("executor", cat="executor", node="A",
                       args={"attempt": 1}) as extra:
        extra["ok"] = True
    with recorder.span("driver", cat="scheduler", node="B"):
        pass
    recorder.instant("run_end", cat="run", args={"succeeded": True})
    recorder.close()
    recorder.instant("after_close", cat="run")   # a no-op after close


def _lines(recorder):
    with open(recorder.events_path) as f:
        events = [json.loads(line) for line in f]
    return [{k: v for k, v in e.items() if k not in CLOCKS} for e in events]


def test_the_recorder_writes_the_reference_schema(tmp_path):
    ref = ref_trace.TraceRecorder(str(tmp_path / "ref"), "run-1")
    port = port_trace.TraceRecorder(str(tmp_path / "port"), "run-1")
    _drive(ref)
    _drive(port)
    assert _lines(port) == _lines(ref)
    assert len(_lines(port)) == 6
    assert os.path.relpath(port.events_path, tmp_path / "port") == \
        os.path.relpath(ref.events_path, tmp_path / "ref") == \
        os.path.join("trace", "events.jsonl")
    assert port_trace.events_path("/r", "x") == ref_trace.events_path("/r", "x")


def test_a_torn_last_line_is_skipped_and_a_resumed_log_starts_fresh(tmp_path):
    for trace, export, sub in ((ref_trace, ref_export, "ref"),
                               (port_trace, port_export, "port")):
        rec = trace.TraceRecorder(str(tmp_path / sub), "r")
        rec.instant("run_start", cat="run")
        rec.close()
        with open(rec.events_path, "a") as f:
            f.write('{"v": 1, "ev": "span", "na')     # killed mid-append
        again = trace.TraceRecorder(str(tmp_path / sub), "r")
        again.instant("run_end", cat="run")
        again.close()
    got = [e["name"] for e in port_export.read_events(
        str(tmp_path / "port" / "trace" / "events.jsonl"))]
    want = [e["name"] for e in ref_export.read_events(
        str(tmp_path / "ref" / "trace" / "events.jsonl"))]
    assert got == want == ["run_start", "run_end"]


def _event(ev, name, cat, node="", ts=0.0, dur=None, args=None, tid=1,
           thread="MainThread", pid=7):
    e = {"v": 1, "ev": ev, "name": name, "cat": cat, "node": node,
         "run": "run-1", "pid": pid, "tid": tid, "thread": thread,
         "ts": ts, "mono": ts}
    if dur is not None:
        e["dur"] = dur
    if args:
        e["args"] = args
    return e


def _fixed_log(scale=1.0):
    nodes = (("Gen", [], 0.0, 1.0), ("Stats", ["Gen"], 1.0, 2.0 * scale),
             ("Schema", ["Stats"], 3.0 * scale, 0.5),
             ("Train", ["Gen", "Schema"], 3.5 * scale, 4.0 * scale))
    log = [_event("instant", "run_start", "run", ts=0.0,
                  args={"pipeline": "p", "max_parallel_nodes": 2})]
    for i, (node, ups, t0, dur) in enumerate(nodes):
        log += [
            _event("span", "driver", "scheduler", node, t0, 0.01),
            _event("instant", "cache_miss" if node != "Gen" else "cache_hit",
                   "scheduler", node, t0),
            _event("span", "get_cached_outputs", "metadata", "", t0, 0.002),
            _event("span", "executor", "executor", node, t0, dur * 0.9,
                   args={"attempt": 1, "ok": True}, tid=2 + i,
                   thread=f"tpp-node_{i}"),
            _event("span", "fingerprint", "executor", node, t0 + dur * 0.9,
                   0.01, tid=2 + i, thread=f"tpp-node_{i}"),
            _event("span", "publish", "executor", node, t0 + dur * 0.95, 0.02,
                   args={"state": "COMPLETE"}, tid=2 + i),
            _event("span", "publish_execution", "metadata", node,
                   t0 + dur * 0.95, 0.015, args={"state": "COMPLETE"}),
            _event("span", "node", "scheduler", node, t0, dur, args={
                "status": "COMPLETE" if node != "Gen" else "CACHED",
                "execution_id": i + 1, "retries": 0,
                "queue_wait_s": 0.001 * i, "gate_wait_s": 0.0005 * i,
                "upstream": ups}),
        ]
    for shard in range(3):
        log.append(_event("span", "shard", "data", "", 1.2 + shard,
                          0.1 * (shard + 1) * scale,
                          args={"label": "thread_map", "shard": shard,
                                "pool": "thread"}, tid=20 + shard,
                          thread=f"ThreadPoolExecutor-0_{shard}"))
    log += [
        _event("instant", "window_breakdown", "trainer", ts=5.0, args={
            "step": 8, "window_steps": 4, "window_s": 0.4,
            "infeed_wait": 0.01, "device_compute": 0.35,
            "device_collective": 0.0, "host": 0.04}),
        _event("instant", "goodput_summary", "trainer", ts=7.0, args={
            "goodput": 0.97, "source": "host_input_wait_proxy", "badput": {},
            "goodput_post_compile": 0.97, "steps_completed": 100,
            "replayed_steps": 0}),
        _event("instant", "train_telemetry_summary", "trainer", ts=7.0, args={
            "window_phase_seconds": {"infeed_wait": 0.1, "host": 0.2,
                                     "device_compute": 3.0 * scale,
                                     "device_collective": 0.0},
            "compiles_after_warm": 0, "compile_seconds": 0.8,
            "collective_fraction_est": 0.0, "mfu": None, "window_steps": 4}),
        _event("instant", "run_end", "run", ts=7.5 * scale,
               args={"succeeded": True}),
    ]
    return log


def test_metrics_perfetto_summary_and_diff_equal_the_reference():
    log = _fixed_log()
    slower = _fixed_log(scale=1.5)
    assert port_export.compute_metrics(log) == ref_export.compute_metrics(log)
    assert port_export.to_perfetto(log) == ref_export.to_perfetto(log)
    metrics = port_export.compute_metrics(log)
    assert metrics["critical_path_nodes"] == ["Gen", "Stats", "Schema", "Train"]
    assert port_export.format_summary(metrics) == ref_export.format_summary(
        ref_export.compute_metrics(log))
    for threshold in (0.2, 0.6):
        got = port_export.diff_metrics(
            metrics, port_export.compute_metrics(slower), threshold=threshold)
        want = ref_export.diff_metrics(
            ref_export.compute_metrics(log), ref_export.compute_metrics(slower),
            threshold=threshold)
        assert got == want
        assert port_export.format_diff(got) == ref_export.format_diff(want)
    assert port_export.diff_metrics(metrics, metrics)["regressed"] is False


def test_the_exporters_write_the_same_files(tmp_path):
    log = _fixed_log()
    for export, sub in ((ref_export, "ref"), (port_export, "port")):
        export.export_perfetto(log, str(tmp_path / sub / "trace.json"))
        export.export_metrics(log, str(tmp_path / sub / "metrics.json"))
    for name in ("trace.json", "metrics.json"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes()


# -------------------------------------------------------- the host-only DAG


def host_dag(side, base):
    """CsvExampleGen -> StatisticsGen -> SchemaGen through ``side``'s
    components and Pipeline."""
    comps, pipeline = ((ref_components, RefPipeline) if side == "ref"
                       else (port_components, PortPipeline))
    gen = comps.CsvExampleGen(input_path=CSV)
    stats = comps.StatisticsGen(examples=gen.outputs["examples"])
    schema = comps.SchemaGen(statistics=stats.outputs["statistics"])
    return pipeline("hostdag", [gen, stats, schema],
                    pipeline_root=os.path.join(base, "root"),
                    metadata_path=os.path.join(base, "md.sqlite"))


def _runner(side):
    return RefRunner() if side == "ref" else PortRunner(device="cpu")


@pytest.fixture(scope="module")
def traced_runs(tmp_path_factory):
    """Both sides' cold and warm runs of the host-only DAG: {(side, tag):
    (result, events)}."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("TPP_TRACE", raising=False)
        mp.delenv("TPP_METRICS_PORT", raising=False)
        mp.setenv("TPP_DATA_POOL", "thread")  # no fork under JAX's threads
        for side in ("ref", "port"):
            base = str(tmp_path_factory.mktemp(side))
            export = ref_export if side == "ref" else port_export
            trace = ref_trace if side == "ref" else port_trace
            for tag in ("cold", "warm"):
                result = _runner(side).run(host_dag(side, base))
                events = export.read_events(trace.events_path(
                    os.path.join(base, "root"), result.run_id))
                out[(side, tag)] = (result, events)
    return out


@pytest.mark.parametrize("tag", ["cold", "warm"])
def test_the_host_dag_traces_as_the_reference(traced_runs, tag):
    ref_result, ref_events = traced_runs[("ref", tag)]
    port_result, port_events = traced_runs[("port", tag)]
    assert {k: v.status for k, v in port_result.nodes.items()} == \
        {k: v.status for k, v in ref_result.nodes.items()}
    got = {(e["cat"], e["name"], e["node"]) for e in port_events}
    want = {(e["cat"], e["name"], e["node"]) for e in ref_events} - REF_ONLY
    assert got == want
    port_m = port_export.compute_metrics(port_events)
    ref_m = ref_export.compute_metrics(ref_events)
    assert port_m["critical_path_nodes"] == ref_m["critical_path_nodes"] == [
        "CsvExampleGen", "StatisticsGen", "SchemaGen"]
    assert port_m["cache_hit_ratio"] == ref_m["cache_hit_ratio"] == (
        0.0 if tag == "cold" else 1.0)
    assert sorted(port_m["per_node"]) == sorted(ref_m["per_node"])
    for node, info in port_m["per_node"].items():
        assert info["status"] == ref_m["per_node"][node]["status"]
        assert info["upstream"] == ref_m["per_node"][node]["upstream"]
        assert info["execution_id"] == port_result.nodes[node].execution_id
    assert sorted(port_m["store_ops"]) == sorted(ref_m["store_ops"])
    assert port_m["run_succeeded"] is ref_m["run_succeeded"] is True
    assert port_events[0]["name"] == "run_start"
    assert port_events[-1]["name"] == "run_end"


def test_tracing_off_leaves_no_runs_directory(tmp_path, monkeypatch):
    monkeypatch.setenv("TPP_TRACE", "0")
    monkeypatch.setenv("TPP_DATA_POOL", "thread")
    for side in ("ref", "port"):
        base = tmp_path / side
        _runner(side).run(host_dag(side, str(base)))
        assert not (base / "root" / ".runs").exists()
        assert (base / "root").is_dir()


@pytest.mark.parametrize("stamp", ["record_factory", "handler_filter"])
def test_log_records_carry_the_run_and_node_ids(tmp_path, monkeypatch, stamp):
    """The runner's records carry its run and node ids, stamped by the
    factory ``install_log_correlation`` installs, or by
    ``RunContextFilter`` on a handler.  (In a process that also loads the
    reference, whose factory stamps every ``tpu_pipelines*`` record from
    its own context, a factory installed after the port's overwrites them:
    the handler filter case holds in any order.)"""
    import logging

    monkeypatch.delenv("TPP_TRACE", raising=False)
    seen = []

    class Grab(logging.Handler):
        def emit(self, record):
            if record.name.startswith("tpu_pipelines_torch.runner"):
                seen.append((getattr(record, "run_id", None),
                             getattr(record, "node_id", None)))

    handler = Grab(level=logging.INFO)
    if stamp == "handler_filter":
        handler.addFilter(port_trace.RunContextFilter())
    else:
        # Installed afresh, outermost (a reference factory installed later
        # in this process would otherwise stamp the port's records).
        monkeypatch.setattr(logging, "_logRecordFactory",
                            logging.getLogRecordFactory())
        monkeypatch.setattr(port_trace, "_factory_installed", False)
        port_trace.install_log_correlation()
    logger = logging.getLogger("tpu_pipelines_torch.runner")
    old = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        result = PortRunner(device="cpu").run(host_dag("port", str(tmp_path)))
    finally:
        logger.removeHandler(handler)
        logger.setLevel(old)
    assert seen
    assert {run for run, _ in seen} == {result.run_id}
    assert {node for _, node in seen} >= {"CsvExampleGen", "SchemaGen"}


# ---------------------------------------------------- run telemetry server


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _probe(component_mod):
    """A node that scrapes the run's telemetry server while it runs."""

    @component_mod.component(
        inputs={"examples": "Examples"}, outputs={"scrape": "Examples"})
    def Probe(ctx):
        port = os.environ["TPP_METRICS_PORT"]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as r:
            text = r.read().decode()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as r:
            health = json.loads(r.read())
        with open(os.path.join(ctx.output("scrape").uri, "scrape.json"),
                  "w") as f:
            json.dump({"text": text, "health": health}, f)

    return Probe


def _families(text):
    return sorted({line.split("{")[0].split(" ")[0]
                   for line in text.splitlines()
                   if line.startswith(("pipeline_node", "pipeline_run"))})


def test_the_metrics_port_serves_the_run_gauges_as_the_reference(
        tmp_path, monkeypatch):
    monkeypatch.setenv("TPP_TRACE", "0")
    monkeypatch.setenv("TPP_DATA_POOL", "thread")
    scrapes = {}
    for side in ("ref", "port"):
        monkeypatch.setenv("TPP_METRICS_PORT", str(_free_port()))
        comps, pipeline, mod = (
            (ref_components, RefPipeline, ref_component_mod) if side == "ref"
            else (port_components, PortPipeline, port_component_mod))
        gen = comps.CsvExampleGen(input_path=CSV)
        probe = _probe(mod)(examples=gen.outputs["examples"])
        base = tmp_path / side
        result = _runner(side).run(pipeline(
            "probe", [gen, probe], pipeline_root=str(base / "root"),
            metadata_path=str(base / "md.sqlite")))
        uri = result.outputs_of("Probe", "scrape")[0].uri
        with open(os.path.join(uri, "scrape.json")) as f:
            scrapes[side] = json.load(f)
        port = int(os.environ["TPP_METRICS_PORT"])
        with pytest.raises(OSError):   # the server stops with the run
            urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                   timeout=2)
    assert _families(scrapes["port"]["text"]) == _families(scrapes["ref"]["text"])
    assert {"pipeline_nodes_pending", "pipeline_nodes_running",
            "pipeline_nodes_done", "pipeline_nodes_failed",
            "pipeline_run_info"} <= set(_families(scrapes["port"]["text"]))
    health = copy.deepcopy(scrapes["port"]["health"])
    want = copy.deepcopy(scrapes["ref"]["health"])
    for h in (health, want):
        h.pop("run_id")
    assert health == want == {"healthy": True, "pipeline": "probe",
                              "nodes_failed": 0}
    assert not [t for t in threading.enumerate() if t.name == "tpp-metrics"]
