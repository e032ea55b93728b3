"""The port's continuous pipelines against the reference's
(``tests/test_continuous.py``): the span watcher, version re-delivery, the
rolling-window selection, the window union and merged statistics, the
controller loop with its deploys, probation rollback, restart, crash
resume and drain, the drift plane, and ``continuous --once``.

Each scenario runs through both packages on the same CSV spans (the
reference's StatisticsGen on its thread pool, ``TPP_DATA_POOL=thread``;
the port's runner and fleet on ``device="cpu"``, the fleet behind the
stub-loader seam ``serving.fleet.versions._default_loader``):

  * the watcher's polls, the cache verdicts and the resolver's selections
    equal the reference's;
  * the merged window statistics match the reference's values to 1e-12
    relative (the port writes ``.npz`` shards and the reference Parquet,
    so the bytes differ and the values are compared), and the port's
    merged ``stats.json`` equals a cold port StatisticsGen over the window
    artifact byte for byte;
  * the controller cases run one tick sequence through both controllers
    and compare the iteration summaries (without ``wall_s``,
    ``deploy_latency_s`` and run ids), the ``continuous_*`` series and the
    blessing and model properties in both stores.

The port's departures are held here too: a lint gate raises naming A20.
With ``TPP_METRICS_HISTORY`` unset no summary carries ``train_telemetry``,
as in the reference.
"""

import importlib
import json
import os
import shutil
import threading
import time
import types

import numpy as np
import pytest

pytestmark = pytest.mark.continuous

SIDES = ("ref", "port")
# Merged statistics against the reference's, relative.
STATS_RTOL = 1e-12


@pytest.fixture(autouse=True)
def _thread_pool(monkeypatch):
    monkeypatch.setenv("TPP_DATA_POOL", "thread")  # no fork under JAX's threads
    monkeypatch.delenv("TPP_LINT", raising=False)
    monkeypatch.delenv("TPP_SERVING_PUSH_URL", raising=False)


def _pkg(name):
    root = "tpu_pipelines_torch" if name == "port" else "tpu_pipelines"
    ns = types.SimpleNamespace(name=name, root=root)
    comp = importlib.import_module(f"{root}.dsl.component")
    ns.component = comp.component
    ns.Pipeline = importlib.import_module(f"{root}.dsl.pipeline").Pipeline
    ns.components = importlib.import_module(f"{root}.components")
    ns.resolve_artifacts = importlib.import_module(
        f"{root}.components.resolver").resolve_artifacts
    ns.open_store = importlib.import_module(f"{root}.metadata").open_store
    ns.types = importlib.import_module(f"{root}.metadata.types")
    ns.continuous = importlib.import_module(f"{root}.continuous")
    ns.list_spans = importlib.import_module(f"{root}.utils.span").list_spans
    ns.examples_io = importlib.import_module(f"{root}.data.examples_io")
    ns.metrics = importlib.import_module(f"{root}.observability.metrics")
    ns.atomic_write_json = importlib.import_module(
        f"{root}.robustness.atomic").atomic_write_json
    orch = importlib.import_module(f"{root}.orchestration")
    ns.PipelineRunError = orch.PipelineRunError
    ns.runner = ((lambda **kw: orch.LocalDagRunner(device="cpu", **kw))
                 if name == "port" else orch.LocalDagRunner)
    server_cls = importlib.import_module(f"{root}.serving.server").ModelServer
    ns.ModelServer = ((lambda *a, **kw: server_cls(*a, device="cpu", **kw))
                      if name == "port" else server_cls)
    ns.cli = importlib.import_module(f"{root}.__main__").main
    return ns


PKGS = {name: _pkg(name) for name in SIDES}


def _config(ns, **kw):
    """A ContinuousConfig of ``ns``'s package (the port's on the CPU)."""
    if ns.name == "port":
        kw.setdefault("device", "cpu")
    return ns.continuous.ContinuousConfig(**kw)


def _write_span(data_dir, span, rows, version=1):
    d = os.path.join(str(data_dir), f"span-{span}", f"v-{version}")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "data.csv"), "w") as f:
        f.write("x,y\n")
        for i in range(rows):
            f.write(f"{i + 100 * span},{(i * 3 + span) % 7}\n")
    return d


class FakeLoaded:
    """Stub serving payload: predict scales the 'x' feature."""

    def __init__(self, scale):
        self.scale = scale
        self.generate = None
        self.transform = None

    def predict(self, batch):
        return np.asarray(batch["x"], np.float64) * self.scale

    predict_transformed = predict


def _fake_loader(version_dir, device=None):
    with open(os.path.join(version_dir, "scale.txt")) as f:
        return FakeLoaded(float(f.read()))


@pytest.fixture
def fake_loader(monkeypatch):
    for side in SIDES:
        monkeypatch.setattr(
            f"{PKGS[side].root}.serving.fleet.versions._default_loader",
            _fake_loader)
    return _fake_loader


def _stubs(ns):
    """The stub Trainer and Evaluator, as ``ns``'s package's components."""

    @ns.component(inputs={"examples": "Examples"}, outputs={"model": "Model"},
                  name="StubTrainer")
    def StubTrainer(ctx):
        n = sum(
            ctx.input("examples").properties.get("split_counts", {}).values()
        )
        with open(os.path.join(ctx.output("model").uri, "scale.txt"),
                  "w") as f:
            f.write(str(float(n)))
        return {"rows_trained": n}

    @ns.component(
        inputs={"model": "Model", "baseline_model": "Model",
                "statistics": "ExampleStatistics"},
        optional_inputs=("baseline_model",),
        outputs={"blessing": "ModelBlessing"},
        is_sink=True, name="StubEvaluator",
    )
    def StubEvaluator(ctx):
        with open(os.path.join(ctx.output("blessing").uri, "BLESSED"),
                  "w") as f:
            json.dump({"reasons": []}, f)
        ctx.output("blessing").properties["blessed"] = True
        return {"blessed": True,
                "had_baseline": bool(ctx.inputs.get("baseline_model"))}

    return StubTrainer, StubEvaluator


class _Harness:
    """One continuous deployment of ``ns``'s package: a shared store, span
    and window factories, a fleet-mode ModelServer on the stub loader, and
    a controller."""

    def __init__(self, ns, td, window_spans=3, serving=True,
                 probation_watch_s=1.0):
        self.ns = ns
        self.td = str(td)
        self.data = os.path.join(self.td, "data")
        self.pattern = os.path.join(self.data, "span-{SPAN}", "v-{VERSION}")
        self.md = os.path.join(self.td, "md.sqlite")
        self.root = os.path.join(self.td, "root")
        self.dest = os.path.join(self.td, "serving")
        self.registry = ns.metrics.MetricsRegistry()
        self.window_spans = window_spans
        self.stubs = _stubs(ns)
        self.server = None
        self.serving_url = ""
        if serving:
            os.makedirs(os.path.join(self.dest, "1"))
            with open(os.path.join(self.dest, "1", "scale.txt"), "w") as f:
                f.write("1.0")
            self.server = ns.ModelServer(
                "m", self.dest, replicas=2, max_versions=2,
                swap_probation_s=300.0,
            )
            port = self.server.start()
            self.serving_url = f"http://127.0.0.1:{port}/v1/models/m"
        self.cfg = _config(
            ns, input_pattern=self.pattern,
            make_span_pipeline=self.make_span_pipeline,
            make_window_pipeline=self.make_window_pipeline,
            poll_interval_s=0.1, serving_url=self.serving_url,
            probation_watch_s=probation_watch_s, probation_poll_s=0.05,
            state_dir=os.path.join(self.td, "state"),
            registry=self.registry,
        )
        self.controller = ns.continuous.ContinuousController(self.cfg)

    def write_span(self, span, rows, version=1):
        return _write_span(self.data, span, rows, version=version)

    def make_span_pipeline(self, span, version):
        c = self.ns.components
        gen = c.CsvExampleGen(input_path=self.pattern, span=span, num_shards=2)
        stats = c.StatisticsGen(examples=gen.outputs["examples"],
                                save_accumulators=True)
        return self.ns.Pipeline(
            "spans-ingest", [gen, stats],
            pipeline_root=os.path.join(self.root, "ingest"),
            metadata_path=self.md, node_timeout_s=120,
        )

    def make_window_pipeline(self):
        c, cont = self.ns.components, self.ns.continuous
        StubTrainer, StubEvaluator = self.stubs
        win = c.RollingWindowResolver(
            window_spans=self.window_spans, source_pipeline="spans-ingest",
            examples_producer="CsvExampleGen",
            statistics_producer="StatisticsGen",
        )
        spanwin = cont.SpanWindow(examples=win.outputs["examples"])
        merged = cont.WindowStatisticsMerger(
            statistics=win.outputs["statistics"])
        trainer = StubTrainer(examples=spanwin.outputs["window"])
        evaluator = StubEvaluator(
            model=trainer.outputs["model"],
            baseline_model=win.outputs["model"],
            statistics=merged.outputs["statistics"],
        )
        pusher = c.Pusher(
            model=trainer.outputs["model"],
            blessing=evaluator.outputs["blessing"],
            push_destination=self.dest, serving_push_url=self.serving_url,
        )
        return self.ns.Pipeline(
            "window-train",
            [win, spanwin, merged, trainer, evaluator, pusher],
            pipeline_root=os.path.join(self.root, "window"),
            metadata_path=self.md, node_timeout_s=120,
        )

    def series(self):
        """The controller's ``continuous_*`` lines of the registry's scrape."""
        return sorted(line for line in self.registry.to_prometheus().splitlines()
                      if line.startswith("continuous_"))

    def store_view(self):
        """Blessing and model properties in the store, in id order."""
        store = self.ns.open_store(self.md)
        try:
            blessings = [
                (b.properties.get("blessed"),
                 "auto-rollback" in b.properties.get("unblessed_reason", ""),
                 os.path.exists(os.path.join(b.uri, "BLESSED")),
                 os.path.exists(os.path.join(b.uri, "NOT_BLESSED")))
                for b in store.get_artifacts(type_name="ModelBlessing")]
            models = [bool(m.properties.get("rollback_quarantined"))
                      for m in store.get_artifacts(type_name="Model")]
            pushed = [bool(p.properties.get("rolled_back"))
                      for p in store.get_artifacts(type_name="PushedModel")]
        finally:
            store.close()
        return {"blessings": blessings, "models": models, "pushed": pushed}

    def close(self):
        if self.server is not None:
            self.server.stop()


def _summary(it):
    """An iteration summary without what differs run to run."""
    out = {k: v for k, v in it.items() if k != "wall_s"}
    if out.get("deployed"):
        out["deployed"] = {k: v for k, v in out["deployed"].items()
                           if k not in ("deploy_latency_s", "run_id")}
    return out


def _harnesses(tmp_path, **kw):
    return {side: _Harness(PKGS[side], tmp_path / side, **kw)
            for side in SIDES}


def _close(hs):
    for h in hs.values():
        h.close()


def _assert_close(got, want, path=""):
    """``got`` equals ``want`` with every number within STATS_RTOL."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float) or isinstance(got, float):
        assert got == pytest.approx(want, rel=STATS_RTOL, abs=0.0), path
    else:
        assert got == want, path


# -------------------------------------------------------------- list_spans


def test_list_spans_triples_and_ordering(tmp_path):
    base = tmp_path / "d"
    for d in ("span-1/v-1", "span-1/v-2", "span-2/v-1", "span-010/v-1"):
        (base / d).mkdir(parents=True)
    pattern = str(base / "span-{SPAN}" / "v-{VERSION}")
    got = {}
    for side in SIDES:
        ls = PKGS[side].list_spans
        seen = [ls(pattern)]
        (base / "span-2" / f"v-010-{side}").mkdir()  # not a version: skipped
        seen.append(ls(pattern))
        seen.append(ls(str(base / "flat-{SPAN}")))
        seen.append(ls(str(base / "nope-{SPAN}")))
        with pytest.raises(ValueError, match="SPAN"):
            ls(str(base / "no-token"))
        got[side] = seen
    (base / "flat-3").mkdir()
    (base / "flat-7").mkdir()
    (base / "span-9").mkdir()  # no version delivered yet: omitted
    (base / "span-2" / "v-010").mkdir()
    for side in SIDES:
        ls = PKGS[side].list_spans
        got[side] += [ls(pattern), ls(str(base / "flat-{SPAN}"))]
    assert got["port"] == got["ref"]
    port = got["port"]
    assert [(s, v) for s, v, _ in port[0]] == [(1, 1), (1, 2), (2, 1), (10, 1)]
    assert [(s, v) for s, v, _ in port[4] if s == 2] == [(2, 1), (2, 10)]
    assert [(s, v) for s, v, _ in port[5]] == [(3, None), (7, None)]
    assert port[3] == [] and 9 not in {s for s, _, _ in port[4]}


# ---------------------------------------------------------------- watcher


def test_span_watcher_ack_redelivery_and_persistence(tmp_path):
    polls = {}
    for side in SIDES:
        SpanWatcher = PKGS[side].continuous.SpanWatcher
        base = tmp_path / side / "d"
        pattern = str(base / "span-{SPAN}" / "v-{VERSION}")
        state = str(tmp_path / side / "watcher.json")
        (base / "span-1" / "v-1").mkdir(parents=True)
        (base / "span-1" / "v-2").mkdir()
        (base / "span-2" / "v-1").mkdir(parents=True)

        def view(ds):
            return [(d.span, d.version, d.key,
                     os.path.relpath(d.path, str(base))) for d in ds]

        seen = []
        w = SpanWatcher(pattern, state_path=state)
        got = w.poll()
        seen.append(view(got))
        w.ack(got)
        seen += [view(w.poll()), w.seen_spans()]
        (base / "span-2" / "v-2").mkdir()  # a version re-delivery
        seen.append(view(w.poll()))
        w2 = SpanWatcher(pattern, state_path=state)  # a restart
        seen += [w2.seen_spans(), view(w2.poll())]
        with open(state) as f:
            seen.append(json.load(f)["acked"])
        with open(state, "w") as f:
            f.write("{torn")
        seen.append(view(SpanWatcher(pattern, state_path=state).poll()))
        polls[side] = seen
    assert polls["port"] == polls["ref"]
    port = polls["port"]
    assert [(s, v) for s, v, _, _ in port[0]] == [(1, 2), (2, 1)]
    assert port[1] == [] and port[2] == [1, 2]
    assert [(s, v) for s, v, _, _ in port[3]] == [(2, 2)]
    assert port[4] == [1, 2] and [(s, v) for s, v, _, _ in port[5]] == [(2, 2)]
    assert len(port[7]) == 2  # a torn state file starts from scratch


def test_example_gen_version_redelivery_invalidates_cache(tmp_path):
    """A new {VERSION} re-delivering a span is a changed span: even a
    byte-identical re-delivery re-executes, and the new identity is
    itself cache-stable."""
    seen = {}
    for side in SIDES:
        ns = PKGS[side]
        data = tmp_path / side / "data"
        _write_span(data, 1, 10, version=1)
        pattern = str(data / "span-{SPAN}" / "v-{VERSION}")

        def pipeline():
            gen = ns.components.CsvExampleGen(input_path=pattern)
            return ns.Pipeline(
                "redelivery", [gen],
                pipeline_root=str(tmp_path / side / "root"),
                metadata_path=str(tmp_path / side / "md.sqlite"),
            )

        def run():
            r = ns.runner().run(pipeline())
            return (r.nodes["CsvExampleGen"].status,
                    r.outputs_of("CsvExampleGen", "examples")[0]
                    .properties.get("version"))

        out = [run(), run()]
        shutil.copytree(str(data / "span-1" / "v-1"),
                        str(data / "span-1" / "v-2"))
        out += [run(), run()]
        seen[side] = out
    assert seen["port"] == seen["ref"]
    assert seen["port"] == [("COMPLETE", 1), ("CACHED", 1),
                            ("COMPLETE", 2), ("CACHED", 2)]


# ------------------------------------------- rolling window + merge pieces


def test_rolling_window_resolver_selection(tmp_path):
    """Last-K spans, the newest version per span, the producer filter,
    span-ascending output, an empty bootstrap model."""
    got = {}
    for side in SIDES:
        ns = PKGS[side]
        t = ns.types
        store = ns.open_store(str(tmp_path / f"{side}.sqlite"))
        ctx = t.Context("pipeline", "ingest")
        store.put_context(ctx)

        def publish(span, version, producer, type_name="Examples"):
            art = t.Artifact(type_name=type_name,
                             uri=f"/x/{producer}/{span}/{version}",
                             properties={"span": span, "version": version})
            ex = t.Execution(type_name="T", node_id=producer,
                             state=t.ExecutionState.COMPLETE)
            store.publish_execution(ex, {}, {"out": [art]}, [ctx])

        for span in (1, 2, 3, 4):
            publish(span, 1, "Gen")
            publish(span, 1, "Stats", type_name="ExampleStatistics")
        publish(2, 3, "Gen")    # a re-delivery: v3 of span 2
        publish(2, 2, "Gen")    # a late lower version: must lose
        publish(9, 1, "Other")  # another producer: filtered out

        def resolve(**extra):
            out = ns.resolve_artifacts(
                store, strategy="rolling_window", pipeline_name="train",
                within_pipeline=False, extra=extra)
            return {k: [(a.uri, a.properties.get("span"),
                         a.properties.get("version")) for a in v]
                    for k, v in sorted(out.items())}

        got[side] = [
            resolve(window_spans=3, source_pipeline="ingest",
                    examples_producer="Gen", statistics_producer="Stats"),
            resolve(window_spans=99, source_pipeline="ingest",
                    examples_producer="Gen"),
            resolve(window_spans=3, source_pipeline="nope"),
        ]
        store.close()
    assert got["port"] == got["ref"]
    first = got["port"][0]
    assert [s for _, s, _ in first["examples"]] == [2, 3, 4]
    assert first["examples"][0][2] == 3 and first["model"] == []
    assert [s for _, s, _ in got["port"][1]["examples"]] == [1, 2, 3, 4]
    assert got["port"][2]["examples"] == [] == got["port"][2]["statistics"]


def _ingest_and_window(ns, td, spans, window_spans=3):
    """Per-span ingest runs, then a window run (resolver -> SpanWindow and
    WindowStatisticsMerger); the window and merged artifacts."""
    data = os.path.join(td, "data")
    for span, rows in spans:
        _write_span(data, span, rows)
    pattern = os.path.join(data, "span-{SPAN}", "v-{VERSION}")
    md = os.path.join(td, "md.sqlite")
    c, cont = ns.components, ns.continuous
    for span, _ in spans:
        gen = c.CsvExampleGen(input_path=pattern, span=span, num_shards=2)
        stats = c.StatisticsGen(examples=gen.outputs["examples"],
                                save_accumulators=True)
        ns.runner().run(ns.Pipeline(
            "ingest", [gen, stats],
            pipeline_root=os.path.join(td, "root"), metadata_path=md))
    win = c.RollingWindowResolver(
        window_spans=window_spans, source_pipeline="ingest",
        examples_producer="CsvExampleGen",
        statistics_producer="StatisticsGen",
    )
    spanwin = cont.SpanWindow(examples=win.outputs["examples"])
    merged = cont.WindowStatisticsMerger(statistics=win.outputs["statistics"])
    r = ns.runner().run(ns.Pipeline(
        "window", [win, spanwin, merged],
        pipeline_root=os.path.join(td, "wroot"), metadata_path=md))
    assert r.succeeded
    return (r.outputs_of("SpanWindow", "window")[0],
            r.outputs_of("WindowStatisticsMerger", "statistics")[0])


def _cold_stats(ns, td, window_uri):
    """A cold StatisticsGen over the window artifact: its stats.json path."""
    c = ns.components
    imp = c.Importer(source_uri=window_uri, artifact_type="Examples")
    cold = c.StatisticsGen(examples=imp.outputs["result"])
    rc = ns.runner().run(ns.Pipeline(
        "cold", [imp, cold], pipeline_root=os.path.join(td, "croot"),
        metadata_path=os.path.join(td, "cold.sqlite")))
    return os.path.join(rc.outputs_of("StatisticsGen", "statistics")[0].uri,
                        "stats.json")


def test_window_union_and_merged_stats_identity(tmp_path):
    """SpanWindow + WindowStatisticsMerger vs a cold full run over the same
    window artifact: every row once, merged statistics equal to the cold
    pass (bytes within a package, values across the two)."""
    got = {}
    for side in SIDES:
        ns = PKGS[side]
        td = str(tmp_path / side)
        window_art, merged_art = _ingest_and_window(
            ns, td, ((1, 30), (2, 50), (3, 20)))
        with open(_cold_stats(ns, td, window_art.uri)) as f:
            cold = f.read()
        with open(os.path.join(merged_art.uri, "stats.json")) as f:
            inc = f.read()
        rows = {s: ns.examples_io.num_rows(window_art.uri, s)
                for s in ns.examples_io.split_names(window_art.uri)}
        got[side] = {"cold": json.loads(cold), "inc": json.loads(inc),
                     "same_bytes": inc == cold, "rows": rows,
                     "spans": window_art.properties["window_spans"],
                     "shards": {s: len(ns.examples_io.split_shard_paths(
                         window_art.uri, s)) for s in rows}}
    port, ref = got["port"], got["ref"]
    assert port["inc"] == port["cold"] and port["same_bytes"]
    assert ref["inc"] == ref["cold"]
    _assert_close(port["inc"], ref["inc"])
    assert (port["rows"], port["spans"], port["shards"]) == (
        ref["rows"], ref["spans"], ref["shards"])
    assert sum(port["rows"].values()) == 100 and port["spans"] == [1, 2, 3]


def test_port_merged_stats_json_equals_a_cold_pass_byte_for_byte(tmp_path):
    """Within the port: uneven spans, one of them a single shard per split,
    a window of the last two spans; the merged stats.json and a cold port
    StatisticsGen's over the SpanWindow artifact are the same bytes."""
    ns = PKGS["port"]
    td = str(tmp_path)
    window_art, merged_art = _ingest_and_window(
        ns, td, ((1, 3), (2, 37), (3, 61)), window_spans=2)
    assert window_art.properties["window_spans"] == [2, 3]
    with open(_cold_stats(ns, td, window_art.uri), "rb") as f:
        cold = f.read()
    with open(os.path.join(merged_art.uri, "stats.json"), "rb") as f:
        assert f.read() == cold


def test_window_merger_requires_mergeable_stats(tmp_path):
    """Statistics produced without save_accumulators are refused with a
    pointed error, never approximated."""
    for side in SIDES:
        ns = PKGS[side]
        c = ns.components
        data = tmp_path / side / "data"
        _write_span(data, 1, 10)
        pattern = str(data / "span-{SPAN}" / "v-{VERSION}")
        md = str(tmp_path / side / "md.sqlite")
        gen = c.CsvExampleGen(input_path=pattern, span=1)
        stats = c.StatisticsGen(examples=gen.outputs["examples"])
        ns.runner().run(ns.Pipeline(
            "ingest", [gen, stats],
            pipeline_root=str(tmp_path / side / "root"), metadata_path=md))
        win = c.RollingWindowResolver(window_spans=2, source_pipeline="ingest",
                                      statistics_producer="StatisticsGen")
        merged = ns.continuous.WindowStatisticsMerger(
            statistics=win.outputs["statistics"])
        with pytest.raises(ns.PipelineRunError, match="save_accumulators"):
            ns.runner().run(ns.Pipeline(
                "window", [win, merged],
                pipeline_root=str(tmp_path / side / "wroot"),
                metadata_path=md))


# ----------------------------------------------------- controller behavior


def test_controller_incremental_iterations(tmp_path, fake_loader):
    """Spans 1+2 bootstrap; span 3 arrives: only span 3's ingest executes
    (work saved 2/3), the window retrains and redeploys; an idle tick runs
    nothing and deploys nothing."""
    hs = _harnesses(tmp_path, probation_watch_s=0.0)
    try:
        seen = {}
        for side, h in hs.items():
            h.write_span(1, 40)
            h.write_span(2, 60)
            ticks = [h.controller.run_once(), h.controller.run_once()]
            versions = [h.server.version]
            h.write_span(3, 80)
            ticks.append(h.controller.run_once())
            versions.append(h.server.version)
            store = h.ns.open_store(h.md)
            stats_runs = len([
                e for e in store.get_executions(node_id="StatisticsGen")
                if e.state.value in ("COMPLETE", "CACHED")])
            store.close()
            seen[side] = {"ticks": [_summary(t) for t in ticks],
                          "versions": versions, "stats_runs": stats_runs,
                          "series": h.series(), "store": h.store_view()}
        assert seen["port"] == seen["ref"]
        it1, idle, it3 = seen["port"]["ticks"]
        assert it1["spans_processed"] == 2 and it1["work_saved_ratio"] == 0.0
        assert it1["deployed"]["version"] == "2"
        assert it1["deployed"]["reload_notified"] is True
        assert idle["spans_processed"] == 0 and idle["deployed"] is None
        assert idle["nodes_executed"] == 0
        assert it3["spans_processed"] == 1
        assert it3["work_saved_ratio"] == pytest.approx(2 / 3, abs=1e-3)
        assert it3["deployed"]["version"] == "3"
        assert seen["port"]["versions"] == ["2", "3"]
        assert seen["port"]["stats_runs"] == 3
        assert "train_telemetry" not in it3  # TPP_METRICS_HISTORY unset
        reg = hs["port"].registry
        assert reg.get("continuous_deploys_total").get() == 2
        assert reg.get("continuous_spans_seen").get() == 3
    finally:
        _close(hs)


def test_controller_restart_does_not_reprocess(tmp_path, fake_loader):
    """Watcher acks persist: a restarted controller ignores processed spans
    but picks up a version re-delivery of one of them."""
    hs = _harnesses(tmp_path, probation_watch_s=0.0)
    try:
        seen = {}
        for side, h in hs.items():
            h.write_span(1, 40)
            ticks = [h.controller.run_once()]
            c2 = h.ns.continuous.ContinuousController(h.cfg)
            ticks.append(c2.run_once())
            h.write_span(1, 45, version=2)  # a re-delivery
            ticks.append(c2.run_once())
            seen[side] = {"ticks": [_summary(t) for t in ticks],
                          "series": h.series(), "store": h.store_view()}
        assert seen["port"] == seen["ref"]
        first, idle, it = seen["port"]["ticks"]
        assert first["spans_processed"] == 1
        assert idle["spans_processed"] == 0 and idle["deployed"] is None
        assert it["deliveries"] == ["1:2"] and it["spans_processed"] == 1
        assert it["deployed"] is not None  # retrained on the re-delivery
    finally:
        _close(hs)


def test_controller_crash_marker_resumes_window_without_redeploy(
        tmp_path, fake_loader):
    """A controller that died mid-window-run restarts dirty: the pending
    marker re-arms the window on the first tick, the resumed run adopts the
    published executions, and an adopted Pusher is not a fresh deploy."""
    hs = _harnesses(tmp_path, probation_watch_s=0.0)
    try:
        seen = {}
        for side, h in hs.items():
            h.write_span(1, 40)
            ticks = [h.controller.run_once()]
            h.ns.atomic_write_json(
                os.path.join(h.cfg.state_dir, "pending.json"),
                {"pipeline": "window-train", "kind": "window"})
            c2 = h.ns.continuous.ContinuousController(h.cfg)
            ticks += [c2.run_once(), c2.run_once()]
            with open(os.path.join(h.cfg.state_dir, "pending.json")) as f:
                pending = json.load(f)
            seen[side] = {"ticks": [_summary(t) for t in ticks],
                          "version": h.server.version, "pending": pending,
                          "series": h.series(), "store": h.store_view()}
        assert seen["port"] == seen["ref"]
        first, resumed, idle = seen["port"]["ticks"]
        assert first["deployed"]["version"] == "2"
        assert resumed["deployed"] is None
        assert resumed["nodes_executed"] == 6  # adopted: COMPLETE, not re-run
        assert seen["port"]["version"] == "2" and seen["port"]["pending"] == {}
        assert hs["port"].registry.get("continuous_deploys_total").get() == 1
        assert idle["nodes_executed"] == 0 and idle["deployed"] is None
    finally:
        _close(hs)


def test_controller_drain_and_stop(tmp_path, fake_loader):
    """run(stop_event) drains: the loop exits promptly once signalled and
    starts no further iteration."""
    for side in SIDES:
        h = _Harness(PKGS[side], tmp_path / side, serving=False)
        try:
            h.write_span(1, 10)
            stop = threading.Event()
            t = threading.Thread(target=h.controller.run,
                                 kwargs={"stop_event": stop})
            t.start()
            deadline = time.monotonic() + 30
            while (not h.controller.watcher.seen_spans()
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            stop.set()
            t.join(timeout=30)
            assert not t.is_alive(), side
            iterations = h.controller.status()["iterations"]
            time.sleep(0.3)
            assert h.controller.status()["iterations"] == iterations, side
            assert h.controller.status()["spans_seen"] == [1], side
        finally:
            h.close()


def test_controller_refuses_split_metadata_stores(tmp_path):
    for side in SIDES:
        ns = PKGS[side]
        data = tmp_path / side / "data"
        _write_span(data, 1, 5)
        pattern = str(data / "span-{SPAN}" / "v-{VERSION}")

        def span_p(span, version):
            gen = ns.components.CsvExampleGen(input_path=pattern, span=span)
            return ns.Pipeline(
                "a", [gen], pipeline_root=str(tmp_path / side / "r1"),
                metadata_path=str(tmp_path / side / "md1.sqlite"))

        def window_p():
            @ns.component(outputs={"model": "Model"}, name="Never")
            def Never(ctx):  # never reached: the store check refuses first
                pass

            return ns.Pipeline(
                "b", [Never()], pipeline_root=str(tmp_path / side / "r2"),
                metadata_path=str(tmp_path / side / "md2.sqlite"))

        c = ns.continuous.ContinuousController(_config(
            ns, input_pattern=pattern, make_span_pipeline=span_p,
            make_window_pipeline=window_p,
            registry=ns.metrics.MetricsRegistry()))
        with pytest.raises(ValueError, match="share one metadata store"):
            c.run_once()


# ------------------------------------------------------- acceptance (e2e)


def test_e2e_incremental_deploy_rollback_unblessing(tmp_path, fake_loader):
    """Span N+1 arrives -> an incremental run (only the new span's stats;
    merged stats == a cold full run) -> the blessed model deploys through
    the fleet's canary -> an SLO breach inside probation rolls back -> the
    controller records the un-blessing in the store."""
    hs = _harnesses(tmp_path, probation_watch_s=8.0)
    try:
        seen = {}
        for side, h in hs.items():
            ns = h.ns
            h.cfg.probation_watch_s = 0.0
            h.write_span(1, 40)
            h.write_span(2, 60)
            it1 = h.controller.run_once()
            active1 = h.server._fleet.active_version
            h.cfg.probation_watch_s = 8.0
            h.write_span(3, 80)
            fleet = h.server._fleet

            def breach_when_v3():
                deadline = time.monotonic() + 30
                while time.monotonic() < deadline:
                    if h.server.version == "3":
                        fleet.on_slo_breach({"slo": "latency_p99"})
                        return
                    time.sleep(0.01)

            t = threading.Thread(target=breach_when_v3)
            t.start()
            it3 = h.controller.run_once()
            t.join(timeout=30)
            store = ns.open_store(h.md)
            try:
                bad = [m.id for m in store.get_artifacts(type_name="Model")
                       if m.properties.get("rollback_quarantined")]
                baseline = ns.resolve_artifacts(
                    store, strategy="latest_blessed_model",
                    pipeline_name="window-train")["model"]
                merged_art = max(
                    (a for a in store.get_artifacts(
                        type_name="ExampleStatistics")
                     if a.properties.get("window_spans") == [1, 2, 3]),
                    key=lambda a: a.id)
                window_art = max(
                    (a for a in store.get_artifacts(type_name="Examples")
                     if a.properties.get("window_spans") == [1, 2, 3]),
                    key=lambda a: a.id)
            finally:
                store.close()
            with open(_cold_stats(ns, h.td, window_art.uri)) as f:
                cold = f.read()
            with open(os.path.join(merged_art.uri, "stats.json")) as f:
                inc = f.read()
            seen[side] = {
                "ticks": [_summary(it1), _summary(it3)], "active1": active1,
                "active": fleet.active_version,
                "quarantined": sorted(fleet.versions.quarantined()),
                "baseline_not_bad": bool(baseline) and baseline[0].id not in bad,
                "n_bad": len(bad), "series": h.series(),
                "store": h.store_view(), "stats_equal": inc == cold,
                "inc": json.loads(inc),
            }
        ref_inc = seen["ref"].pop("inc")
        port_inc = seen["port"].pop("inc")
        _assert_close(port_inc, ref_inc)
        assert seen["port"] == seen["ref"]
        port = seen["port"]
        it1, it3 = port["ticks"]
        assert it1["deployed"]["version"] == "2" and port["active1"] == "2"
        assert it3["spans_processed"] == 1
        assert it3["work_saved_ratio"] == pytest.approx(2 / 3, abs=1e-3)
        assert it3["deployed"]["version"] == "3"
        assert it3["rollback_observed"] is True
        assert port["active"] == "2" and "3" in port["quarantined"]
        assert hs["port"].registry.get(
            "continuous_rollbacks_observed_total").get() == 1
        unblessed = [b for b in port["store"]["blessings"] if b[0] is False]
        assert unblessed == [(False, True, False, True)]
        assert port["n_bad"] == 1 and port["baseline_not_bad"]
        assert port["store"]["pushed"] == [False, True]
        assert port["stats_equal"]
    finally:
        _close(hs)


# -------------------------------------------------------------- drift plane


def _drift_harness(ns, td, window=None, registry=None, serving_url="",
                   **cfg_kw):
    """A controller over a window pipeline of resolver -> merger ->
    SchemaGen -> ExampleValidator (no deploy): (controller, factory calls,
    metadata path, data dir).  ``window(ns, pipeline)`` may edit the window
    pipeline each time it is made."""
    data = os.path.join(td, "data")
    pattern = os.path.join(data, "span-{SPAN}", "v-{VERSION}")
    md = os.path.join(td, "md.sqlite")
    made = []
    c, cont = ns.components, ns.continuous

    def span_p(span, version):
        gen = c.CsvExampleGen(input_path=pattern, span=span)
        stats = c.StatisticsGen(examples=gen.outputs["examples"],
                                save_accumulators=True)
        return ns.Pipeline("drift-ingest", [gen, stats],
                           pipeline_root=os.path.join(td, "root"),
                           metadata_path=md, node_timeout_s=60)

    def window_p():
        win = c.RollingWindowResolver(
            window_spans=2, source_pipeline="drift-ingest",
            examples_producer="CsvExampleGen",
            statistics_producer="StatisticsGen")
        merged = cont.WindowStatisticsMerger(
            statistics=win.outputs["statistics"])
        schema = c.SchemaGen(statistics=merged.outputs["statistics"])
        validator = c.ExampleValidator(
            statistics=merged.outputs["statistics"],
            schema=schema.outputs["schema"], fail_on_anomalies=False)
        p = ns.Pipeline("drift-window", [win, merged, schema, validator],
                        pipeline_root=os.path.join(td, "wroot"),
                        metadata_path=md, node_timeout_s=60)
        if window is not None:
            window(ns, p)
        made.append(p)
        return p

    ctl = ns.continuous.ContinuousController(_config(
        ns, input_pattern=pattern, make_span_pipeline=span_p,
        make_window_pipeline=window_p, poll_interval_s=0.1,
        serving_url=serving_url,
        registry=registry or ns.metrics.MetricsRegistry(), **cfg_kw))
    return ctl, made, md, data


def _evidence(ns, md):
    store = ns.open_store(md)
    try:
        return [(c.name.startswith("drift-window-"),
                 c.properties["triggered_run"] == c.name,
                 c.properties["breaches"])
                for c in store.get_contexts("drift_evidence")]
    finally:
        store.close()


def test_notify_drift_triggers_an_out_of_cadence_window_run(tmp_path):
    """A drift breach handed in through notify_drift makes the next tick
    run the window with no new span; a non-drift breach is ignored; the
    run's drift_evidence context records the breach."""
    seen = {}
    for side in SIDES:
        ns = PKGS[side]
        reg = ns.metrics.MetricsRegistry()
        ctl, _, md, data = _drift_harness(ns, str(tmp_path / side),
                                          registry=reg)
        _write_span(data, 1, 12)
        ticks = [ctl.run_once(), ctl.run_once()]
        ctl.notify_drift({"slo": "latency_p99"})        # not the drift plane
        ticks.append(ctl.run_once())
        breach = {"slo": "drift", "feature": "x", "kind": "drift_js",
                  "distance": 0.4}
        ctl.notify_drift(breach)
        ticks.append(ctl.run_once())
        ticks.append(ctl.run_once())
        seen[side] = {
            "ticks": [_summary(t) for t in ticks],
            "drift_runs": reg.get(
                "continuous_drift_triggered_runs_total").get(),
            "evidence": _evidence(ns, md),
        }
    assert seen["port"] == seen["ref"]
    boot, idle, ignored, drifted, after = seen["port"]["ticks"]
    assert idle["nodes_executed"] == idle["nodes_cached"] == 0
    assert ignored == {**idle, "iteration": 3}
    assert drifted["drift_triggered"] is True and drifted["drift_breaches"] == 1
    assert drifted["nodes_cached"] == 3  # the same window: all cache hits
    assert "drift_triggered" not in after
    assert seen["port"]["drift_runs"] == 1
    assert seen["port"]["evidence"] == [(True, True, [
        {"slo": "drift", "feature": "x", "kind": "drift_js",
         "distance": 0.4}])]


def test_scrape_delta_of_the_fleet_alerts_triggers_a_retrain(tmp_path):
    """A fleet in another process: an increase of
    ``serving_drift_alerts_total`` on its /metrics since the last tick is
    one breach; the first scrape only sets the baseline."""
    seen = {}
    for side in SIDES:
        ns = PKGS[side]
        fleet_reg = ns.metrics.MetricsRegistry()
        alerts = fleet_reg.counter("serving_drift_alerts_total",
                                   "Drift alerts.", labels=("feature", "kind"))
        skew = fleet_reg.gauge("serving_drift_distance", "Distances.",
                               labels=("feature", "kind"))
        alerts.labels("x", "skew_linf").inc(3)  # before the controller
        server = ns.metrics.start_http_server(fleet_reg, port=0)
        try:
            reg = ns.metrics.MetricsRegistry()
            ctl, _, md, data = _drift_harness(
                ns, str(tmp_path / side), registry=reg,
                serving_url=f"http://127.0.0.1:{server.port}/v1/models/m")
            _write_span(data, 1, 12)
            ticks = [ctl.run_once(), ctl.run_once()]
            alerts.labels("x", "skew_linf").inc(2)
            skew.labels("x", "skew_linf").set(0.25)
            ticks += [ctl.run_once(), ctl.run_once()]
        finally:
            server.close()
        seen[side] = {"ticks": [_summary(t) for t in ticks],
                      "evidence": _evidence(ns, md),
                      "drift_runs": reg.get(
                          "continuous_drift_triggered_runs_total").get()}
    assert seen["port"] == seen["ref"]
    boot, idle, drifted, after = seen["port"]["ticks"]
    assert "drift_triggered" not in boot and "drift_triggered" not in idle
    assert drifted["drift_triggered"] is True
    assert "drift_triggered" not in after and seen["port"]["drift_runs"] == 1
    ((_, _, breaches),) = seen["port"]["evidence"]
    assert breaches == [{"slo": "drift", "source": "scrape",
                         "alerts_delta": 2.0, "max_distance": 0.25,
                         "max_skew": 0.25}]


def test_skew_breach_arms_strict_validation_for_the_next_window_run(
        tmp_path):
    """A skew breach at or above ``skew_strict_threshold`` makes the next
    window run's ExampleValidator strict (fail_on_anomalies, the skew
    comparator armed at the threshold); a drift breach below it, or after
    the strict run succeeded, does not."""
    seen = {}
    for side in SIDES:
        ns = PKGS[side]
        ctl, made, md, data = _drift_harness(
            ns, str(tmp_path / side), skew_strict_threshold=0.2)
        _write_span(data, 1, 12)
        ctl.run_once()
        ctl.notify_drift({"slo": "drift", "kind": "skew_linf",
                          "distance": 0.1})  # under the threshold
        ctl.run_once()
        ctl.notify_drift({"slo": "drift", "kind": "skew_linf",
                          "distance": 0.3})
        strict = ctl.run_once()
        ctl.notify_drift({"slo": "drift", "kind": "drift_js",
                          "distance": 0.9})
        ctl.run_once()

        def knobs(p):
            (v,) = [c for c in p.components
                    if type(c).__name__ == "ExampleValidator"]
            return (v.exec_properties["fail_on_anomalies"],
                    v.exec_properties["skew_linf_threshold"])

        seen[side] = {"knobs": [knobs(p) for p in made],
                      "strict": _summary(strict)}
    assert seen["port"] == seen["ref"]
    assert seen["port"]["knobs"] == [(False, 0.0), (False, 0.0),
                                     (True, 0.2), (False, 0.0)]
    # The strict validator re-ran (its properties changed): not all cached.
    assert seen["port"]["strict"]["nodes_executed"] >= 1


def test_drift_evidence_is_recorded_only_after_a_successful_window_run(
        tmp_path):
    """A breach whose window run fails keeps its evidence armed: no
    drift_evidence context, no count; the next tick's successful run
    records it once."""
    fail = {"on": True}
    seen = {}
    for side in SIDES:
        ns = PKGS[side]

        @ns.component(inputs={"statistics": "ExampleStatistics"},
                      outputs={"model": "Model"}, name="Flaky")
        def Flaky(ctx):
            if fail["on"]:
                raise RuntimeError("window failed")

        def with_flaky(ns, p):
            merged = [c for c in p.components
                      if type(c).__name__ == "WindowStatisticsMerger"][0]
            p.components.append(Flaky(statistics=merged.outputs["statistics"]))

        reg = ns.metrics.MetricsRegistry()
        fail["on"] = False
        ctl, _, md, data = _drift_harness(ns, str(tmp_path / side),
                                          window=with_flaky, registry=reg)
        _write_span(data, 1, 12)
        ticks = [ctl.run_once()]
        fail["on"] = True
        ctl.notify_drift({"slo": "drift", "kind": "drift_js",
                          "distance": 0.5})
        ticks.append(ctl.run_once())
        evidence_after_failure = _evidence(ns, md)
        count_after_failure = reg.get(
            "continuous_drift_triggered_runs_total").get()
        fail["on"] = False
        ticks.append(ctl.run_once())
        seen[side] = {
            "ticks": [_summary(t) for t in ticks],
            "failed": (evidence_after_failure, count_after_failure),
            "evidence": _evidence(ns, md),
            "count": reg.get("continuous_drift_triggered_runs_total").get(),
            "runs": sorted(line for line in reg.to_prometheus().splitlines()
                           if line.startswith("continuous_runs_total")),
        }
    assert seen["port"] == seen["ref"]
    port = seen["port"]
    assert port["failed"] == ([], 0)
    assert "drift_triggered" not in port["ticks"][1]
    assert port["ticks"][2]["drift_triggered"] is True
    assert port["count"] == 1 and len(port["evidence"]) == 1
    assert any('outcome="failed"' in line for line in port["runs"])


# ------------------------------------------------------ the port's departures


def test_a_lint_gate_raises_naming_a20(tmp_path, monkeypatch):
    """The controller's lint gate, held against the reference's (it once
    raised naming ROADMAP.md A20): a window pipeline with a sub-second
    deadline on SchemaGen (TPP102, an ERROR) is refused by a gate asked
    for by the config ("error", "warn") or by TPP_LINT, after the span run
    and before the window run touches the store; "off" logs the findings
    and runs.  Both packages refuse with the same findings; a "warn" gate
    already trips on the span pipeline's warning."""
    def bad_window(ns, p):
        p.components[2].with_execution_timeout(0.5)

    seen = {}
    for side in SIDES:
        ns = PKGS[side]
        analysis = importlib.import_module(f"{ns.root}.analysis")
        got = []
        for lint, env in (("error", None), ("warn", None), (None, "error")):
            if env is None:
                monkeypatch.delenv("TPP_LINT", raising=False)
            else:
                monkeypatch.setenv("TPP_LINT", env)
            ctl, made, md, data = _drift_harness(
                ns, str(tmp_path / side / f"{lint}-{env}"), window=bad_window,
                lint=lint)
            _write_span(data, 1, 6)
            with pytest.raises(analysis.LintGateError) as e:
                ctl.run_once()
            store = ns.open_store(md)
            try:
                nodes = sorted({x.node_id for x in store.get_executions()})
            finally:
                store.close()
            got.append((sorted((f.rule, f.node_id, f.severity)
                               for f in e.value.findings), nodes))
        monkeypatch.delenv("TPP_LINT", raising=False)
        ctl, _, _, data = _drift_harness(
            ns, str(tmp_path / side / "off"), window=bad_window, lint="off")
        _write_span(data, 1, 6)
        got.append(ctl.run_once()["spans_processed"])
        seen[side] = got
    assert seen["port"] == seen["ref"]
    error, warn, env, off = seen["port"]
    assert ("TPP102", "SchemaGen", "error") in error[0]
    assert error[1] == ["CsvExampleGen", "StatisticsGen"]
    # "warn" trips on the span pipeline's own TPP101 (its statistics feed
    # no node of that pipeline), before any run.
    assert warn == ([("TPP101", "StatisticsGen", "warn")], [])
    assert env == error and off == 1


def test_the_controller_defaults_to_the_card(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ns = PKGS["port"]
    cfg = ns.continuous.ContinuousConfig(
        input_pattern=str(tmp_path / "span-{SPAN}"),
        make_span_pipeline=lambda s, v: None,
        make_window_pipeline=lambda: None)
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        ns.continuous.ContinuousController(cfg)


# ----------------------------------------------------------------- CLI

CONT_MODULE = '''
import os

TD = {td!r}


def _span_pipeline(span, version):
    from {pkg}.components import CsvExampleGen, StatisticsGen
    from {pkg}.dsl.pipeline import Pipeline

    gen = CsvExampleGen(
        input_path=os.path.join(TD, "data", "span-{{SPAN}}", "v-{{VERSION}}"),
        span=span,
    )
    stats = StatisticsGen(examples=gen.outputs["examples"],
                          save_accumulators=True)
    return Pipeline("cli-ingest", [gen, stats],
                    pipeline_root=os.path.join(TD, "root"),
                    metadata_path=os.path.join(TD, "md.sqlite"),
                    node_timeout_s=60)


def _window_pipeline():
    from {pkg}.components import RollingWindowResolver
    from {pkg}.continuous import SpanWindow, WindowStatisticsMerger
    from {pkg}.dsl.pipeline import Pipeline

    win = RollingWindowResolver(
        window_spans=2, source_pipeline="cli-ingest",
        examples_producer="CsvExampleGen",
        statistics_producer="StatisticsGen",
    )
    sw = SpanWindow(examples=win.outputs["examples"])
    merged = WindowStatisticsMerger(statistics=win.outputs["statistics"])
    return Pipeline("cli-window", [win, sw, merged],
                    pipeline_root=os.path.join(TD, "wroot"),
                    metadata_path=os.path.join(TD, "md.sqlite"),
                    node_timeout_s=60)


def create_continuous():
    from {pkg}.continuous import ContinuousConfig

    return ContinuousConfig(
        input_pattern=os.path.join(TD, "data", "span-{{SPAN}}",
                                   "v-{{VERSION}}"),
        make_span_pipeline=_span_pipeline,
        make_window_pipeline=_window_pipeline,
        poll_interval_s=0.1,
        state_dir=os.path.join(TD, "state"),
    )
'''


def test_cli_continuous_once(tmp_path, capsys):
    """``continuous --once``: loads create_continuous(), runs one
    iteration, prints the drained summary, exits 0; the port's with
    ``--device cpu``.  A second ``--max-iterations 2`` picks up a new span
    from the persisted state."""
    out = {}
    for side in SIDES:
        ns = PKGS[side]
        td = tmp_path / side
        _write_span(td / "data", 1, 8)
        module = td / "cont_module.py"
        module.write_text(CONT_MODULE.format(td=str(td), pkg=ns.root))
        extra = ["--device", "cpu"] if side == "port" else []
        runs = [ns.cli(["continuous", "--pipeline-module", str(module),
                        "--once", *extra])]
        text = [capsys.readouterr().out.splitlines()[-1]]
        _write_span(td / "data", 2, 8)
        runs.append(ns.cli(["continuous", "--pipeline-module", str(module),
                            "--max-iterations", "2", "--poll-interval",
                            "0.01", *extra]))
        text.append(capsys.readouterr().out.splitlines()[-1])
        out[side] = (runs, text)
    assert out["port"] == out["ref"]
    assert out["port"] == ([0, 0], [
        "continuous: stopped after 1 iteration(s); spans seen: [1]",
        "continuous: stopped after 2 iteration(s); spans seen: [1, 2]"])
