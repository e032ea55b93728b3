"""The port's ``Resolver`` / ``RollingWindowResolver`` against the
reference's (``tests/test_resolver.py``): each strategy over the same
synthetic lineage in each package's store resolves the same artifact ids,
and the same sequence of runs through both packages' runners resolves the
same run's artifact, run after run: the bootstrap (empty), the latest
blessed, the latest created, the rolling window over spans, a resolver
that is never cached and re-emits the existing artifact (same id).
"""

import importlib
import os
import types

import pytest


def _pkg(name):
    root = "tpu_pipelines_torch" if name == "port" else "tpu_pipelines"
    ns = types.SimpleNamespace()
    comps = importlib.import_module(f"{root}.components")
    ns.Resolver, ns.RollingWindowResolver = (
        comps.Resolver, comps.RollingWindowResolver)
    ns.resolve_artifacts = importlib.import_module(
        f"{root}.components.resolver").resolve_artifacts
    ns.MetadataStore = importlib.import_module(f"{root}.metadata").MetadataStore
    types_ = importlib.import_module(f"{root}.metadata.types")
    for n in ("Artifact", "ArtifactState", "Context", "Execution",
              "ExecutionState"):
        setattr(ns, n, getattr(types_, n))
    comp = importlib.import_module(f"{root}.dsl.component")
    ns.component, ns.Parameter = comp.component, comp.Parameter
    ns.Pipeline = importlib.import_module(f"{root}.dsl.pipeline").Pipeline
    runner_cls = importlib.import_module(f"{root}.orchestration").LocalDagRunner
    ns.runner = ((lambda **kw: runner_cls(device="cpu", **kw))
                 if name == "port" else runner_cls)
    return ns


# ------------------------------------------------------------ strategy unit


def _publish_eval(ns, store, ctx, model_uri, blessed):
    """Synthetic Evaluator lineage: model -> execution -> blessing."""
    model = ns.Artifact(type_name="Model", uri=model_uri,
                        state=ns.ArtifactState.LIVE)
    store.put_artifact(model)
    store.attribute(ctx.id, model.id)
    blessing = ns.Artifact(type_name="ModelBlessing",
                           uri=model_uri + "/blessing",
                           properties={"blessed": blessed})
    ex = ns.Execution(type_name="Evaluator", node_id="Evaluator",
                      state=ns.ExecutionState.COMPLETE)
    store.publish_execution(ex, {"model": [model]}, {"blessing": [blessing]},
                            [ctx])
    return model


def _model_strategies(name):
    ns = _pkg(name)
    store = ns.MetadataStore(":memory:")
    ctx = ns.Context("pipeline", "p1")
    other = ns.Context("pipeline", "p2")
    store.put_context(ctx)
    store.put_context(other)
    seen = []

    def resolve(strategy, **kw):
        out = ns.resolve_artifacts(store, strategy=strategy,
                                   pipeline_name="p1", **kw)
        seen.append((strategy, kw, [a.uri for a in out["model"]]))

    resolve("latest_blessed_model")
    resolve("latest_created")
    _publish_eval(ns, store, ctx, "/m1", blessed=True)
    _publish_eval(ns, store, ctx, "/m2", blessed=False)
    resolve("latest_blessed_model")
    resolve("latest_created")
    _publish_eval(ns, store, other, "/m3", blessed=True)
    resolve("latest_blessed_model")
    resolve("latest_blessed_model", within_pipeline=False)
    resolve("latest_created", within_pipeline=False)
    store.close()
    return seen


def test_model_strategies_resolve_as_the_reference():
    got = _model_strategies("port")
    assert got == _model_strategies("ref")
    assert [uris for _, _, uris in got] == [
        [], [], ["/m1"], ["/m2"], ["/m1"], ["/m3"], ["/m3"]]


@pytest.mark.parametrize("name", ["port", "ref"])
def test_unknown_strategy_raises(name):
    ns = _pkg(name)
    with pytest.raises(ValueError, match="unknown resolver strategy"):
        ns.resolve_artifacts(ns.MetadataStore(":memory:"), strategy="newest",
                             pipeline_name="p")


def _publish_span(ns, store, ctx, type_name, span, version, node):
    art = ns.Artifact(type_name=type_name, uri=f"/{type_name}/{span}/{version}",
                      properties={"span": span, **(
                          {} if version is None else {"version": version})})
    ex = ns.Execution(type_name=node, node_id=node,
                      state=ns.ExecutionState.COMPLETE)
    store.publish_execution(ex, {}, {"out": [art]}, [ctx])
    return art


def _rolling(name):
    ns = _pkg(name)
    store = ns.MetadataStore(":memory:")
    ingest, train = ns.Context("pipeline", "ingest"), ns.Context("pipeline", "train")
    store.put_context(ingest)
    store.put_context(train)
    for span, version in ((1, None), (2, None), (3, 1), (3, 3), (3, 2), (4, None)):
        _publish_span(ns, store, ingest, "Examples", span, version, "ExampleGen")
        _publish_span(ns, store, ingest, "Examples", span, version, "Transform")
        if span != 2:
            _publish_span(ns, store, ingest, "ExampleStatistics", span, version,
                          "StatisticsGen")
    _publish_eval(ns, store, train, "/baseline", blessed=True)
    out = []
    for extra in ({"window_spans": 3, "source_pipeline": "ingest",
                   "examples_producer": "ExampleGen"},
                  {"window_spans": 2, "source_pipeline": "ingest",
                   "examples_producer": "Transform"},
                  {"window_spans": 9, "source_pipeline": "nowhere"},
                  {"window_spans": 2}):
        res = ns.resolve_artifacts(store, strategy="rolling_window",
                                   pipeline_name="train",
                                   within_pipeline=False, extra=extra)
        out.append({k: [a.uri for a in v] for k, v in res.items()})
    store.close()
    return out


def test_rolling_window_resolves_as_the_reference():
    got = _rolling("port")
    assert got == _rolling("ref")
    # The last three spans, span-ascending, the highest version of the
    # re-delivered span 3; statistics only where a span has them.
    assert got[0]["examples"] == ["/Examples/2/None", "/Examples/3/3",
                                  "/Examples/4/None"]
    assert got[0]["statistics"] == ["/ExampleStatistics/3/3",
                                    "/ExampleStatistics/4/None"]
    assert got[0]["model"] == ["/baseline"]
    assert got[2]["examples"] == []


# ------------------------------------------------------------- the runner


def _runs(name, tmp_path):
    """A model producer, a Resolver of each model strategy and a consumer
    whose ``baseline`` is optional.  Runs: a bootstrap model left
    unblessed, a blessed one, a warm rerun, a new unblessed model.  Per run: statuses, what each resolver
    resolved (as the producing run's index), what the consumer saw."""
    ns = _pkg(name)
    base = tmp_path / name
    seen = []

    @ns.component(outputs={"model": "Model"},
                  parameters={"tag": ns.Parameter(type=int, default=0)},
                  name="Train")
    def Train(ctx):
        with open(os.path.join(ctx.output("model").uri, "w"), "w") as f:
            f.write(str(ctx.exec_properties["tag"]))
        return {}

    @ns.component(inputs={"model": "Model", "baseline": "Model"},
                  outputs={"evaluation": "ModelEvaluation"},
                  optional_inputs=("baseline",), name="Evaluate")
    def Evaluate(ctx):
        seen.append((sorted(ctx.inputs), [a.id for a in ctx.inputs.get("baseline", [])]))
        return {}

    def build(tag):
        train = Train(tag=tag)
        blessed = ns.Resolver(strategy="latest_blessed_model",
                              instance_name="Blessed")
        latest = ns.Resolver(strategy="latest_created", instance_name="Latest")
        ev = Evaluate(model=train.outputs["model"],
                      baseline=blessed.outputs["model"])
        return ns.Pipeline("retrain", [train, ev, latest],
                           pipeline_root=str(base / "root"),
                           metadata_path=str(base / "md.sqlite"))

    # After each run a blessing of its new model is published as an
    # Evaluator would record it (the model as the execution's input), the
    # lineage latest_blessed_model walks.
    out = []
    model_ids = []
    for bless, tag in ((False, 1), (True, 2), (True, 2), (False, 3)):
        # One node at a time, in topological order: Latest has no
        # upstream, and run beside Train it would resolve either the
        # previous run's model or this run's, whichever came first.
        r = ns.runner(max_parallel_nodes=1).run(build(tag))
        store = ns.MetadataStore(str(base / "md.sqlite"))
        model = r.outputs_of("Train", "model")[0]
        if r.nodes["Train"].status == "COMPLETE":
            model_ids.append(model.id)
            ex = ns.Execution(type_name="Evaluator", node_id="Evaluator",
                              state=ns.ExecutionState.COMPLETE)
            blessing = ns.Artifact(type_name="ModelBlessing",
                                   uri=model.uri + "-blessing",
                                   properties={"blessed": bless})
            ctx = store.get_context("pipeline", "retrain")
            store.publish_execution(ex, {"model": [model]},
                                    {"blessing": [blessing]}, [ctx])
        resolver_ex = {n: store.get_executions(node_id=n)[-1]
                       for n in ("Blessed", "Latest")}
        store.close()
        index = {mid: i for i, mid in enumerate(model_ids)}
        out.append({
            "statuses": {k: v.status for k, v in r.nodes.items()},
            "resolved": {n: [index.get(a.id) for a in r.outputs_of(n, "model")]
                         for n in ("Blessed", "Latest")},
            "recorded": {n: (e.state.value, len(e.properties[
                "resolved_artifact_ids"]), e.properties["strategy"])
                for n, e in resolver_ex.items()},
            "same_id": all(a.id in model_ids for n in ("Blessed", "Latest")
                           for a in r.outputs_of(n, "model")),
        })
    return out, [(keys, [model_ids.index(i) for i in ids]) for keys, ids in seen]


def test_a_run_sequence_resolves_the_same_run_in_both_runners(tmp_path):
    port, port_seen = _runs("port", tmp_path)
    ref, ref_seen = _runs("ref", tmp_path)
    assert port == ref and port_seen == ref_seen
    # Bootstrap: nothing blessed, the optional baseline wired but empty.
    assert port[0]["resolved"] == {"Blessed": [], "Latest": [0]}
    assert port_seen[0] == (["baseline", "model"], [])
    # Run 2 resolves run 1's blessing (published after run 1): none; run 3
    # (warm) re-emits run 2's blessed model with its artifact id; the
    # resolvers ran every time (never cached, never CACHED).
    assert port[2]["resolved"]["Blessed"] == [1]
    assert port[3]["resolved"]["Blessed"] == [1]
    assert port[3]["resolved"]["Latest"] == [2]
    for run in port:
        assert run["statuses"]["Blessed"] == "COMPLETE"
        assert run["statuses"]["Latest"] == "COMPLETE"
        assert run["same_id"]
    assert port[2]["statuses"]["Train"] == "CACHED"


@pytest.mark.parametrize("name", ["port", "ref"])
def test_a_failing_strategy_fails_the_node(tmp_path, name):
    ns = _pkg(name)
    r = ns.runner().run(ns.Pipeline(
        "bad", [ns.Resolver(strategy="newest")],
        pipeline_root=str(tmp_path / "root"),
        metadata_path=str(tmp_path / "md.sqlite")), raise_on_failure=False)
    assert r.nodes["Resolver"].status == "FAILED"
    assert "unknown resolver strategy" in r.nodes["Resolver"].error
