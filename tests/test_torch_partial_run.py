"""Port parity: partial runs (``from_nodes`` / ``to_nodes``) in the port's
``LocalDagRunner`` against the reference's, on host-only stub DAGs.

Each case builds the same DAG in both packages' DSLs, runs it through both
runners (the port's with ``device="cpu"``) over fresh stores, and compares
exactly: node statuses, the executor calls, the artifact ids a SKIPPED
node hands downstream (both stores assign ids in the same order), and
the per-node verdicts of the runs' traces.  Mirrors the reference's
``tests/test_local_runner.py`` partial-run cases, plus:

  - a Cond skip (direct or cascaded) replayed as COND_SKIPPED when the
    node is outside the range, never its older outputs
    (``tests/test_cond.py``);
  - a resolver's newest execution authoritative, an empty resolution
    kept empty (``tests/test_resolver.py``);
  - unknown bounds, and bounds with ``resume_from``, refused with the
    reference's ValueError (the port before it opens the store).
"""

import importlib
import os
import types

import pytest

SIDES = ("ref", "port")


def _pkg(name):
    root = "tpu_pipelines_torch" if name == "port" else "tpu_pipelines"
    ns = types.SimpleNamespace(root=root, calls=[])
    comp = importlib.import_module(f"{root}.dsl.component")
    dsl = importlib.import_module(f"{root}.dsl")
    ns.Cond, ns.runtime_parameter = dsl.Cond, dsl.runtime_parameter
    ns.Pipeline = importlib.import_module(f"{root}.dsl.pipeline").Pipeline
    ns.NodeIR = importlib.import_module(f"{root}.dsl.compiler").NodeIR
    md = importlib.import_module(f"{root}.metadata")
    ns.MetadataStore = md.MetadataStore
    types_mod = importlib.import_module(f"{root}.metadata.types")
    ns.Artifact, ns.ArtifactState = types_mod.Artifact, types_mod.ArtifactState
    ns.Execution, ns.ExecutionState = (types_mod.Execution,
                                       types_mod.ExecutionState)
    trace = importlib.import_module(f"{root}.observability.trace")
    export = importlib.import_module(f"{root}.observability.export")
    ns.events_path, ns.read_events = trace.events_path, export.read_events
    runner_cls = importlib.import_module(f"{root}.orchestration").LocalDagRunner
    ns.Runner = runner_cls
    ns.runner = ((lambda: runner_cls(device="cpu")) if name == "port"
                 else runner_cls)

    def stub(cname, inputs=(), outputs=("out",)):
        @comp.component(
            inputs={k: "Examples" for k in inputs},
            outputs={k: "Examples" for k in outputs},
            parameters={"content": comp.Parameter(type=str, default="d")},
            name=cname)
        def C(ctx):
            ns.calls.append(cname)
            for key in outputs:
                with open(os.path.join(ctx.output(key).uri, "data"), "w") as f:
                    f.write(ctx.exec_properties["content"])
            return {}
        return C

    ns.stub = stub
    return ns


PKGS = {side: _pkg(side) for side in SIDES}


@pytest.fixture(autouse=True)
def _fresh_calls(monkeypatch):
    monkeypatch.delenv("TPP_TRACE", raising=False)
    for ns in PKGS.values():
        ns.calls.clear()


def _chain(ns, base, **kw):
    gen = ns.stub("Gen")()
    stats = ns.stub("Stats", inputs=("examples",))(examples=gen.outputs["out"])
    train = ns.stub("Train", inputs=("examples",))(
        examples=stats.outputs["out"])
    return ns.Pipeline("partial", [gen, stats, train],
                       pipeline_root=os.path.join(base, "root"),
                       metadata_path=os.path.join(base, "md.sqlite"), **kw)


def _verdicts(ns, result, base):
    """(node, status) of each ``node`` span in the run's trace."""
    events = ns.read_events(ns.events_path(os.path.join(base, "root"),
                                           result.run_id))
    return sorted((e["node"], e["args"]["status"]) for e in events
                  if e.get("name") == "node" and e.get("cat") == "scheduler")


def _summary(ns, result, base):
    return {
        "status": {k: v.status for k, v in result.nodes.items()},
        "ids": {k: {key: [a.id for a in arts]
                    for key, arts in sorted(v.outputs.items())}
                for k, v in result.nodes.items()},
        "verdicts": _verdicts(ns, result, base),
        "calls": list(ns.calls),
        "succeeded": result.succeeded,
    }


def test_partial_run_to_nodes(tmp_path):
    """``to_nodes=["Stats"]``: Gen and Stats run; Train is SKIPPED with
    nothing to hand on (it never ran)."""
    got = {}
    for side, ns in PKGS.items():
        base = str(tmp_path / side)
        result = ns.runner().run(_chain(ns, base), to_nodes=["Stats"])
        got[side] = _summary(ns, result, base)
    assert got["port"] == got["ref"]
    assert got["port"]["calls"] == ["Gen", "Stats"]
    assert got["port"]["status"]["Train"] == "SKIPPED"
    assert got["port"]["ids"]["Train"] == {}


def test_partial_run_from_nodes_reuses_prior_outputs(tmp_path):
    """After a full run, ``from_nodes=["Train"]`` (cache off): Gen and
    Stats SKIPPED with run 1's artifacts, Train executes on them."""
    got = {}
    for side, ns in PKGS.items():
        base = str(tmp_path / side)
        first = ns.runner().run(_chain(ns, base))
        ns.calls.clear()
        result = ns.runner().run(_chain(ns, base, enable_cache=False),
                                 from_nodes=["Train"])
        got[side] = (_summary(ns, result, base),
                     {k: [a.id for a in v.outputs["out"]]
                      for k, v in first.nodes.items()})
    assert got["port"] == got["ref"]
    summary, first_ids = got["port"]
    assert summary["calls"] == ["Train"]
    assert summary["status"] == {"Gen": "SKIPPED", "Stats": "SKIPPED",
                                 "Train": "COMPLETE"}
    for node in ("Gen", "Stats"):
        assert summary["ids"][node] == {"out": first_ids[node]}


def test_partial_run_of_a_middle_node_between_both_bounds(tmp_path):
    """``from_nodes=to_nodes=["Stats"]`` with the cache on: only Stats is
    selected (a cache hit), its neighbours SKIPPED."""
    got = {}
    for side, ns in PKGS.items():
        base = str(tmp_path / side)
        ns.runner().run(_chain(ns, base))
        ns.calls.clear()
        result = ns.runner().run(_chain(ns, base), from_nodes=["Stats"],
                                 to_nodes=["Stats"])
        got[side] = _summary(ns, result, base)
    assert got["port"] == got["ref"]
    assert got["port"]["status"] == {"Gen": "SKIPPED", "Stats": "CACHED",
                                     "Train": "SKIPPED"}
    assert got["port"]["calls"] == []


def _gated(ns, base):
    """Producer -> Gated (inside Cond(deploy)) -> Mid -> Final."""
    prod = ns.stub("Producer")()
    with ns.Cond(ns.runtime_parameter("deploy", default=False) == True):  # noqa: E712
        gated = ns.stub("Gated", inputs=("examples",))(
            examples=prod.outputs["out"])
    mid = ns.stub("Mid", inputs=("examples",))(examples=gated.outputs["out"])
    final = ns.stub("Final", inputs=("examples",))(examples=mid.outputs["out"])
    return ns.Pipeline("gated", [prod, final],
                       pipeline_root=os.path.join(base, "root"),
                       metadata_path=os.path.join(base, "md.sqlite"))


@pytest.mark.parametrize("only", ["Mid", "Final"])
def test_a_cond_skip_replays_as_cond_skipped(tmp_path, only):
    """Run 1 deploys (the gated chain runs), run 2 does not (Gated skipped
    directly, Mid and Final by cascade, each recorded); a partial run of
    only ``Mid`` or ``Final`` replays the newest verdict: the unselected
    skipped nodes COND_SKIPPED, the selected one cascades, nothing runs.
    Run 4 deploys again; a partial run then replays outputs (SKIPPED)."""
    got = {}
    for side, ns in PKGS.items():
        base = str(tmp_path / side)
        build = lambda: _gated(ns, base)  # noqa: E731
        runs = [ns.runner().run(build(), runtime_parameters={"deploy": True}),
                ns.runner().run(build())]
        ns.calls.clear()
        runs.append(ns.runner().run(build(), from_nodes=[only],
                                    to_nodes=[only]))
        calls3 = list(ns.calls)
        runs.append(ns.runner().run(build(),
                                    runtime_parameters={"deploy": True}))
        runs.append(ns.runner().run(build(), from_nodes=[only],
                                    to_nodes=[only]))
        got[side] = ([_summary(ns, r, base)["status"] for r in runs], calls3,
                     _verdicts(ns, runs[2], base))
    assert got["port"] == got["ref"]
    statuses, calls3, _ = got["port"]
    assert statuses[1]["Gated"] == statuses[1]["Mid"] == "COND_SKIPPED"
    assert statuses[2][only] == "COND_SKIPPED" and calls3 == []
    assert statuses[2]["Gated"] == "COND_SKIPPED"
    assert statuses[4]["Gated"] == "SKIPPED"
    assert statuses[4][only] in ("COMPLETE", "CACHED")


def test_a_resolvers_empty_resolution_stays_empty(tmp_path):
    """The newest resolver execution is authoritative: a resolved model
    replays; a newer empty resolution replays empty (not the older
    model); a newer resolution of an artifact since retracted replays
    empty too.  A COMPLETE non-resolver execution with no outputs is
    passed over for an older one with outputs, as in the reference."""
    got = {}
    for side, ns in PKGS.items():
        store = ns.MetadataStore(str(tmp_path / f"{side}.sqlite"))
        node = ns.NodeIR(
            id="Resolver", component_type="Resolver", inputs={},
            outputs={"model": "Model"}, exec_properties={},
            executor_version="no-executor", upstream=[], is_resolver=True)
        replay = lambda: {  # noqa: E731
            k: [a.id for a in v]
            for k, v in ns.Runner._resolve_prior_outputs(store, node).items()}
        seen = []
        model = ns.Artifact(type_name="Model", uri="/m1",
                            state=ns.ArtifactState.LIVE)
        store.put_artifact(model)
        for outs in ({"model": [model]}, {"model": []}):
            store.publish_execution(ns.Execution(
                type_name="Resolver", node_id="Resolver",
                state=ns.ExecutionState.COMPLETE), {}, outs, [])
            seen.append(replay())
        model2 = ns.Artifact(type_name="Model", uri="/m2",
                             state=ns.ArtifactState.LIVE)
        store.put_artifact(model2)
        store.publish_execution(ns.Execution(
            type_name="Resolver", node_id="Resolver",
            state=ns.ExecutionState.COMPLETE), {}, {"model": [model2]}, [])
        seen.append(replay())
        model2.state = ns.ArtifactState.DELETED
        store.put_artifact(model2)
        seen.append(replay())
        plain = ns.NodeIR(
            id="Gen", component_type="Gen", inputs={},
            outputs={"out": "Examples"}, exec_properties={},
            executor_version="v", upstream=[])
        art = ns.Artifact(type_name="Examples", uri="/e",
                          state=ns.ArtifactState.LIVE)
        store.put_artifact(art)
        for outs in ({"out": [art]}, {}):
            store.publish_execution(ns.Execution(
                type_name="Gen", node_id="Gen",
                state=ns.ExecutionState.COMPLETE), {}, outs, [])
        seen.append({k: [a.id for a in v] for k, v in
                     ns.Runner._resolve_prior_outputs(store, plain).items()})
        seen.append(ns.Runner._latest_is_cond_skip(store, plain))
        store.close()
        got[side] = seen
    assert got["port"] == got["ref"]
    assert got["port"] == [{"model": [1]}, {"model": []}, {"model": [2]},
                           {"model": []}, {"out": [3]}, False]


@pytest.mark.parametrize("kwargs,match", [
    ({"from_nodes": ["Nope"]}, "Unknown node in partial-run bounds: 'Nope'"),
    ({"to_nodes": ["Stats", "Missing"]},
     "Unknown node in partial-run bounds: 'Missing'"),
    ({"from_nodes": ["Train"], "resume_from": "latest"},
     "resume_from is incompatible with from_nodes/to_nodes"),
])
def test_bad_bounds_are_refused_as_the_reference_refuses_them(
        tmp_path, kwargs, match):
    """Unknown bounds and bounds with ``resume_from`` raise the reference's
    ValueError; the port refuses before it opens the store, so no run
    context is written."""
    for side, ns in PKGS.items():
        base = str(tmp_path / side)
        with pytest.raises(ValueError, match=match):
            ns.runner().run(_chain(ns, base), **kwargs)
        assert ns.calls == []
    assert not os.path.exists(str(tmp_path / "port" / "md.sqlite"))
