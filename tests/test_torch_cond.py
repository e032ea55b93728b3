"""The port's ``Cond`` against the reference's (``tests/test_cond.py``):
predicate JSON equal to the reference's ``to_json``, ``evaluate_condition``
agreeing on the same properties and parameters, and in the runner the
skip, the cascade, the skip recorded and replayed on a rerun, and an
unresolved condition failing.  Each runner case runs the same DAG through
both packages' runners and compares node statuses and executor calls.
Partial runs (and the replay of a recorded skip into them) are
``ROADMAP.md`` A22 in the port.
"""

import importlib
import os
import types

import pytest

from tpu_pipelines.dsl import cond as ref_cond
from tpu_pipelines_torch.dsl import cond as port_cond


def _pkg(name):
    root = "tpu_pipelines_torch" if name == "port" else "tpu_pipelines"
    ns = types.SimpleNamespace()
    dsl = importlib.import_module(f"{root}.dsl")
    ns.Cond, ns.artifact_property = dsl.Cond, dsl.artifact_property
    ns.runtime_parameter = dsl.runtime_parameter
    comp = importlib.import_module(f"{root}.dsl.component")
    ns.component, ns.Parameter, ns.Channel = (
        comp.component, comp.Parameter, comp.Channel)
    ns.Pipeline = importlib.import_module(f"{root}.dsl.pipeline").Pipeline
    ns.Compiler = importlib.import_module(f"{root}.dsl.compiler").Compiler
    ns.Resolver = importlib.import_module(f"{root}.components").Resolver
    ns.MetadataStore = importlib.import_module(f"{root}.metadata").MetadataStore
    ns.ExecutionState = importlib.import_module(
        f"{root}.metadata.types").ExecutionState
    runner_cls = importlib.import_module(f"{root}.orchestration").LocalDagRunner
    ns.runner = (lambda: runner_cls(device="cpu")) if name == "port" else runner_cls

    @ns.component(outputs={"examples": "Examples"},
                  parameters={"quality": ns.Parameter(type=float, default=0.5)},
                  name="Producer")
    def Producer(ctx):
        out = ctx.output("examples")
        with open(os.path.join(out.uri, "data"), "w") as f:
            f.write("payload")
        out.properties["quality"] = ctx.exec_properties["quality"]
        out.properties["stats"] = {"rows": 100}
        return {}

    def consumer(cname, record):
        @ns.component(inputs={"examples": "Examples"},
                      outputs={"out": "Examples"}, name=cname)
        def C(ctx):
            record.append(cname)
            with open(os.path.join(ctx.output("out").uri, "data"), "w") as f:
                f.write("x")
            return {}
        return C

    ns.Producer, ns.consumer = Producer, consumer
    return ns


def _statuses(result):
    return {k: v.status for k, v in result.nodes.items()}


# -------------------------------------------------------- predicate JSON


def _predicates(mod, channel):
    return [
        mod.runtime_parameter("deploy", default=False) == True,  # noqa: E712
        mod.runtime_parameter("tier", default="a") != "b",
        mod.artifact_property(channel, "quality") >= 0.9,
        mod.artifact_property(channel, "stats.rows") > 10,
        mod.artifact_property(channel, "quality") < 0.2,
        mod.artifact_property(channel, "quality") <= 0.3,
    ]


def test_predicate_json_equals_the_reference():
    port, ref = _pkg("port"), _pkg("ref")
    got = [p.to_json() for p in _predicates(port_cond, port.Producer().outputs["examples"])]
    want = [p.to_json() for p in _predicates(ref_cond, ref.Producer().outputs["examples"])]
    assert got == want


def test_cond_compiles_into_the_same_ir(tmp_path):
    irs = {}
    for name in ("port", "ref"):
        ns = _pkg(name)
        prod = ns.Producer()
        with ns.Cond(ns.runtime_parameter("deploy", default=False) == True):  # noqa: E712
            with ns.Cond(ns.artifact_property(prod.outputs["examples"],
                                              "quality") >= 0.9):
                gated = ns.consumer("Gated", [])(examples=prod.outputs["examples"])
        ir = ns.Compiler().compile(ns.Pipeline(
            "cond-ir", [prod, gated], pipeline_root=str(tmp_path)))
        irs[name] = ir.to_json()["nodes"][-1]["conditions"]
    assert irs["port"] == irs["ref"]
    assert irs["port"][0] == {"kind": "runtime_parameter", "op": "eq",
                              "value": True, "param": "deploy",
                              "default": False}


class _Art:
    def __init__(self, props):
        self.properties = props


@pytest.mark.parametrize("params", [{}, {"deploy": True}, {"deploy": False},
                                    {"tier": "b"}])
@pytest.mark.parametrize("quality", [0.1, 0.25, 0.5, 0.95])
def test_evaluate_condition_agrees(params, quality):
    ns = _pkg("ref")
    preds = [p.to_json() for p in _predicates(ref_cond, ns.Producer().outputs["examples"])]
    produced = {"Producer": {"examples": [_Art(
        {"quality": quality, "stats": {"rows": int(quality * 100)}})]}}
    for pred in preds:
        assert port_cond.evaluate_condition(pred, produced, params) == \
            ref_cond.evaluate_condition(pred, produced, params)


def test_unresolved_and_empty_producer_outputs_agree():
    ns = _pkg("ref")
    pred = (ref_cond.artifact_property(ns.Producer().outputs["examples"],
                                       "quality") >= 0.9).to_json()
    for mod in (port_cond, ref_cond):
        with pytest.raises(mod.ConditionUnresolvedError, match="no published"):
            mod.evaluate_condition(pred, {}, {})
        with pytest.raises(mod.ConditionUnresolvedError):
            mod.evaluate_condition(pred, {"Producer": {}}, {})
        # Ran and published an empty list: unmet, not unresolved.
        assert mod.evaluate_condition(pred, {"Producer": {"examples": []}},
                                      {}) is False


def test_cond_predicate_type_error_and_chained_comparison():
    ns = _pkg("port")
    with pytest.raises(TypeError, match="predicate"):
        port_cond.Cond(True)
    ref_ = port_cond.artifact_property(ns.Producer().outputs["examples"],
                                       "quality")
    with pytest.raises(TypeError, match="chained comparisons"):
        bool(0.5 <= ref_ <= 0.9)  # noqa: B015 — the misuse under test
    with pytest.raises(ValueError, match="producer"):
        port_cond.artifact_property(ns.Channel("Examples"), "quality")


# ------------------------------------------------------------- the runner


def _both(fn):
    out = {name: fn(_pkg(name), name) for name in ("port", "ref")}
    assert out["port"] == out["ref"]
    return out["port"]


def test_runtime_parameter_gate(tmp_path):
    def flow(ns, name):
        record = []
        prod = ns.Producer()
        with ns.Cond(ns.runtime_parameter("deploy", default=False) == True):  # noqa: E712
            gated = ns.consumer("Gated", record)(examples=prod.outputs["examples"])
        pipe = lambda: ns.Pipeline(  # noqa: E731
            "cond-rt", [prod, gated], pipeline_root=str(tmp_path / name / "root"),
            metadata_path=str(tmp_path / name / "md.sqlite"))
        r1 = ns.runner().run(pipe())
        r2 = ns.runner().run(pipe(), runtime_parameters={"deploy": True})
        return [_statuses(r1), r1.succeeded, _statuses(r2), r2.succeeded, record]

    got = _both(flow)
    assert got[0]["Gated"] == "COND_SKIPPED" and got[1]
    assert got[2]["Gated"] == "COMPLETE" and got[4] == ["Gated"]


def test_artifact_property_gate_and_cascade(tmp_path):
    def flow(ns, name):
        out = []
        for quality in (0.3, 0.95):
            record = []
            prod = ns.Producer(quality=quality)
            with ns.Cond(ns.artifact_property(prod.outputs["examples"],
                                              "quality") >= 0.9):
                with ns.Cond(ns.artifact_property(prod.outputs["examples"],
                                                  "stats.rows") > 10):
                    gated = ns.consumer("Gated", record)(
                        examples=prod.outputs["examples"])
            down = ns.consumer("Downstream", record)(examples=gated.outputs["out"])
            r = ns.runner().run(ns.Pipeline(
                f"cond-prop{quality}", [prod, down],
                pipeline_root=str(tmp_path / name / f"root{quality}"),
                metadata_path=str(tmp_path / name / f"md{quality}.sqlite")))
            out.append([_statuses(r), r.succeeded, record])
        return out

    got = _both(flow)
    assert got[0][0] == {"Producer": "COMPLETE", "Gated": "COND_SKIPPED",
                         "Downstream": "COND_SKIPPED"} and got[0][1]
    assert got[1][2] == ["Gated", "Downstream"]


def test_nested_cond_requires_all_and_the_predicate_is_a_dependency(tmp_path):
    def flow(ns, name):
        record = []
        prod = ns.Producer(quality=0.95)
        with ns.Cond(ns.artifact_property(prod.outputs["examples"], "quality") >= 0.9):
            with ns.Cond(ns.runtime_parameter("deploy", default=False) == True):  # noqa: E712
                gated = ns.consumer("Gated", record)(examples=prod.outputs["examples"])

        @ns.component(outputs={"out": "Examples"}, name="NoInputs")
        def NoInputs(ctx):
            record.append("NoInputs")
            with open(os.path.join(ctx.output("out").uri, "d"), "w") as f:
                f.write("x")
            return {}

        with ns.Cond(ns.artifact_property(prod.outputs["examples"], "quality") >= 0.9):
            lone = NoInputs()
        p = ns.Pipeline("cond-nest", [gated, lone],
                        pipeline_root=str(tmp_path / name / "root"),
                        metadata_path=str(tmp_path / name / "md.sqlite"))
        r = ns.runner().run(p)
        return [[c.id for c in p.components], _statuses(r), record]

    got = _both(flow)
    assert got[1]["Gated"] == "COND_SKIPPED" and got[2] == ["NoInputs"]


def test_cond_skip_is_recorded_and_replays_on_rerun(tmp_path):
    """The verdict is a CANCELED execution carrying ``cond_skipped``; a
    rerun with the parameter unset skips again (and records again), and
    the condition-less consumer cascades each time; deploy=true brings the
    chain back."""
    def flow(ns, name):
        record = []
        base = tmp_path / name

        def build():
            prod = ns.Producer()
            with ns.Cond(ns.runtime_parameter("deploy", default=False) == True):  # noqa: E712
                gated = ns.consumer("Gated", record)(examples=prod.outputs["examples"])
            mid = ns.consumer("Mid", record)(examples=gated.outputs["out"])
            return ns.Pipeline("cond-replay", [prod, mid],
                               pipeline_root=str(base / "root"),
                               metadata_path=str(base / "md.sqlite"))

        runs = [ns.runner().run(build(), runtime_parameters={"deploy": True}),
                ns.runner().run(build()), ns.runner().run(build()),
                ns.runner().run(build(), runtime_parameters={"deploy": True})]
        store = ns.MetadataStore(str(base / "md.sqlite"))
        records = {
            node: [(e.state.value, e.properties.get("cond_skipped"),
                    e.properties.get("unmet_conditions"))
                   for e in store.get_executions(node_id=node)
                   if e.state == ns.ExecutionState.CANCELED]
            for node in ("Gated", "Mid")
        }
        store.close()
        return [[_statuses(r) for r in runs], record, records]

    statuses, record, records = _both(flow)
    for node in ("Gated", "Mid"):
        assert [s[node] for s in statuses[:3]] == [
            "COMPLETE", "COND_SKIPPED", "COND_SKIPPED"]
        assert statuses[3][node] in ("COMPLETE", "CACHED")
    assert record[:2] == ["Gated", "Mid"]
    assert len(records["Gated"]) == 2 and records["Gated"][0][1] is True
    assert records["Mid"][0][2] == []          # a cascade: nothing unmet


def test_cond_on_empty_resolver_output_skips_not_fails(tmp_path):
    def flow(ns, name):
        record = []
        resolver = ns.Resolver()
        with ns.Cond(ns.artifact_property(resolver.outputs["model"],
                                          "blessed") == True):  # noqa: E712
            @ns.component(inputs={"model": "Model"}, outputs={"out": "Examples"},
                          optional_inputs=("model",), name="Gated")
            def Gated(ctx):
                record.append("Gated")
                return {}

            gated = Gated(model=resolver.outputs["model"])
        r = ns.runner().run(ns.Pipeline(
            "cond-empty-resolver", [resolver, gated],
            pipeline_root=str(tmp_path / name / "root"),
            metadata_path=str(tmp_path / name / "md.sqlite")))
        return [_statuses(r), r.succeeded, record]

    got = _both(flow)
    assert got == [{"Resolver": "COMPLETE", "Gated": "COND_SKIPPED"}, True, []]


def test_an_unresolved_condition_fails_the_node_not_skips(tmp_path):
    """The runner's verdict on a predicate whose producer never published:
    FAILED with the pointed error, and no CANCELED record."""
    from tpu_pipelines_torch.dsl.compiler import Compiler
    from tpu_pipelines_torch.metadata import MetadataStore
    from tpu_pipelines_torch.orchestration.local_runner import LocalDagRunner

    ns = _pkg("port")
    prod = ns.Producer(quality=0.99)
    with ns.Cond(ns.artifact_property(prod.outputs["examples"], "quality") >= 0.9):
        gated = ns.consumer("Gated", [])(examples=prod.outputs["examples"])
    ir = Compiler().compile(ns.Pipeline("cond-unresolved", [prod, gated],
                                        pipeline_root=str(tmp_path)))
    store = MetadataStore(str(tmp_path / "md.sqlite"))
    import threading

    nr = LocalDagRunner._cond_outcome(
        store, ir.node("Gated"), {}, set(), {}, [], threading.Lock())
    store.close()
    assert nr.status == "FAILED" and "no published outputs" in nr.error
