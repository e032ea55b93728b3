"""Port parity: the static analyzer (``tpu_pipelines_torch/analysis``)
against the JAX package's, test by test after ``tests/test_analysis.py``.

Every check is exact:

  - graph rules (TPP1xx): the same pipeline, built in both packages' DSLs,
    gives the same (rule, node, severity) findings, and the reference
    test's own assertions hold on the port's;
  - code rules (TPP2xx): a source with each hazard gives the same rule ids
    in both packages; for the hazards the JAX package looks for inside
    ``@jax.jit`` (TPP203/204/205) and beside a jitted training window
    (TPP207), the port's source is the torch twin: the same hazard inside
    a captured region (``@torch.compile``, a function handed to
    ``train_loop(loss_fn=...)`` or ``make_graphed_callables``, a ``with
    torch.cuda.graph(...)`` block) or beside ``TrainLoopConfig(
    window_steps>1)``;
  - TPP208 reads each package's own committed crossovers, so each side's
    fixture sits below its own floor;
  - the repo-level rules (TPP211/TPP214) hold the port's tree against the
    shared catalogs and the port's own ``METRICS.md``;
  - every example pipeline of the port lints clean, and the gates refuse
    as the reference's do: the CLI exits 3 (1 when the module cannot
    load), ``run(lint="error")`` raises before the store exists.
"""

import importlib
import json
import os
import re
import subprocess
import sys
import textwrap
import types

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SIDES = ("ref", "port")


def _pkg(name):
    root = "tpu_pipelines_torch" if name == "port" else "tpu_pipelines"
    ns = types.SimpleNamespace(root=root, name=name)
    comp = importlib.import_module(f"{root}.dsl.component")
    ns.component, ns.Parameter, ns.RuntimeParameter = (
        comp.component, comp.Parameter, comp.RuntimeParameter)
    ns.Pipeline = importlib.import_module(f"{root}.dsl.pipeline").Pipeline
    ns.Compiler = importlib.import_module(f"{root}.dsl.compiler").Compiler
    ns.A = importlib.import_module(f"{root}.analysis")
    ns.RULES = importlib.import_module(f"{root}.analysis.findings").RULES
    ns.main = importlib.import_module(f"{root}.__main__").main
    ns.load_fn = importlib.import_module(f"{root}.utils.module_loader").load_fn
    ns.fp = importlib.import_module(f"{root}.utils.fingerprint")
    ns.autotune = importlib.import_module(f"{root}.ops.autotune")
    ns.RollingWindowResolver = importlib.import_module(
        f"{root}.components").RollingWindowResolver
    runner_cls = importlib.import_module(f"{root}.orchestration").LocalDagRunner
    ns.runner = ((lambda: runner_cls(device="cpu")) if name == "port"
                 else runner_cls)
    ns.examples = (
        {n: os.path.join(REPO, root, "examples", f"{n}_pipeline.py")
         for n in ("taxi", "bert", "t5")} if name == "port" else
        {n: os.path.join(REPO, "examples", n, "pipeline.py")
         for n in ("taxi", "bert", "t5")})
    return ns


PKGS = {side: _pkg(side) for side in SIDES}


def _both(fn, tmp_path):
    """``fn(ns, tmp)`` for each package, each in its own directory."""
    out = {}
    for side, ns in PKGS.items():
        tmp = tmp_path / side
        tmp.mkdir(parents=True, exist_ok=True)
        out[side] = fn(ns, tmp)
    return out


def _rules(findings):
    return sorted({f.rule for f in findings})


def _key(findings):
    return sorted((f.rule, f.node_id, f.severity) for f in findings)


# ------------------------------------------------------------ stub builders


def _gen(ns, **params):
    decl = {k: ns.Parameter(type=object, default=None) for k in params}

    @ns.component(outputs={"examples": "Examples"}, parameters=decl,
                  name="Gen")
    def Gen(ctx):
        pass

    return Gen(**params)


def _consumer(ns, gen, name="Stats", outs=None, resource_class="host"):
    @ns.component(inputs={"examples": "Examples"},
                  outputs=outs or {"statistics": "ExampleStatistics"},
                  name=name, resource_class=resource_class)
    def C(ctx):
        pass

    return C(examples=gen.outputs["examples"])


def _consumer_of_stats(ns, stats):
    @ns.component(inputs={"statistics": "ExampleStatistics"}, outputs={},
                  name="StatsSink", is_sink=True)
    def StatsSink(ctx):
        pass

    return StatsSink(statistics=stats.outputs["statistics"])


def _pipeline(ns, comps, tmp, **kw):
    return ns.Pipeline("lint-fixture", comps,
                       pipeline_root=str(tmp / "root"),
                       metadata_path=str(tmp / "md.sqlite"), **kw)


def _ir_findings(ns, comps, tmp, **kw):
    return ns.A.analyze_ir(ns.Compiler().compile(_pipeline(ns, comps, tmp,
                                                           **kw)))


def _cli(ns, argv, capsys):
    """``python -m <package> ...`` in this process: (exit code, stdout)."""
    extra = []
    if ns.name == "port" and argv[0] == "run":
        extra = ["--device", "cpu"]
    code = ns.main([*argv, *extra])
    return code, capsys.readouterr().out


# ------------------------------------------------- examples lint clean (AC)


def test_all_six_examples_lint_clean(tmp_path, monkeypatch):
    """Zero findings, ERROR and WARN, on every example pipeline the port
    ships (taxi, BERT, T5) through both layers, as on the reference's
    same three (which lints its other three clean in its own test)."""
    monkeypatch.setenv("TPP_PIPELINE_HOME", str(tmp_path / "home"))
    for k, v in {"BERT_TINY": "1", "T5_TINY": "1"}.items():
        monkeypatch.setenv(k, v)

    def lint(ns, tmp):
        dirty = {}
        for name, path in ns.examples.items():
            findings = ns.A.analyze_pipeline(
                ns.load_fn(path, "create_pipeline")())
            if findings:
                dirty[name] = ns.A.format_findings(findings)
        return dirty

    got = _both(lint, tmp_path)
    assert got == {"ref": {}, "port": {}}, f"examples must lint clean: {got}"


# ----------------------------------------------- TPP1xx seeded-bug fixtures


def test_tpp101_dead_end_node(tmp_path):
    def run(ns, tmp):
        gen = _gen(ns)
        return _key(_ir_findings(ns, [gen, _consumer(ns, gen, "DeadEnd")],
                                 tmp))

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"] == [("TPP101", "DeadEnd", "warn")]


def test_tpp101_sink_exempt(tmp_path):
    def run(ns, tmp):
        gen = _gen(ns)

        @ns.component(inputs={"examples": "Examples"},
                      outputs={"report": "ModelEvaluation"}, name="SinkLike",
                      is_sink=True)
        def SinkLike(ctx):
            pass

        return _ir_findings(ns, [gen, SinkLike(examples=gen.outputs[
            "examples"])], tmp)

    assert _both(run, tmp_path) == {"ref": [], "port": []}


def test_tpp102_subsecond_deadline(tmp_path):
    def run(ns, tmp):
        gen = _gen(ns)
        stats = _consumer(ns, gen).with_execution_timeout(0.5)
        findings = _ir_findings(
            ns, [gen, stats, _consumer_of_stats(ns, stats)], tmp)
        return _key(findings), [f.message for f in findings]

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"]
    assert got["port"][0] == [("TPP102", "Stats", "error")]
    assert "sub-second" in got["port"][1][0]


def test_tpp102_redundant_default_duplicate(tmp_path):
    def run(ns, tmp):
        gen = _gen(ns)
        stats = _consumer(ns, gen).with_execution_timeout(30.0)
        findings = _ir_findings(
            ns, [gen, stats, _consumer_of_stats(ns, stats)], tmp,
            node_timeout_s=30.0)
        return _key(findings), [f.message for f in findings]

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"]
    assert got["port"][0] == [("TPP102", "Stats", "warn")]
    assert "duplicates the pipeline default" in got["port"][1][0]


def test_tpp103_tpu_level_conflict_and_suppression(tmp_path):
    def run(ns, tmp):
        gen = _gen(ns)
        a = _consumer(ns, gen, name="TpuA", resource_class="tpu")
        b = _consumer(ns, gen, name="TpuB", outs={"schema": "Schema"},
                      resource_class="tpu")

        @ns.component(inputs={"statistics": "ExampleStatistics",
                              "schema": "Schema"},
                      outputs={}, name="Join", is_sink=True)
        def Join(ctx):
            pass

        join = Join(statistics=a.outputs["statistics"],
                    schema=b.outputs["schema"])
        first = _ir_findings(ns, [gen, a, b, join], tmp)
        a.with_lint_suppressions("TPP103")
        second = _ir_findings(ns, [gen, a, b, join], tmp)
        return (_key(first), all("gate_wait" in f.message for f in first),
                _key(second))

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"]
    assert got["port"] == ([("TPP103", "TpuA", "warn"),
                            ("TPP103", "TpuB", "warn")], True,
                           [("TPP103", "TpuB", "warn")])


def test_with_lint_suppressions_rejects_unknown_rule(tmp_path):
    for ns in PKGS.values():
        with pytest.raises(ValueError, match="unknown lint rule"):
            _gen(ns).with_lint_suppressions("TPP999")
    assert set(PKGS["port"].RULES) == set(PKGS["ref"].RULES)
    assert {k: v["severity"] for k, v in PKGS["port"].RULES.items()} == {
        k: v["severity"] for k, v in PKGS["ref"].RULES.items()}


class Opaque:
    pass


def test_tpp104_address_bearing_exec_property(tmp_path):
    def run(ns, tmp):
        gen = _gen(ns, knob=Opaque())
        sink = _consumer(ns, gen, name="S", outs={})
        sink.SPEC.outputs.clear()
        errs = [f for f in _ir_findings(ns, [gen, sink], tmp)
                if f.rule == "TPP104"]
        return _key(errs), ["memory address" in f.message for f in errs]

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"] == ([("TPP104", "Gen", "error")], [True])


def test_tpp104_deterministic_but_unjsonable_is_warn(tmp_path):
    def run(ns, tmp):
        gen = _gen(ns, knob=complex(1, 2))
        sink = _consumer(ns, gen, name="S", outs={})
        return _key(f for f in _ir_findings(ns, [gen, sink], tmp)
                    if f.rule == "TPP104")

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"] == [("TPP104", "Gen", "warn")]


def test_tpp105_unresolved_runtime_parameter(tmp_path):
    def run(ns, tmp):
        gen = _gen(ns, knob=ns.RuntimeParameter("data_path"))
        f105 = [f for f in _ir_findings(
            ns, [gen, _consumer(ns, gen, name="S", outs={})], tmp)
            if f.rule == "TPP105"]
        gen2 = _gen(ns, knob=ns.RuntimeParameter("data_path",
                                                 default="/d.csv"))
        f105b = [f for f in _ir_findings(
            ns, [gen2, _consumer(ns, gen2, name="S", outs={})], tmp)
            if f.rule == "TPP105"]
        return _key(f105), ["data_path" in f.message for f in f105], f105b

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"] == (
        [("TPP105", "Gen", "warn")], [True], [])


def test_tpp106_missing_producer(tmp_path):
    def run(ns, tmp):
        gen = _gen(ns)
        stats = _consumer(ns, gen)
        ir = ns.Compiler().compile(_pipeline(
            ns, [gen, stats, _consumer_of_stats(ns, stats)], tmp))
        ir.nodes = [n for n in ir.nodes if n.id != "Gen"]
        return _key(f for f in ns.A.analyze_ir(ir) if f.rule == "TPP106")

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"]
    assert {n for _, n, _ in got["port"]} == {"Stats"}
    assert {s for _, _, s in got["port"]} == {"error"}


def test_tpp107_duplicate_node_ids(tmp_path):
    def run(ns, tmp):
        gen = _gen(ns)
        ir = ns.Compiler().compile(_pipeline(
            ns, [gen, _consumer(ns, gen, name="S", outs={})], tmp))
        ir.nodes.append(ir.nodes[0])
        return _key(f for f in ns.A.analyze_ir(ir) if f.rule == "TPP107")

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"] == [("TPP107", "Gen", "error")]


def test_tpp108_retry_policy_under_spmd(tmp_path):
    """The rule on an IR stamped as ``lint --spmd-sync`` (and the runner
    under spmd_sync) stamps it."""
    def run(ns, tmp):
        gen = _gen(ns).with_retry_policy(max_attempts=3, base_delay_s=0.1)
        pipeline = _pipeline(ns, [gen, _consumer(ns, gen, name="S",
                                                 outs={})], tmp)
        plain = "TPP108" in _rules(ns.A.analyze_pipeline(pipeline))
        f108 = [f for f in ns.A.analyze_pipeline(pipeline, spmd_sync=True)
                if f.rule == "TPP108"]
        return plain, _key(f108), ["substrate" in f.fix for f in f108]

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"] == (
        False, [("TPP108", "Gen", "error")], [True])


def test_tpp108_pipeline_default_policy_flags_every_node(tmp_path):
    def run(ns, tmp):
        gen = _gen(ns)
        pipeline = _pipeline(
            ns, [gen, _consumer(ns, gen, name="S", outs={})], tmp,
            retry_policy={"max_attempts": 2, "base_delay_s": 0.1})
        return _key(f for f in ns.A.analyze_pipeline(pipeline,
                                                     spmd_sync=True)
                    if f.rule == "TPP108")

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"]
    assert {n for _, n, _ in got["port"]} == {"Gen", "S"}
    # The runtime mirror: both packages' spmd runners refuse the policy.
    from tpu_pipelines.orchestration import LocalDagRunner as RefRunner
    from tpu_pipelines_torch.orchestration import LocalDagRunner

    for ns, runner in ((PKGS["ref"], RefRunner(spmd_sync=True)),
                       (PKGS["port"], LocalDagRunner(device="cpu",
                                                     spmd_sync=True))):
        gen = _gen(ns)
        with pytest.raises(ValueError, match="spmd_sync is incompatible"):
            runner.run(_pipeline(
                ns, [gen, _consumer(ns, gen, name="S", outs={})],
                tmp_path / ns.root,
                retry_policy={"max_attempts": 2, "base_delay_s": 0.1}))


_CLI_PRELUDE = '''
import os
from {pkg}.dsl.component import Parameter, component
from {pkg}.dsl.pipeline import Pipeline


def _pipe(name, comps):
    home = os.environ.get("TPP_PIPELINE_HOME", "/tmp/x")
    return Pipeline(name, comps, pipeline_root=os.path.join(home, "root"),
                    metadata_path=os.path.join(home, "md.sqlite"))
'''


def _lint_json(ns, tmp, body, capsys, *flags):
    """``lint --pipeline-module M --json [flags]``: (exit code, rules)."""
    module = tmp / "fixture_pipeline.py"
    module.write_text(_CLI_PRELUDE.format(pkg=ns.root) + textwrap.dedent(body))
    code, out = _cli(ns, ["lint", "--pipeline-module", str(module), "--json",
                          *flags], capsys)
    return code, json.loads(out)["rules"]


def test_tpp108_cli_spmd_sync_flag(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TPP_PIPELINE_HOME", str(tmp_path))
    body = '''
        @component(outputs={"examples": "Examples"}, name="Gen")
        def Gen(ctx):
            pass

        def create_pipeline():
            return _pipe("spmd-fixture",
                         [Gen().with_retry_policy(max_attempts=3)])
    '''
    got = _both(lambda ns, tmp: (_lint_json(ns, tmp, body, capsys),
                                 _lint_json(ns, tmp, body, capsys,
                                            "--spmd-sync")), tmp_path)
    assert got["port"] == got["ref"]
    (clean, _), (gated, rules) = got["port"]
    assert (clean, gated) == (0, 3) and "TPP108" in rules


def _pusher_like(ns, model_src, name="Push", infra=None):
    inputs = {"model": "Model"}
    if infra is not None:
        inputs["infra_blessing"] = "InfraBlessing"

    @ns.component(inputs=inputs, optional_inputs=tuple(
        k for k in inputs if k != "model"
    ), outputs={"pushed_model": "PushedModel"}, name=name, is_sink=True)
    def Push(ctx):
        pass

    kwargs = {"model": model_src.outputs["model"]}
    if infra is not None:
        kwargs["infra_blessing"] = infra.outputs["blessing"]
    return Push(**kwargs)


def _train(ns, name="Train"):
    @ns.component(outputs={"model": "Model"}, name=name)
    def Train(ctx):
        pass

    return Train()


def test_tpp109_pusher_without_infra_validator(tmp_path):
    def run(ns, tmp):
        train = _train(ns)
        push = _pusher_like(ns, train)
        f109 = [f for f in _ir_findings(ns, [train, push], tmp)
                if f.rule == "TPP109"]
        push.with_lint_suppressions("TPP109")
        after = [f for f in _ir_findings(ns, [train, push], tmp)
                 if f.rule == "TPP109"]
        return (_key(f109), ["InfraValidator" in f.message
                             and "infra_blessing" in f.fix for f in f109],
                after)

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"] == (
        [("TPP109", "Push", "warn")], [True], [])


def test_tpp109_infra_blessing_wired_is_clean(tmp_path):
    def run(ns, tmp):
        train = _train(ns)

        @ns.component(inputs={"model": "Model"},
                      outputs={"blessing": "InfraBlessing"}, name="Infra",
                      is_sink=True)
        def Infra(ctx):
            pass

        infra = Infra(model=train.outputs["model"])
        push = _pusher_like(ns, train, infra=infra)
        return [f for f in _ir_findings(ns, [train, infra, push], tmp)
                if f.rule == "TPP109"]

    assert _both(run, tmp_path) == {"ref": [], "port": []}


def test_tpp109_cli_fail_on_warn(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TPP_PIPELINE_HOME", str(tmp_path))
    body = '''
        @component(outputs={"model": "Model"}, name="Train")
        def Train(ctx):
            pass

        @component(inputs={"model": "Model"},
                   outputs={"pushed_model": "PushedModel"},
                   name="Push", is_sink=True)
        def Push(ctx):
            pass

        def create_pipeline():
            train = Train()
            return _pipe("push-fixture",
                         [train, Push(model=train.outputs["model"])])
    '''
    got = _both(lambda ns, tmp: (_lint_json(ns, tmp, body, capsys),
                                 _lint_json(ns, tmp, body, capsys,
                                            "--fail-on", "warn")), tmp_path)
    assert got["port"] == got["ref"]
    (code, rules), (gated, rules2) = got["port"]
    assert (code, gated) == (0, 3) and "TPP109" in rules and "TPP109" in rules2


def test_tpp110_slo_without_monitor(tmp_path):
    def run(ns, tmp):
        gen = _gen(ns, serving={"slo_p99_ms": 250.0, "replicas": 2})
        sink = _consumer(ns, gen, name="S", outs={})
        sink.SPEC.outputs.clear()
        f110 = [f for f in _ir_findings(ns, [gen, sink], tmp)
                if f.rule == "TPP110"]
        gen.with_lint_suppressions("TPP110")
        after = [f for f in _ir_findings(ns, [gen, sink], tmp)
                 if f.rule == "TPP110"]
        return (_key(f110), [f.message for f in f110],
                ["TPP_SLO_MONITOR" in f.fix for f in f110], after)

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"]
    key, messages, fixes, after = got["port"]
    assert key == [("TPP110", "Gen", "warn")] and fixes == [True]
    assert "slo_p99_ms" in messages[0] and "serving" in messages[0]
    assert after == []


def test_tpp110_monitor_wired_is_clean(tmp_path):
    def run(ns, tmp):
        found = []
        for wired in ({"slo_p99_ms": 250.0, "slo_monitor_interval_s": 5.0},
                      {"slo_p99_ms": 250.0, "metrics_port": 9090},
                      {"slo_p99_s": 0.25, "registry": "default"},
                      {"replicas": 2, "slo_p99_ms": 0.0}):
            gen = _gen(ns, serving=wired)
            sink = _consumer(ns, gen, name="S", outs={})
            sink.SPEC.outputs.clear()
            found += [f for f in _ir_findings(ns, [gen, sink], tmp)
                      if f.rule == "TPP110"]
        return found

    assert _both(run, tmp_path) == {"ref": [], "port": []}


def test_tpp110_cli_fail_on_warn(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TPP_PIPELINE_HOME", str(tmp_path))
    body = '''
        @component(outputs={"examples": "Examples"},
                   parameters={"serving": Parameter(type=object,
                                                    default=None)},
                   name="Deploy", is_sink=True)
        def Deploy(ctx):
            pass

        def create_pipeline():
            return _pipe("slo-fixture", [Deploy(serving={"slo_p99_ms": 250.0})])
    '''
    got = _both(lambda ns, tmp: (_lint_json(ns, tmp, body, capsys,
                                            "--fail-on", "warn"),
                                 _lint_json(ns, tmp, body, capsys)), tmp_path)
    assert got["port"] == got["ref"]
    (gated, rules), (code, _) = got["port"]
    assert (gated, code) == (3, 0) and "TPP110" in rules


def test_tpp111_unbounded_continuous_nodes(tmp_path):
    def run(ns, tmp):
        out = []
        gen = _gen(ns)
        sink = _consumer(ns, gen, name="S", outs={})
        sink.SPEC.outputs.clear()
        pipeline = _pipeline(ns, [gen, sink], tmp)
        out.append(_rules(ns.A.analyze_pipeline(pipeline)))
        f111 = [f for f in ns.A.analyze_pipeline(pipeline, continuous=True)
                if f.rule == "TPP111"]
        out.append((_key(f111), "wedges" in f111[0].message,
                    "with_execution_timeout" in f111[0].fix))
        gen2 = _gen(ns).with_execution_timeout(60)
        sink2 = _consumer(ns, gen2, name="S", outs={})
        sink2.SPEC.outputs.clear()
        sink2.with_retry_policy(max_attempts=2, base_delay_s=0.1)
        out.append(_key(ns.A.analyze_pipeline(
            _pipeline(ns, [gen2, sink2], tmp), continuous=True)))
        for kw in ({"node_timeout_s": 120},
                   {"retry_policy": {"max_attempts": 2,
                                     "base_delay_s": 0.1}}):
            gen3 = _gen(ns)
            sink3 = _consumer(ns, gen3, name="S", outs={})
            sink3.SPEC.outputs.clear()
            out.append(_key(ns.A.analyze_pipeline(
                _pipeline(ns, [gen3, sink3], tmp, **kw), continuous=True)))
        gen4 = _gen(ns).with_lint_suppressions("TPP111")
        sink4 = _consumer(ns, gen4, name="S", outs={})
        sink4.SPEC.outputs.clear()
        sink4.with_lint_suppressions("TPP111")
        out.append(_key(ns.A.analyze_pipeline(
            _pipeline(ns, [gen4, sink4], tmp), continuous=True)))
        return out

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"]
    plain, (f111, wedges, fix), bounded, dl, rp, suppressed = got["port"]
    assert "TPP111" not in plain
    assert f111 == [("TPP111", "Gen", "warn"), ("TPP111", "S", "warn")]
    assert wedges and fix
    assert [f for f in bounded + dl + rp + suppressed if f[0] == "TPP111"] \
        == []


def test_tpp111_resolver_exempt(tmp_path):
    def run(ns, tmp):
        win = ns.RollingWindowResolver(window_spans=2)

        @ns.component(inputs={"examples": "Examples"}, outputs={},
                      name="S2", is_sink=True)
        def S2(ctx):
            pass

        return _key(f for f in ns.A.analyze_pipeline(
            _pipeline(ns, [win, S2(examples=win.outputs["examples"])], tmp),
            continuous=True) if f.rule == "TPP111")

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"] == [("TPP111", "S2", "warn")]


def test_tpp111_cli_continuous_flag(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TPP_PIPELINE_HOME", str(tmp_path))
    body = '''
        @component(outputs={"examples": "Examples"}, name="Gen",
                   is_sink=True)
        def Gen(ctx):
            pass

        def create_pipeline():
            return _pipe("cont-fixture", [Gen()])
    '''
    got = _both(lambda ns, tmp: (
        _lint_json(ns, tmp, body, capsys, "--fail-on", "warn"),
        _lint_json(ns, tmp, body, capsys, "--continuous", "--fail-on",
                   "warn")), tmp_path)
    assert got["port"] == got["ref"]
    (clean, _), (gated, rules) = got["port"]
    assert (clean, gated) == (0, 3) and "TPP111" in rules


# ----------------------------------------------- TPP2xx seeded-bug fixtures

# The same hazards in each package's idiom: a jitted step in the JAX
# package's source, its captured twin in the port's.
_JIT_STEP = {
    "ref": '''
            import jax

            @jax.jit
            def step(x):''',
    "port": '''
            import torch

            @torch.compile
            def step(x):''',
}

_CODE_FIXTURE = '''
    import threading

    _LOCK = threading.Lock()


    def shard_worker(task, lock=_LOCK):
        return task


    def clean_worker(task):
        return task


    def make_executor(cfg):
        def executor(ctx):
            from {pkg}.data.shard_plan import map_shards
{step}
                import time
                if x > 0:
                    y = x + time.time()
                return float(y.item())

            map_shards(lambda t: t, [1, 2])
            map_shards(shard_worker, [1, 2])
            map_shards(clean_worker, [1, 2])
            return {{"cfg": str(cfg)}}
        return executor


    class Cfg:
        pass


    EXEC = make_executor(Cfg())
'''


def _load_text(ns, tmp, name, text, fn):
    mod = tmp / f"{name}.py"
    mod.write_text(textwrap.dedent(text))
    return ns.load_fn(str(mod), fn)


def test_tpp2xx_seeded_fixture_trips_every_code_rule(tmp_path):
    def run(ns, tmp):
        fn = _load_text(ns, tmp, "seeded", _CODE_FIXTURE.format(
            pkg=ns.root, step=textwrap.indent(textwrap.dedent(
                _JIT_STEP[ns.name]), " " * 12)), "EXEC")
        findings = ns.A.check_callable(fn, "BadNode")
        by_rule = {}
        for f in findings:
            by_rule.setdefault(f.rule, []).append(f)
        assert all(f.node_id == "BadNode" and f.file.endswith("seeded.py")
                   and f.line > 0 for f in findings)
        msgs = " ".join(f.message for f in by_rule["TPP202"])
        return (_key(findings), "'cfg'" in by_rule["TPP201"][0].message,
                "lambda" in msgs and "shard_worker" in msgs
                and "clean_worker" not in msgs,
                "time.time" in by_rule["TPP204"][0].message,
                "['x']" in by_rule["TPP205"][0].message,
                sorted(f.line for f in findings))

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"]
    key = got["port"][0]
    assert sorted({r for r, _, _ in key}) == [
        "TPP201", "TPP202", "TPP203", "TPP204", "TPP205"]
    assert [r for r, _, _ in key].count("TPP202") == 2
    assert [r for r, _, _ in key].count("TPP203") == 2
    assert all(got["port"][1:5])


def test_tpp2xx_line_suppression(tmp_path):
    texts = {"ref": '''
        import jax


        @jax.jit
        def step(x):
            return x.sum().item()  # tpp: disable=TPP203
    ''', "port": '''
        import torch


        @torch.compile
        def step(x):
            return x.sum().item()  # tpp: disable=TPP203
    '''}
    got = _both(lambda ns, tmp: ns.A.check_callable(
        _load_text(ns, tmp, "suppressed", texts[ns.name], "step"), "N"),
        tmp_path)
    assert got == {"ref": [], "port": []}


# The port's own captured regions, each with the hazards of the JAX twin
# above (a jitted step): the same rule ids, region by region.
_CAPTURED = {
    "train_loop": '''
        import time


        def loss_fn(model, batch, generator):
            loss = model(batch).mean()
            if batch > 0:
                loss = loss + time.time()
            return loss, {"loss_value": loss.item()}


        def run_fn(fn_args):
            from tpu_pipelines_torch.trainer import train_loop

            return train_loop(loss_fn=loss_fn, init_params_fn=None,
                              optimizer=None, train_iter=[], config=None)
    ''',
    "graph_block": '''
        import time


        def run_fn(model, batch):
            import torch

            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                loss = model(batch).mean()
                if batch > 0:
                    loss = loss + time.time()
                total = loss.item()
            return total
    ''',
    "graphed_callables": '''
        import time


        def run_fn(model, batch):
            import torch

            def body(x):
                loss = model(x).mean()
                if x > 0:
                    loss = loss + time.time()
                return loss.item()

            return torch.cuda.make_graphed_callables(body, (batch,))
    ''',
    "compile_call": '''
        import time


        def run_fn(model, batch):
            import torch

            step = torch.compile(lambda x: x.cpu() + time.time())
            return step(batch)
    ''',
}
_CAPTURED_JAX_TWIN = '''
    import time


    def run_fn(model, batch):
        import jax

        @jax.jit
        def step(x):
            loss = model(x).mean()
            if x > 0:
                loss = loss + time.time()
            return loss.item()

        return step(batch)
'''


@pytest.mark.parametrize("region", sorted(_CAPTURED))
def test_a_captured_region_gets_the_rules_of_a_jitted_one(tmp_path, region):
    """Each of the port's captured regions (a ``train_loop`` loss_fn
    defined beside run_fn, a ``torch.cuda.graph`` block, a function handed
    to ``make_graphed_callables``, a ``torch.compile(lambda ...)``) with a
    host sync, an impure call and a branch on an argument gives the rule
    ids the JAX package gives the same hazards inside ``@jax.jit``, at
    the hazard's line; outside any region the same code is silent."""
    ref_fn = _load_text(PKGS["ref"], tmp_path, "jax_twin",
                        _CAPTURED_JAX_TWIN, "run_fn")
    want = _rules(PKGS["ref"].A.check_callable(ref_fn, "Trainer"))
    assert want == ["TPP203", "TPP204", "TPP205"]
    port = PKGS["port"]
    fn = _load_text(port, tmp_path, region, _CAPTURED[region], "run_fn")
    findings = port.A.check_callable(fn, "Trainer")
    lines = _CAPTURED[region].splitlines()
    if region == "compile_call":  # a lambda takes no statement: no branch
        want = ["TPP203", "TPP204"]
    assert _rules(findings) == want
    marks = {"TPP203": (".item()", ".cpu()"), "TPP204": ("time.time",),
             "TPP205": ("if ",)}
    for f in findings:
        assert f.file.endswith(f"{region}.py") and f.severity == (
            "error" if f.rule == "TPP203" else "warn")
        text = textwrap.dedent("\n".join(lines)).splitlines()[f.line - 1]
        assert any(m in text for m in marks[f.rule]), (f, text)
    # The same body, captured by nothing, is silent.
    plain = _load_text(port, tmp_path, "uncaptured", '''
        import time


        def run_fn(model, batch):
            loss = model(batch).mean()
            if batch > 0:
                loss = loss + time.time()
            return loss.item()
    ''', "run_fn")
    assert port.A.check_callable(plain, "Trainer") == []


def test_the_bert_module_lints_clean_and_an_item_in_its_loss_fn_is_an_error(
        tmp_path):
    """The BERT twin's own module: its run_fn hands ``loss_fn`` to
    ``train_loop``; clean as shipped; with ``.item()`` added inside
    ``loss_fn``, TPP203 at ERROR on that line (the card's capture would
    fail on it), through the Trainer's module entry point."""
    port = PKGS["port"]
    path = os.path.join(REPO, "tpu_pipelines_torch", "examples",
                        "bert_module.py")
    assert port.A.check_callable(port.load_fn(path, "run_fn"), "T") == []
    source = open(path).read()
    hazard = "    loss = F.cross_entropy(logits.float(), labels)\n"
    assert source.count(hazard) == 1
    copy = tmp_path / "bert_module_item.py"
    copy.write_text(source.replace(
        hazard, hazard + "    print(loss.item())\n"))
    findings = port.A.check_callable(port.load_fn(str(copy), "run_fn"), "T")
    line = source.splitlines().index(hazard.rstrip("\n")) + 2
    assert [(f.rule, f.severity, f.line, f.file) for f in findings] == [
        ("TPP203", "error", line, str(copy))]


def test_tpp206_unloadable_module_entry(tmp_path):
    def run(ns, tmp):
        @ns.component(outputs={"examples": "Examples"},
                      parameters={"module_file": ns.Parameter(
                          type=str, required=True)},
                      name="ModGen", lint_module_fns=("run_fn",),
                      is_sink=True)
        def ModGen(ctx):
            pass

        missing = ModGen(module_file=str(tmp / "nope.py"))
        f206 = [f for f in ns.A.analyze_pipeline(_pipeline(ns, [missing],
                                                           tmp))
                if f.rule == "TPP206"]
        empty = tmp / "empty_mod.py"
        empty.write_text("x = 1\n")
        f206b = [f for f in ns.A.analyze_pipeline(_pipeline(
            ns, [ModGen(module_file=str(empty))], tmp)) if f.rule == "TPP206"]
        return _key(f206), _key(f206b), ["run_fn" in f.message for f in f206b]

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"] == (
        [("TPP206", "ModGen", "error")], [("TPP206", "ModGen", "error")],
        [True])


_WINDOWED = {
    "ref": '''
        def windowed_per_step(batches):
            import jax
            from tpu_pipelines.trainer import TrainLoopConfig

            cfg = TrainLoopConfig(train_steps=8, window_steps=8)
            for b in batches:
                db = jax.device_put(b)
                jax.block_until_ready(db)
            return cfg


        def per_step_loop(batches):
            import jax
            from tpu_pipelines.trainer import TrainLoopConfig

            cfg = TrainLoopConfig(train_steps=8, window_steps=1)
            for b in batches:
                jax.device_put(b)
            return cfg


        def windowed_clean(batches):
            import jax
            from tpu_pipelines.trainer import TrainLoopConfig

            cfg = TrainLoopConfig(train_steps=8, window_steps=8)
            staged = jax.device_put(batches)
            return cfg, staged
    ''',
    "port": '''
        def windowed_per_step(batches, device):
            import torch
            from tpu_pipelines_torch.trainer import TrainLoopConfig

            cfg = TrainLoopConfig(train_steps=8, window_steps=8)
            for b in batches:
                db = b.to(device)
                torch.cuda.synchronize()
            return cfg


        def per_step_loop(batches, device):
            from tpu_pipelines_torch.trainer import TrainLoopConfig

            cfg = TrainLoopConfig(train_steps=8, window_steps=1)
            for b in batches:
                b.to(device)
            return cfg


        def windowed_clean(batches):
            import torch
            from tpu_pipelines_torch.trainer import TrainLoopConfig

            cfg = TrainLoopConfig(train_steps=8, window_steps=8)
            staged = torch.stack(batches).to("cuda")
            for b in batches:
                b.to(torch.bfloat16)
            return cfg, staged
    ''',
}


def test_tpp207_window_host_traffic(tmp_path):
    """Per-step host traffic inside a loop body fires only beside
    ``window_steps > 1``: ``device_put`` / ``block_until_ready`` in the
    JAX package, ``.to(device)`` / ``torch.cuda.synchronize`` in the port
    (a dtype ``.to`` is not traffic); a staged window and a per-step
    config stay silent."""
    def run(ns, tmp):
        out = []
        for fn in ("windowed_per_step", "per_step_loop", "windowed_clean"):
            findings = ns.A.check_callable(_load_text(
                ns, tmp, "windowed", _WINDOWED[ns.name], fn), "Trainer")
            out.append(_key(findings))
            if findings:
                assert all("window_steps" in f.message for f in findings)
        return out

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"]
    assert got["port"] == [[("TPP207", "Trainer", "warn")] * 2, [], []]


def test_tpp208_flash_below_committed_crossover(tmp_path):
    """Each package against its own committed table: ``attn_impl="flash"``
    with a static seq below the table's floor fires WARN; "auto", dynamic
    shapes and seqs at the floor stay silent.  The port's table is the
    H100's (flash from 64 keys up, measured by chip_smoke.py)."""
    def run(ns, tmp):
        crossovers = ns.autotune.committed_crossovers()
        assert crossovers
        floor = min(crossovers.values())
        below = floor // 2
        text = f'''
            def hp_dict_flash():
                return {{"max_len": {below}, "attn_impl": "flash", "d_model": 32}}


            def kwargs_flash():
                from {ns.root}.models.transformer import MultiHeadAttention

                return MultiHeadAttention(
                    n_heads=4, head_dim=8, attn_impl="flash", seq_len={below},
                )


            def auto_is_fine():
                return {{"max_len": {below}, "attn_impl": "auto"}}


            def dynamic_shape_is_silent(max_len):
                return {{"max_len": max_len, "attn_impl": "flash"}}


            def above_crossover_is_fine():
                return {{"max_len": {floor}, "attn_impl": "flash"}}
        '''
        out = []
        for fn in ("hp_dict_flash", "kwargs_flash", "auto_is_fine",
                   "dynamic_shape_is_silent", "above_crossover_is_fine"):
            f208 = [f for f in ns.A.check_callable(_load_text(
                ns, tmp, "flashy", text, fn), "Trainer") if f.rule == "TPP208"]
            out.append(_key(f208))
            for f in f208:
                assert str(floor) in f.message
                assert 'attn_impl="auto"' in f.fix
        return out

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"]
    assert got["port"] == [[("TPP208", "Trainer", "warn")]] * 2 + [[]] * 3
    assert PKGS["port"].autotune.committed_crossovers() == {
        "NVIDIA H100 80GB HBM3": 64}


def _code_case(tmp_path, name, text, fns, rule, node, fix_word=None):
    """``text``'s functions through both packages' code rules: the
    findings of ``rule`` per function, equal across packages."""
    def run(ns, tmp):
        out = []
        for fn in fns:
            found = [f for f in ns.A.check_callable(_load_text(
                ns, tmp, name, text.replace("{pkg}", ns.root), fn), node)
                if f.rule == rule]
            if fix_word:
                assert all(fix_word in f.fix for f in found)
            out.append(_key(found))
        return out

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"]
    return got["port"]


def test_tpp209_whole_request_decode(tmp_path):
    got = _code_case(tmp_path, "servey", '''
        def dict_predict_decode():
            return {"model_type": "predict", "max_decode_len": 32,
                    "replicas": 2}


        def call_predict_beam():
            from {pkg}.serving import ModelServer

            return ModelServer("t5", "/m", model_type="predict",
                               beam_size=4)


        def generative_is_fine():
            return {"model_type": "generative", "max_decode_len": 32}


        def no_model_type_is_silent():
            return {"max_decode_len": 32, "beam_size": 4}


        def predict_without_decode_is_fine():
            return {"model_type": "predict", "replicas": 2}
    ''', ("dict_predict_decode", "call_predict_beam", "generative_is_fine",
          "no_model_type_is_silent", "predict_without_decode_is_fine"),
        "TPP209", "Server", 'model_type="generative"')
    assert got == [[("TPP209", "Server", "warn")]] * 2 + [[]] * 3


def test_tpp212_unsupervised_fleet(tmp_path):
    got = _code_case(tmp_path, "fleety", '''
        def bare_fleet():
            return {"replicas": 2, "model_type": "predict"}


        def call_bare_fleet():
            from {pkg}.serving import ModelServer

            return ModelServer("m", "/m", replicas=4)


        def fleet_with_slo():
            return {"replicas": 2, "slo_p99_ms": 50}


        def fleet_with_supervisor():
            from {pkg}.serving import ModelServer

            return ModelServer("m", "/m", replicas=2,
                               supervisor_interval_s=0.25)


        def single_replica():
            return {"replicas": 1}


        def dynamic_replicas(n):
            return {"replicas": n}


        def suppressed_fleet():
            return {"replicas": 2}  # tpp: disable=TPP212
    ''', ("bare_fleet", "call_bare_fleet", "fleet_with_slo",
          "fleet_with_supervisor", "single_replica", "dynamic_replicas",
          "suppressed_fleet"), "TPP212", "Server", "supervisor_interval_s")
    assert got == [[("TPP212", "Server", "warn")]] * 2 + [[]] * 5


def test_tpp215_unwatched_deploy(tmp_path):
    got = _code_case(tmp_path, "deploys", '''
        def bare_deploy():
            return {"push_destination": "/srv/m",
                    "serving_push_url": "http://s:8501/v1/models/m"}


        def call_bare_deploy():
            cfg = dict(serving_push_url="http://s:8501/v1/models/m")
            return cfg


        def deploy_with_validator_watch():
            return {"serving_push_url": "http://s:8501/v1/models/m",
                    "skew_linf_threshold": 0.3}


        def deploy_with_live_monitor():
            from {pkg}.serving import ModelServer

            ModelServer("m", "/m", monitor_sample_rate=0.1)
            return {"serving_push_url": "http://s:8501/v1/models/m"}


        def empty_url_is_silent():
            return {"serving_push_url": ""}


        def dynamic_url_is_silent(url):
            return {"serving_push_url": url}


        def suppressed_deploy():
            return {"serving_push_url": "http://s:8501/v1/models/m"}  # tpp: disable=TPP215
    ''', ("bare_deploy", "call_bare_deploy", "deploy_with_validator_watch",
          "deploy_with_live_monitor", "empty_url_is_silent",
          "dynamic_url_is_silent", "suppressed_deploy"), "TPP215", "Pusher",
        "monitor_sample_rate")
    assert got == [[("TPP215", "Pusher", "warn")]] * 2 + [[]] * 5


def test_tpp213_pinned_dp_mode_with_partition(tmp_path):
    """Held as the reference holds it, on source that sets
    ``param_partition`` and ``dp_collective``: since ROADMAP.md A5 the
    port's train loop runs both, and refuses the pair the rule flags (a
    partition beside psum_bucketed or ordered, ``DataParallel.build``)."""
    got = _code_case(tmp_path, "sharded", '''
        def pinned_psum(fn_args):
            from {pkg}.trainer import TrainLoopConfig

            return TrainLoopConfig(
                train_steps=4, dp_collective="psum_bucketed",
                param_partition=fn_args.specs,
            )


        def pinned_ordered_rules_elsewhere(fn_args):
            from {pkg}.trainer import TrainLoopConfig

            rules = fn_args.model.partition_rules
            return TrainLoopConfig(
                train_steps=4, dp_collective="ordered",
            ), rules


        def fsdp_is_fine(fn_args):
            from {pkg}.trainer import TrainLoopConfig

            return TrainLoopConfig(
                train_steps=4, dp_collective="fsdp",
                param_partition=fn_args.specs,
            )


        def auto_is_fine(fn_args):
            from {pkg}.trainer import TrainLoopConfig

            return TrainLoopConfig(
                train_steps=4, dp_collective="auto",
                param_partition=fn_args.specs,
            )


        def implicit_none_is_fine(fn_args):
            from {pkg}.trainer import TrainLoopConfig

            return TrainLoopConfig(
                train_steps=4, param_partition=fn_args.specs,
            )


        def dynamic_mode_is_fine(fn_args):
            from {pkg}.trainer import TrainLoopConfig

            return TrainLoopConfig(
                train_steps=4, dp_collective=fn_args.mode,
                param_partition=fn_args.specs,
            )


        def no_partition_is_fine(fn_args):
            from {pkg}.trainer import TrainLoopConfig

            return TrainLoopConfig(
                train_steps=4, dp_collective="psum_bucketed",
            )


        def suppressed(fn_args):
            from {pkg}.trainer import TrainLoopConfig

            return TrainLoopConfig(
                train_steps=4,
                dp_collective="ordered",  # tpp: disable=TPP213
                param_partition=fn_args.specs,
            )
    ''', ("pinned_psum", "pinned_ordered_rules_elsewhere", "fsdp_is_fine",
          "auto_is_fine", "implicit_none_is_fine", "dynamic_mode_is_fine",
          "no_partition_is_fine", "suppressed"), "TPP213", "Trainer", "fsdp")
    assert got == [[("TPP213", "Trainer", "warn")]] * 2 + [[]] * 6


def test_tpp210_mesh_without_per_host_input(tmp_path):
    """Held as the reference holds it, on source that configures a mesh:
    since ROADMAP.md A5 the port's modules train on one, each rank
    reading its shard through ``per_host_input_config``."""
    got = _code_case(tmp_path, "meshy", '''
        def mesh_and_full_iteration(fn_args):
            from {pkg}.data.input_pipeline import InputConfig
            from {pkg}.parallel.mesh import MeshConfig, make_mesh

            mesh = make_mesh(MeshConfig(data=8))
            return mesh, InputConfig(batch_size=64)


        def mesh_config_kwarg_counts(fn_args):
            from {pkg}.data.input_pipeline import InputConfig
            from {pkg}.trainer import TrainLoopConfig

            cfg = TrainLoopConfig(train_steps=4, mesh_config=fn_args.mc)
            return cfg, InputConfig(batch_size=64)


        def explicit_shard_kwargs_are_fine(fn_args):
            from {pkg}.data.input_pipeline import InputConfig
            from {pkg}.parallel.mesh import MeshConfig, make_mesh

            mesh = make_mesh(MeshConfig(data=8))
            return mesh, InputConfig(
                batch_size=64, shard_index=0, num_shards=2
            )


        def per_host_helper_is_fine(fn_args):
            from {pkg}.data.input_pipeline import (
                InputConfig, per_host_input_config,
            )
            from {pkg}.parallel.mesh import MeshConfig, make_mesh

            mesh = make_mesh(MeshConfig(data=8))
            return mesh, per_host_input_config(InputConfig(batch_size=64))


        def no_mesh_is_silent(fn_args):
            from {pkg}.data.input_pipeline import InputConfig

            return InputConfig(batch_size=64)


        def none_mesh_config_is_silent(fn_args):
            from {pkg}.data.input_pipeline import InputConfig
            from {pkg}.trainer import TrainLoopConfig

            cfg = TrainLoopConfig(train_steps=4, mesh_config=None)
            return cfg, InputConfig(batch_size=64)
    ''', ("mesh_and_full_iteration", "mesh_config_kwarg_counts",
          "explicit_shard_kwargs_are_fine", "per_host_helper_is_fine",
          "no_mesh_is_silent", "none_mesh_config_is_silent"), "TPP210",
        "Trainer", "per_host_input_config")
    assert got == [[("TPP210", "Trainer", "warn")]] * 2 + [[]] * 4


def test_tpp210_example_trainer_modules_are_clean():
    """The port's example modules' run_fns carry no TPP210 (nor any other
    code finding)."""
    port = PKGS["port"]
    for name in ("taxi", "bert", "t5"):
        path = os.path.join(REPO, "tpu_pipelines_torch", "examples",
                            f"{name}_module.py")
        assert port.A.check_callable(port.load_fn(path, "run_fn"),
                                     "Trainer") == [], path


def test_tpp211_undocumented_serving_metric(tmp_path):
    def run(ns, tmp):
        serving = tmp / "serving"
        (serving / "fleet").mkdir(parents=True)
        (serving / "engine.py").write_text(textwrap.dedent('''
            DOCUMENTED = "serving_decode_steps_total"
            UNDOCUMENTED = "serving_decode_mystery_total"
            SUPPRESSED = "serving_decode_hidden_total"  # tpp: disable=TPP211
            NOT_A_METRIC = "serving_decode_"
            PROSE = "the serving_decode_ prefix is reserved"
        '''))
        (serving / "fleet" / "replica.py").write_text(
            'ALSO_MISSING = "serving_decode_orphan_ratio"\n')
        doc = tmp / "SERVING.md"
        doc.write_text("| `serving_decode_steps_total` | counter | steps |\n")
        check = lambda: ns.A.check_serving_metric_docs(  # noqa: E731
            serving_dir=str(serving), doc_path=str(doc))
        first = check()
        got = (sorted((os.path.basename(f.file), f.rule, f.severity,
                       f.line) for f in first),
               sorted(f.message.split("'")[1] for f in first),
               all("SERVING.md" in f.fix for f in first))
        doc.write_text("serving_decode_steps_total "
                       "serving_decode_mystery_total "
                       "serving_decode_orphan_ratio\n")
        cleared = check()
        doc.unlink()
        return got, cleared, len(check())

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"]
    (files, names, fix), cleared, missing = got["port"]
    assert [f[:3] for f in files] == [("engine.py", "TPP211", "warn"),
                                      ("replica.py", "TPP211", "warn")]
    assert names == ["serving_decode_mystery_total",
                     "serving_decode_orphan_ratio"]
    assert fix and cleared == [] and missing == 3


def test_tpp211_dedupes_within_file_and_gates_like_any_warn(tmp_path):
    def run(ns, tmp):
        serving = tmp / "serving"
        serving.mkdir()
        (serving / "metrics.py").write_text(textwrap.dedent('''
            A = "serving_decode_repeat_total"
            B = "serving_decode_repeat_total"
            def emit(reg):
                return reg.counter("serving_decode_repeat_total")
        '''))
        doc = tmp / "SERVING.md"
        doc.write_text("nothing documented here\n")
        findings = ns.A.check_serving_metric_docs(
            serving_dir=str(serving), doc_path=str(doc))
        return (len(findings), ns.A.gated(findings, "warn") == findings,
                ns.A.gated(findings, "error"))

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"] == (1, True, [])


def test_tpp211_repo_serving_metrics_are_documented():
    """Every serving_decode_* series the port's serving/ emits is in
    docs/SERVING.md or the port's METRICS.md, as the reference's is."""
    assert PKGS["ref"].A.check_serving_metric_docs() == []
    assert PKGS["port"].A.check_serving_metric_docs() == []


def test_tpp214_undocumented_metric_names(tmp_path):
    def run(ns, tmp):
        pkg = tmp / "pkg"
        (pkg / "data").mkdir(parents=True)
        (pkg / "trainer.py").write_text(textwrap.dedent('''
            IN_OBS_DOC = "train_window_time_seconds"
            IN_SERVING_DOC = "serving_decode_steps_total"
            UNDOCUMENTED = "train_mystery_total"
            SUPPRESSED = "train_hidden_bytes"  # tpp: disable=TPP214
            NOT_A_METRIC = "total"
            ALSO_NOT = "finished in 3 seconds"
        '''))
        (pkg / "data" / "plane.py").write_text(
            'ALSO_MISSING = "shards_orphaned_seconds"\n')
        obs, serving = tmp / "OBSERVABILITY.md", tmp / "SERVING.md"
        obs.write_text("| `train_window_time_seconds` | counter |\n")
        serving.write_text("| `serving_decode_steps_total` | counter |\n")
        docs = [str(obs), str(serving)]
        check = lambda: ns.A.check_metric_docs(  # noqa: E731
            package_dir=str(pkg), doc_paths=docs)
        first = check()
        got = (sorted((os.path.basename(f.file), f.rule, f.severity, f.line)
                      for f in first),
               sorted(f.message.split("'")[1] for f in first),
               all("OBSERVABILITY.md" in f.fix for f in first),
               # The finding says the name is in no catalog ("neither ...
               # nor" in the reference, "none of" in the port).
               all(re.search(r"but listed in (neither|none of) ", f.message)
                   for f in first))
        obs.write_text("train_window_time_seconds train_mystery_total\n")
        serving.write_text("serving_decode_steps_total "
                           "shards_orphaned_seconds\n")
        cleared = check()
        obs.unlink()
        serving.unlink()
        return got, cleared, len(check())

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"]
    (files, names, fix, negated), cleared, missing = got["port"]
    assert [f[:3] for f in files] == [("plane.py", "TPP214", "warn"),
                                      ("trainer.py", "TPP214", "warn")]
    assert names == ["shards_orphaned_seconds", "train_mystery_total"]
    assert fix and negated and cleared == [] and missing == 4


def test_tpp214_dedupes_within_file_and_gates_like_any_warn(tmp_path):
    def run(ns, tmp):
        pkg = tmp / "pkg"
        pkg.mkdir()
        (pkg / "metrics.py").write_text(textwrap.dedent('''
            A = "repeat_latency_seconds"
            B = "repeat_latency_seconds"
            def emit(reg):
                return reg.histogram("repeat_latency_seconds")
        '''))
        doc = tmp / "OBSERVABILITY.md"
        doc.write_text("nothing documented here\n")
        findings = ns.A.check_metric_docs(package_dir=str(pkg),
                                          doc_paths=[str(doc)])
        return (len(findings), ns.A.gated(findings, "warn") == findings,
                ns.A.gated(findings, "error"))

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"] == (1, True, [])


def test_tpp214_repo_metrics_are_documented():
    """Every metric-shaped name the port emits is in docs/ or in the port's
    own METRICS.md (no family hidden by a suppression: the port's
    suppressions mark only payload keys, parameters and dict keys, as the
    reference's do)."""
    assert PKGS["ref"].A.check_metric_docs() == []
    assert PKGS["port"].A.check_metric_docs() == []
    from tpu_pipelines_torch.analysis.code_rules import PORT_CATALOG

    assert os.path.isfile(PORT_CATALOG)
    suppressed = [
        line for line in subprocess.run(
            ["grep", "-rn", "tpp: disable=TPP214",
             os.path.join(REPO, "tpu_pipelines_torch"), "--include=*.py"],
            capture_output=True, text=True).stdout.splitlines()
        if "/analysis/" not in line]  # the rule's own text
    assert suppressed and all(
        any(why in line for why in ("(payload key)", "(parameter)",
                                    "(dict key)", "(attr name)"))
        for line in suppressed), suppressed


# ------------------------------------------------------------------- gates


def _bad_pipeline(ns, tmp):
    """One ERROR (TPP104) + one WARN (TPP101)."""
    gen = _gen(ns, knob=Opaque())
    return _pipeline(ns, [gen, _consumer(ns, gen, name="DeadEnd")], tmp)


def test_runner_gate_refuses_before_store_exists(tmp_path):
    def run(ns, tmp):
        p = _bad_pipeline(ns, tmp)
        with pytest.raises(ns.A.LintGateError) as ei:
            ns.runner().run(p, lint="error")
        return ("TPP104" in str(ei.value), os.path.exists(p.metadata_path),
                os.path.exists(p.pipeline_root), _key(ei.value.findings))

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"] == (
        True, False, False, [("TPP104", "Gen", "error")])


def test_runner_gate_warn_level_and_off(tmp_path):
    def run(ns, tmp):
        gen = _gen(ns)
        p = _pipeline(ns, [gen, _consumer(ns, gen, name="DeadEnd",
                                          outs={"schema": "Schema"})], tmp)
        with pytest.raises(ns.A.LintGateError) as ei:
            ns.runner().run(p, lint="warn")
        result = ns.runner().run(p, lint="error")
        return "TPP101" in str(ei.value), result.succeeded

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"] == (True, True)


def test_runner_gate_env_var(tmp_path, monkeypatch):
    monkeypatch.setenv("TPP_LINT", "error")

    def run(ns, tmp):
        with pytest.raises(ns.A.LintGateError):
            ns.runner().run(_bad_pipeline(ns, tmp))
        return ns.runner().run(_bad_pipeline(ns, tmp), lint="off").succeeded

    assert _both(run, tmp_path) == {"ref": True, "port": True}


def test_cluster_runner_refuses_before_emitting(tmp_path, monkeypatch):
    """The reference's cluster runner refuses to emit manifests for a
    pipeline with an ERROR; the port's refuses it with the same findings,
    as does the continuous controller's gate, before its store exists."""
    from tpu_pipelines.orchestration import TPUJobRunner, TPUJobRunnerConfig
    from tpu_pipelines_torch.continuous import (
        ContinuousConfig,
        ContinuousController,
    )

    out_dir = tmp_path / "specs"
    cfg = TPUJobRunnerConfig(image="img", pipeline_module="/app/p.py",
                             output_dir=str(out_dir))
    ref_ns, port = PKGS["ref"], PKGS["port"]
    with pytest.raises(ref_ns.A.LintGateError) as ref_err:
        TPUJobRunner(cfg).run(_bad_pipeline(ref_ns, tmp_path / "ref"))
    assert "cluster compile" in str(ref_err.value) and not out_dir.exists()
    pipeline = _bad_pipeline(port, tmp_path / "port")
    controller = ContinuousController(ContinuousConfig(
        input_pattern=str(tmp_path / "span-{SPAN}"),
        make_span_pipeline=lambda s, v: pipeline,
        make_window_pipeline=lambda: pipeline, lint="error", device="cpu"))
    with pytest.raises(port.A.LintGateError) as port_err:
        controller._lint_once(pipeline)
    assert _key(port_err.value.findings) == _key(ref_err.value.findings)
    assert not os.path.exists(pipeline.metadata_path)
    from tpu_pipelines_torch.orchestration import (
        GPUJobRunner,
        GPUJobRunnerConfig,
    )

    port_out = tmp_path / "port_specs"
    with pytest.raises(port.A.LintGateError) as gpu_err:
        GPUJobRunner(GPUJobRunnerConfig(
            image="img", pipeline_module="/app/p.py",
            output_dir=str(port_out))).run(pipeline)
    assert "cluster compile" in str(gpu_err.value) and not port_out.exists()
    assert _key(gpu_err.value.findings) == _key(ref_err.value.findings)


_BAD_MODULE = '''
from {pkg}.dsl.component import Parameter, component
from {pkg}.dsl.pipeline import Pipeline


@component(outputs={{"examples": "Examples"}},
           parameters={{"p": Parameter(type=object, default=None)}})
def Gen(ctx):
    pass


class Obj:
    pass


def create_pipeline():
    return Pipeline("bad", [Gen(p=Obj())], pipeline_root={root!r},
                    metadata_path={md!r})
'''


def test_cli_lint_exit_codes_and_json(tmp_path, capsys):
    def run(ns, tmp):
        bad = tmp / "bad_pipeline.py"
        bad.write_text(_BAD_MODULE.format(pkg=ns.root, root=str(tmp / "root"),
                                          md=str(tmp / "md.sqlite")))
        code, out = _cli(ns, ["lint", "--pipeline-module", str(bad),
                              "--json"], capsys)
        doc = json.loads(out)
        broken = tmp / "broken.py"
        broken.write_text("raise RuntimeError('boom')\n")
        broken_code, _ = _cli(ns, ["lint", "--pipeline-module", str(broken)],
                              capsys)
        return (code, doc["errors"], doc["gated"], doc["rules"],
                {f["rule"]: f["node_id"] for f in doc["findings"]},
                broken_code)

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"]
    code, errors, gated, rules, nodes, broken = got["port"]
    assert (code, errors, gated, broken) == (3, 1, 1, 1)
    assert "TPP104" in rules and nodes["TPP104"] == "Gen"


def test_cli_lint_clean_on_taxi_example(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TPP_PIPELINE_HOME", str(tmp_path / "home"))
    got = _both(lambda ns, tmp: _cli(ns, [
        "lint", "--pipeline-module", ns.examples["taxi"]], capsys), tmp_path)
    assert got["port"] == got["ref"] == (0, "lint: clean (0 findings)\n")


def test_cli_lint_gates_on_tpp214(tmp_path, monkeypatch, capsys):
    """A TPP214 finding rides the gate like a graph WARN: exit 3 at
    --fail-on warn, reported with its file:line (injected at the analysis
    seam the CLI imports: the real tree lints TPP214-clean)."""
    monkeypatch.setenv("TPP_PIPELINE_HOME", str(tmp_path / "home"))

    def run(ns, tmp):
        ghost = ns.A.Finding(
            rule="TPP214", severity="warn", node_id="<repo>",
            message="metric-shaped name 'ghost_total' is undocumented",
            file=f"{ns.root}/ghost.py", line=7,
            fix="add 'ghost_total' to the catalog")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ns.A, "check_metric_docs", lambda: [ghost])
            code, out = _cli(ns, ["lint", "--pipeline-module",
                                  ns.examples["taxi"], "--fail-on", "warn",
                                  "--json"], capsys)
        doc = json.loads(out)
        by_rule = {f["rule"]: f for f in doc["findings"]}
        return code, doc["gated"], by_rule["TPP214"]["line"]

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"] == (3, 1, 7)


def test_cli_run_lint_flag(tmp_path, capsys):
    def run(ns, tmp):
        bad = tmp / "badp.py"
        bad.write_text(_BAD_MODULE.format(pkg=ns.root, root=str(tmp / "root"),
                                          md=str(tmp / "md.sqlite")))
        code, _ = _cli(ns, ["run", "--pipeline-module", str(bad), "--lint",
                            "error"], capsys)
        return code, os.path.exists(tmp / "md.sqlite")

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"] == (3, False)


# Acceptance sweep: one seeded-bug pipeline module per rule id, refused by
# the CLI (exit 3) with the rule in --json, in both packages; the port's
# jit hazards are their captured twins.

_PRELUDE = '''
from {pkg}.dsl.component import Parameter, RuntimeParameter, component
from {pkg}.dsl.pipeline import Pipeline


def _pipe(comps):
    return Pipeline("seeded", comps, pipeline_root="{root}")


@component(outputs={{"examples": "Examples"}}, name="Gen")
def Gen(ctx):
    pass


@component(inputs={{"examples": "Examples"}}, outputs={{}}, name="Sink",
           is_sink=True)
def Sink(ctx):
    pass
'''

_TAIL = '''

def create_pipeline():
    gen = {name}()
    return _pipe([gen, Sink(examples=gen.outputs["examples"])])
'''

_SEEDED_MODULES = {
    "TPP101": '''
@component(inputs={{"examples": "Examples"}},
           outputs={{"statistics": "ExampleStatistics"}}, name="Dead")
def Dead(ctx):
    pass


def create_pipeline():
    gen = Gen()
    return _pipe([gen, Dead(examples=gen.outputs["examples"])])
''',
    "TPP102": '''
def create_pipeline():
    gen = Gen().with_execution_timeout(0.25)
    return _pipe([gen, Sink(examples=gen.outputs["examples"])])
''',
    "TPP103": '''
@component(inputs={{"examples": "Examples"}}, outputs={{}}, name="TpuA",
           resource_class="tpu", is_sink=True)
def TpuA(ctx):
    pass


@component(inputs={{"examples": "Examples"}}, outputs={{}}, name="TpuB",
           resource_class="tpu", is_sink=True)
def TpuB(ctx):
    pass


def create_pipeline():
    gen = Gen()
    return _pipe([gen, TpuA(examples=gen.outputs["examples"]),
                  TpuB(examples=gen.outputs["examples"])])
''',
    "TPP104": '''
class Opaque:
    pass


@component(outputs={{"examples": "Examples"}},
           parameters={{"p": Parameter(type=object, default=None)}},
           name="BadGen")
def BadGen(ctx):
    pass


def create_pipeline():
    gen = BadGen(p=Opaque())
    return _pipe([gen, Sink(examples=gen.outputs["examples"])])
''',
    "TPP105": '''
@component(outputs={{"examples": "Examples"}},
           parameters={{"path": Parameter(type=str, default="")}},
           name="ParamGen")
def ParamGen(ctx):
    pass


def create_pipeline():
    gen = ParamGen(path=RuntimeParameter("data_path"))
    return _pipe([gen, Sink(examples=gen.outputs["examples"])])
''',
    "TPP201": '''
class Opaque:
    pass


def _make(cfg):
    def executor(ctx):
        return {{"cfg": str(cfg)}}
    return executor


StaleGen = component(outputs={{"examples": "Examples"}},
                     name="StaleGen")(_make(Opaque()))
''' + _TAIL.replace("{name}", "StaleGen"),
    "TPP202": '''
@component(outputs={{"examples": "Examples"}}, name="ForkGen")
def ForkGen(ctx):
    from {pkg}.data.shard_plan import map_shards
    map_shards(lambda t: t, [1, 2])
''' + _TAIL.replace("{name}", "ForkGen"),
    "TPP206": '''
@component(outputs={{"examples": "Examples"}},
           parameters={{"module_file": Parameter(type=str, required=True)}},
           name="ModGen", lint_module_fns=("run_fn",))
def ModGen(ctx):
    pass


def create_pipeline():
    gen = ModGen(module_file="{root}/does_not_exist.py")
    return _pipe([gen, Sink(examples=gen.outputs["examples"])])
''',
    "TPP209": '''
@component(outputs={{"examples": "Examples"}}, name="ServeGen")
def ServeGen(ctx):
    serving = {{"model_type": "predict", "max_decode_len": 32,
                "replicas": 2}}
    return serving
''' + _TAIL.replace("{name}", "ServeGen"),
    "TPP212": '''
@component(outputs={{"examples": "Examples"}}, name="FleetGen")
def FleetGen(ctx):
    serving = {{"replicas": 2, "model_type": "predict"}}
    return serving
''' + _TAIL.replace("{name}", "FleetGen"),
    "TPP210": '''
@component(outputs={{"examples": "Examples"}}, name="MeshGen")
def MeshGen(ctx):
    from {pkg}.data.input_pipeline import InputConfig
    from {pkg}.parallel.mesh import MeshConfig, make_mesh

    mesh = make_mesh(MeshConfig(data=8))
    return mesh, InputConfig(batch_size=64)
''' + _TAIL.replace("{name}", "MeshGen"),
    "TPP213": '''
@component(outputs={{"examples": "Examples"}}, name="ShardGen")
def ShardGen(ctx):
    cfg = {{"train_steps": 4, "dp_collective": "psum_bucketed",
            "param_partition": ctx.specs}}
    return cfg
''' + _TAIL.replace("{name}", "ShardGen"),
    "TPP215": '''
@component(outputs={{"examples": "Examples"}}, name="DeployGen")
def DeployGen(ctx):
    cfg = {{"push_destination": "/srv/models",
            "serving_push_url": "http://127.0.0.1:8501/v1/models/taxi"}}
    return cfg
''' + _TAIL.replace("{name}", "DeployGen"),
}
# The hazards each package spells in its own idiom: (JAX, torch twin).
_TWINS = {
    "TPP203": ('''
    import jax

    @jax.jit
    def step(x):
        return x.sum().item()
    return step''', '''
    import torch

    @torch.compile
    def step(x):
        return x.sum().item()
    return step'''),
    "TPP204": ('''
    import jax

    @jax.jit
    def step(x):
        import time
        return x + time.time()
    return step''', '''
    import torch

    def step(x):
        import time
        return x + time.time()
    return torch.cuda.make_graphed_callables(step, (ctx.sample,))'''),
    "TPP205": ('''
    import jax

    @jax.jit
    def step(x):
        if x > 0:
            return x
        return -x
    return step''', '''
    import torch

    g = torch.cuda.CUDAGraph()

    def step(x):
        with torch.cuda.graph(g):
            if x > 0:
                return x
            return -x
    return step'''),
    "TPP207": ('''
    import jax
    from tpu_pipelines.trainer import TrainLoopConfig

    config = TrainLoopConfig(train_steps=10, window_steps=8)
    step = 0
    while step < 10:
        jax.device_put({{"x": step}})
        step += 1
    return config''', '''
    import torch
    from tpu_pipelines_torch.trainer import TrainLoopConfig

    config = TrainLoopConfig(train_steps=10, window_steps=8)
    step = 0
    while step < 10:
        torch.tensor([step], device="cuda")
        step += 1
    return config'''),
}


def _seeded_source(rule, side, root, floor=None):
    if rule == "TPP208":
        return '''
@component(outputs={{"examples": "Examples"}}, name="FlashGen")
def FlashGen(ctx):
    from {pkg}.models.bert import build_bert_model

    hp = {{"vocab_size": 64, "d_model": 32, "n_layers": 1, "n_heads": 4,
           "d_ff": 64, "max_len": %d, "dropout_rate": 0.0,
           "num_classes": 2, "attn_impl": "flash"}}
    return build_bert_model(hp)
''' % (floor // 2) + _TAIL.replace("{name}", "FlashGen")
    if rule in _TWINS:
        body = _TWINS[rule][0 if side == "ref" else 1]
        if rule == "TPP207":
            body = body.replace("{{", "{").replace("}}", "}")
        name = f"{rule.title()}Gen"
        return (f'''
@component(outputs={{{{"examples": "Examples"}}}}, name="{name}")
def {name}(ctx):''' + body.replace("{", "{{").replace("}", "}}")
                + _TAIL.replace("{name}", name))
    return _SEEDED_MODULES[rule]


@pytest.mark.parametrize("rule", sorted(
    set(_SEEDED_MODULES) | set(_TWINS) | {"TPP208"}))
def test_cli_exits_3_with_rule_id_per_seeded_fixture(rule, tmp_path, capsys):
    """``lint --json`` exits 3 on every seeded module and names the seeded
    rule (WARN-level rules gate at --fail-on warn), in both packages."""
    def run(ns, tmp):
        root = str(tmp / "root")
        floor = min(ns.autotune.committed_crossovers().values())
        mod = tmp / f"seeded_{rule.lower()}.py"
        mod.write_text((_PRELUDE + _seeded_source(rule, ns.name, ns.root,
                                                  floor)).format(
            pkg=ns.root, root=root))
        argv = ["lint", "--pipeline-module", str(mod), "--json"]
        if ns.RULES[rule]["severity"] == "warn":
            argv += ["--fail-on", "warn"]
        code, out = _cli(ns, argv, capsys)
        doc = json.loads(out)
        return code, rule in doc["rules"], doc["gated"] >= 1

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"] == (3, True, True)


# -------------------------------------------- fingerprint satellites (AC)


def test_fingerprint_json_identical_across_fresh_processes():
    """Same exec-properties bag => the same hash in two interpreters with
    different hash seeds, and the port's hash equals the reference's."""
    prog = textwrap.dedent('''
        import sys
        from importlib import import_module

        fingerprint_json = import_module(
            sys.argv[1] + ".utils.fingerprint").fingerprint_json


        class Opaque:
            pass


        props = {
            "obj": Opaque(),
            "s": {3, 1, 2},
            "b": b"\\x00\\x01",
            "nested": {"t": (1, 2), "c": complex(1, 2)},
        }
        print(fingerprint_json(props))
    ''')
    outs = []
    for pkg, seed in (("tpu_pipelines_torch", "1"),
                      ("tpu_pipelines_torch", "2"), ("tpu_pipelines", "3")):
        env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONHASHSEED": seed,
               "PYTHONPATH": REPO}
        outs.append(subprocess.run(
            [sys.executable, "-c", prog, pkg], cwd=REPO, env=env,
            capture_output=True, text=True, check=True).stdout.strip())
    assert outs[0] == outs[1] == outs[2]
    assert len(outs[0]) == 64


def test_fingerprint_json_distinguishes_types_not_addresses():
    class A:
        pass

    class B:
        pass

    for ns in PKGS.values():
        fj = ns.fp.fingerprint_json
        assert fj({"o": A()}) == fj({"o": A()})
        assert fj({"o": A()}) != fj({"o": B()})
    assert PKGS["port"].fp.fingerprint_json({"o": A(), "c": complex(1, 2)}) \
        == PKGS["ref"].fp.fingerprint_json({"o": A(), "c": complex(1, 2)})


def test_fingerprint_callable_sees_closure_values():
    def make(cfg, scale=1.0):
        def executor(ctx, _scale=scale):
            return {"cfg": cfg, "scale": _scale}
        return executor

    got = {}
    for side, ns in PKGS.items():
        fc = ns.fp.fingerprint_callable
        v1, v1b = fc(make({"lr": 0.1})), fc(make({"lr": 0.1}))
        v2, v3 = fc(make({"lr": 0.2})), fc(make({"lr": 0.1}, scale=2.0))
        assert v1 == v1b and v1 != v2 and v1 != v3
        keys = {ns.fp.execution_cache_key("N", v, {"p": 1},
                                          {"examples": ["abc"]})
                for v in (v1, v2, v3)}
        got[side] = (v1, v2, v3, sorted(keys))
    assert got["port"] == got["ref"]
    assert len(got["port"][3]) == 3


def test_fingerprint_callable_versions_captured_helpers(tmp_path):
    def capture(h):
        def executor(ctx):
            return h(1)
        return executor

    def run(ns, tmp):
        helpers = []
        for i, body in enumerate(("x + 1", "x + 2")):
            mod = tmp / f"helper{i}.py"
            mod.write_text(f"def helper(x):\n    return {body}\n")
            helpers.append(ns.load_fn(str(mod), "helper"))
        return [ns.fp.fingerprint_callable(capture(h)) for h in helpers]

    got = _both(run, tmp_path)
    assert got["port"][0] != got["port"][1]
    assert got["ref"][0] != got["ref"][1]


# ------------------------------------------------- IR stability golden (AC)


def _stub_cls(ns, name, outs, ins=None):
    @ns.component(inputs=ins or {}, outputs=outs, name=name)
    def C(ctx):
        pass

    return C


def _diamond(ns):
    Gen = _stub_cls(ns, "Gen", {"examples": "Examples"})
    Left = _stub_cls(ns, "Left", {"statistics": "ExampleStatistics"},
                     {"examples": "Examples"})
    Right = _stub_cls(ns, "Right", {"schema": "Schema"},
                      {"examples": "Examples"})
    Join = _stub_cls(ns, "Join", {"model": "Model"},
                     {"statistics": "ExampleStatistics", "schema": "Schema"})
    gen = Gen()
    left = Left(examples=gen.outputs["examples"])
    right = Right(examples=gen.outputs["examples"])
    join = Join(statistics=left.outputs["statistics"],
                schema=right.outputs["schema"])
    return gen, left, right, join


def test_ir_fingerprint_and_levels_invariant_under_reordering(tmp_path):
    def run(ns, tmp):
        gen, left, right, join = _diamond(ns)
        a = _pipeline(ns, [gen, left, right, join], tmp)
        gen2, left2, right2, join2 = _diamond(ns)
        b = _pipeline(ns, [join2, right2, left2, gen2], tmp)
        ir_a, ir_b = ns.Compiler().compile(a), ns.Compiler().compile(b)
        same = (ir_a.fingerprint() == ir_b.fingerprint(),
                ir_a.topo_levels() == ir_b.topo_levels(), ir_a.topo_levels())
        ir_b.node("Join").exec_properties["new"] = 1
        return same + (ir_a.fingerprint() != ir_b.fingerprint(),)

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"] == (
        True, True, [["Gen"], ["Left", "Right"], ["Join"]], True)


def test_ir_fingerprint_excludes_lint_metadata(tmp_path):
    def run(ns, tmp):
        gen, left, right, join = _diamond(ns)
        p = _pipeline(ns, [gen, left, right, join], tmp)
        base = ns.Compiler().compile(p).fingerprint()
        left.with_lint_suppressions("TPP101")
        ir = ns.Compiler().compile(p)
        return ir.fingerprint() == base, ir.node("Left").lint_suppress

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"] == (True, ["TPP101"])


def test_gated_unknown_level_gates_nothing(tmp_path):
    def run(ns, tmp):
        findings = ns.A.analyze_ir(ns.Compiler().compile(
            _bad_pipeline(ns, tmp)))
        return (ns.A.gated(findings, "everything"),
                len(ns.A.gated(findings, "warn")) == len(findings),
                _key(ns.A.gated(findings, "error")))

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"] == (
        [], True, [("TPP104", "Gen", "error")])


# ------------------------------------------------------------- TPP112


def _rewriter_like(ns, model_src, name="Rewrite"):
    @ns.component(inputs={"model": "Model"}, outputs={"model": "Model"},
                  name=name)
    def Rewrite(ctx):
        pass

    return Rewrite(model=model_src.outputs["model"])


def test_tpp112_pusher_bypasses_rewriter(tmp_path):
    def run(ns, tmp):
        train = _train(ns)
        rewrite = _rewriter_like(ns, train)
        push = _pusher_like(ns, train)
        f112 = [f for f in _ir_findings(ns, [train, rewrite, push], tmp)
                if f.rule == "TPP112"]
        push.with_lint_suppressions("TPP112")
        after = [f for f in _ir_findings(ns, [train, rewrite, push], tmp)
                 if f.rule == "TPP112"]
        return (_key(f112), ["Rewrite" in f.message and "bypassed" in f.message
                             and "rewriter.outputs['model']" in f.fix
                             for f in f112], after)

    got = _both(run, tmp_path)
    assert got["port"] == got["ref"] == (
        [("TPP112", "Push", "warn")], [True], [])


def test_tpp112_pusher_wired_to_rewriter_is_clean(tmp_path):
    def run(ns, tmp):
        train = _train(ns)
        rewrite = _rewriter_like(ns, train)
        return [f for f in _ir_findings(
            ns, [train, rewrite, _pusher_like(ns, rewrite)], tmp)
            if f.rule == "TPP112"]

    assert _both(run, tmp_path) == {"ref": [], "port": []}


def test_tpp112_warm_start_trainer_is_not_a_rewriter(tmp_path):
    def run(ns, tmp):
        prev = _train(ns, "Prev")

        @ns.component(inputs={"base_model": "Model"},
                      outputs={"model": "Model"}, name="Train",
                      optional_inputs=("base_model",))
        def Train(ctx):
            pass

        train = Train(base_model=prev.outputs["model"])
        return [f for f in _ir_findings(
            ns, [prev, train, _pusher_like(ns, train)], tmp)
            if f.rule == "TPP112"]

    assert _both(run, tmp_path) == {"ref": [], "port": []}


def test_tpp112_cli_fail_on_warn(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TPP_PIPELINE_HOME", str(tmp_path))
    body = '''
        @component(outputs={"model": "Model"}, name="Train")
        def Train(ctx):
            pass

        @component(inputs={"model": "Model"}, outputs={"model": "Model"},
                   name="Rewrite")
        def Rewrite(ctx):
            pass

        @component(inputs={"model": "Model"},
                   outputs={"pushed_model": "PushedModel"},
                   name="Push", is_sink=True)
        def Push(ctx):
            pass

        def create_pipeline():
            train = Train()
            rewrite = Rewrite(model=train.outputs["model"])
            return _pipe("bypass-fixture",
                         [train, rewrite, Push(model=train.outputs["model"])])
    '''
    got = _both(lambda ns, tmp: (_lint_json(ns, tmp, body, capsys),
                                 _lint_json(ns, tmp, body, capsys,
                                            "--fail-on", "warn")), tmp_path)
    assert got["port"] == got["ref"]
    (code, rules), (gated, rules2) = got["port"]
    assert (code, gated) == (0, 3) and "TPP112" in rules and "TPP112" in rules2
