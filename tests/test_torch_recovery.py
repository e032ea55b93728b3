"""The port's crash-safe runs against the reference's
(``tests/test_recovery.py``): resume from the metadata store, fencing,
node deadlines and the runner's fault hooks.

Each case runs the same stub chain under the same ``FaultPlan`` through
the reference's ``LocalDagRunner`` and the port's (``device="cpu"``), and
asserts that both give the same invocation order, the same node statuses,
the same adopted sets and the same execution records (node, state, and the
``timeout`` and ``abandoned_reason`` properties), then holds the port to
the reference test's own claims.  Times are held to the reference's
bounds (a hang fails within its deadline + 2 s).  A HANG also leaves no
thread behind once the watchdog has set its cancel event.  CPU-only stubs,
under 30 s.
"""

import importlib
import os
import threading
import time
import types

import pytest

pytestmark = pytest.mark.robustness

SIDES = ("ref", "port")
CALLS = []


@pytest.fixture(autouse=True)
def _clear():
    CALLS.clear()


def _pkg(name):
    root = "tpu_pipelines_torch" if name == "port" else "tpu_pipelines"
    ns = types.SimpleNamespace(name=name)
    comp = importlib.import_module(f"{root}.dsl.component")
    ns.component, ns.Parameter = comp.component, comp.Parameter
    ns.Pipeline = importlib.import_module(f"{root}.dsl.pipeline").Pipeline
    ns.Compiler = importlib.import_module(f"{root}.dsl.compiler").Compiler
    ns.MetadataStore = importlib.import_module(f"{root}.metadata").MetadataStore
    ns.ExecutionState = importlib.import_module(
        f"{root}.metadata.types").ExecutionState
    orch = importlib.import_module(f"{root}.orchestration")
    ns.PipelineRunError = orch.PipelineRunError
    ns.LDR = importlib.import_module(
        f"{root}.orchestration.local_runner").LocalDagRunner
    ns.runner = ((lambda **kw: orch.LocalDagRunner(device="cpu", **kw))
                 if name == "port" else orch.LocalDagRunner)
    ns.faults = importlib.import_module(f"{root}.testing.faults")
    return ns


PKGS = {name: _pkg(name) for name in SIDES}


def _stub(ns, name, outs, ins=None, payload="v1"):
    """Deterministic component: records its call, writes fixed payloads."""

    @ns.component(inputs=ins or {}, outputs=outs, name=name,
                  parameters={"payload": ns.Parameter(type=str,
                                                      default=payload)})
    def C(ctx):
        CALLS.append(ctx.node_id)
        for key in ctx.outputs:
            with open(os.path.join(ctx.output(key).uri, "data.txt"),
                      "w") as f:
                f.write(f"{ctx.node_id}:{key}:{ctx.exec_properties['payload']}")

    return C


def _chain(ns, home, payload="v1"):
    """A -> B -> C -> D in a persistent home (resumable)."""
    A = _stub(ns, "A", {"examples": "Examples"}, payload=payload)
    B = _stub(ns, "B", {"statistics": "ExampleStatistics"},
              {"examples": "Examples"}, payload=payload)
    C = _stub(ns, "C", {"schema": "Schema"},
              {"statistics": "ExampleStatistics"}, payload=payload)
    D = _stub(ns, "D", {"model": "Model"}, {"schema": "Schema"},
              payload=payload)
    a = A()
    b = B(examples=a.outputs["examples"])
    c = C(statistics=b.outputs["statistics"])
    d = D(schema=c.outputs["schema"])
    return ns.Pipeline("chain", [a, b, c, d],
                       pipeline_root=os.path.join(home, "root"),
                       metadata_path=os.path.join(home, "md.sqlite"))


def _executions(ns, md):
    store = ns.MetadataStore(md)
    try:
        return [(e.id, e.node_id, e.state.value,
                 e.properties.get("timeout"),
                 e.properties.get("abandoned_reason"))
                for e in store.get_executions()]
    finally:
        store.close()


def _nodes(result):
    return {nid: (nr.status, nr.adopted) for nid, nr in result.nodes.items()}


def _both(tmp_path, scenario):
    """``scenario(ns, home)`` on each side, with the execution records of
    its store at the end; returns {side: observations} after asserting the
    two sides observed the same."""
    seen = {}
    for side in SIDES:
        CALLS.clear()
        home = str(tmp_path / side)
        seen[side] = scenario(PKGS[side], home)
        md = os.path.join(home, "md.sqlite")
        if os.path.exists(md):
            seen[side].setdefault("executions", _executions(PKGS[side], md))
    assert seen["port"] == seen["ref"]
    return seen


# ------------------------------------------------------------------ resume


def test_kill_orchestrator_then_resume_reruns_only_descendants(tmp_path):
    def scenario(ns, home):
        plan = ns.faults.FaultPlan({"C": ns.faults.NodeFault(
            ns.faults.KILL_ORCHESTRATOR)})
        with plan.activate():
            with pytest.raises(ns.faults.SimulatedCrash):
                ns.runner().run(_chain(ns, home))
        first = list(CALLS)
        pre = {nid: ex_id for ex_id, nid, *_ in
               _executions(ns, os.path.join(home, "md.sqlite"))}
        CALLS.clear()
        p = _chain(ns, home)
        result = ns.runner().run(p, resume_from="latest")
        b_uri = result.nodes["B"].outputs["statistics"][0].uri
        store = ns.MetadataStore(p.metadata_path)
        runs = len(store.get_contexts("pipeline_run"))
        store.close()
        return {
            "calls": (first, list(CALLS)), "nodes": _nodes(result),
            "ids_kept": [result.nodes[n].execution_id == pre[n]
                         for n in ("A", "B")],
            "b_uri": os.path.relpath(b_uri, home),
            "b_data": open(os.path.join(b_uri, "data.txt")).read(),
            "runs": runs, "succeeded": result.succeeded,
            "executions": _executions(ns, p.metadata_path),
            "log": plan.log,
        }

    port = _both(tmp_path, scenario)["port"]
    assert port["calls"] == (["A", "B"], ["C", "D"])
    assert port["succeeded"] and port["ids_kept"] == [True, True]
    assert port["nodes"]["A"] == ("COMPLETE", True)
    assert port["nodes"]["C"] == ("COMPLETE", False)
    assert port["b_data"] == "B:statistics:v1"
    assert port["runs"] == 1  # the run id was continued, not forked


def test_resume_by_run_id_and_unknown_run_id(tmp_path):
    def scenario(ns, home):
        plan = ns.faults.FaultPlan({"B": ns.faults.NodeFault(
            ns.faults.KILL_ORCHESTRATOR)})
        with plan.activate():
            with pytest.raises(ns.faults.SimulatedCrash):
                ns.runner().run(_chain(ns, home), run_id="r-one")
        result = ns.runner().run(_chain(ns, home), resume_from="r-one")
        with pytest.raises(ValueError, match="no prior run"):
            ns.runner().run(_chain(ns, home), resume_from="r-nope")
        return {"run_id": result.run_id, "succeeded": result.succeeded,
                "nodes": _nodes(result), "calls": list(CALLS)}

    port = _both(tmp_path, scenario)["port"]
    assert port["succeeded"] and port["run_id"] == "r-one"


def test_resume_refuses_changed_dag_fingerprint(tmp_path):
    def scenario(ns, home):
        plan = ns.faults.FaultPlan({"C": ns.faults.NodeFault(
            ns.faults.KILL_ORCHESTRATOR)})
        with plan.activate():
            with pytest.raises(ns.faults.SimulatedCrash):
                ns.runner().run(_chain(ns, home))
        # Same topology, another exec-property: a different compiled DAG.
        with pytest.raises(ValueError, match="resume refused"):
            ns.runner().run(_chain(ns, home, payload="v2"),
                            resume_from="latest")
        result = ns.runner().run(_chain(ns, home), resume_from="latest")
        return {"succeeded": result.succeeded, "nodes": _nodes(result),
                "calls": list(CALLS)}

    assert _both(tmp_path, scenario)["port"]["succeeded"]


def test_resume_argument_validation(tmp_path):
    for side in SIDES:
        ns = PKGS[side]
        p = _chain(ns, str(tmp_path / side))
        with pytest.raises(ValueError, match="run_id"):
            ns.runner().run(p, resume_from="latest", run_id="x")
        with pytest.raises(ValueError, match="from_nodes"):
            ns.runner().run(p, resume_from="latest", from_nodes=["B"])
        assert CALLS == []


def test_crash_before_publish_fences_and_reruns_clean(tmp_path):
    def scenario(ns, home):
        md = os.path.join(home, "md.sqlite")
        plan = ns.faults.FaultPlan({"B": ns.faults.NodeFault(
            ns.faults.CRASH_BEFORE_PUBLISH)})
        with plan.activate():
            with pytest.raises(ns.faults.SimulatedCrash):
                ns.runner().run(_chain(ns, home))
        (orphan_id,) = [ex_id for ex_id, nid, st, *_ in _executions(ns, md)
                        if nid == "B" and st == "RUNNING"]
        orphan = os.path.join(home, "root", "B", "statistics", str(orphan_id))
        written = os.path.isdir(orphan)
        CALLS.clear()
        result = ns.runner().run(_chain(ns, home), resume_from="latest")
        return {"written": written, "reclaimed": not os.path.isdir(orphan),
                "calls": list(CALLS), "nodes": _nodes(result),
                "new_id": result.nodes["B"].execution_id != orphan_id,
                "executions": _executions(ns, md)}

    port = _both(tmp_path, scenario)["port"]
    assert port["written"] and port["reclaimed"] and port["new_id"]
    assert port["calls"] == ["B", "C", "D"]  # A adopted, B fenced + re-run
    b_states = [(st, reason) for _, nid, st, _, reason in port["executions"]
                if nid == "B"]
    assert ("COMPLETE", None) in b_states
    (reason,) = [r for st, r in b_states if st == "ABANDONED"]
    assert "crash" in reason


def test_crash_after_publish_adopts_published_execution(tmp_path):
    def scenario(ns, home):
        md = os.path.join(home, "md.sqlite")
        plan = ns.faults.FaultPlan({"B": ns.faults.NodeFault(
            ns.faults.CRASH_AFTER_PUBLISH)})
        with plan.activate():
            with pytest.raises(ns.faults.SimulatedCrash):
                ns.runner().run(_chain(ns, home))
        (b_id,) = [ex_id for ex_id, nid, st, *_ in _executions(ns, md)
                   if nid == "B" and st == "COMPLETE"]
        CALLS.clear()
        result = ns.runner().run(_chain(ns, home), resume_from="latest")
        return {"calls": list(CALLS), "nodes": _nodes(result),
                "b_kept": result.nodes["B"].execution_id == b_id,
                "executions": _executions(ns, md)}

    port = _both(tmp_path, scenario)["port"]
    assert port["calls"] == ["C", "D"] and port["b_kept"]
    assert port["nodes"]["B"] == ("COMPLETE", True)


def test_resume_of_completed_run_reruns_nothing(tmp_path):
    def scenario(ns, home):
        ns.runner().run(_chain(ns, home))
        CALLS.clear()
        result = ns.runner().run(_chain(ns, home), resume_from="latest")
        return {"calls": list(CALLS), "nodes": _nodes(result),
                "succeeded": result.succeeded}

    port = _both(tmp_path, scenario)["port"]
    assert port["calls"] == [] and port["succeeded"]
    assert all(adopted for _, adopted in port["nodes"].values())


# ----------------------------------------------------------------- faults


def test_raise_fault_fires_once_so_retry_succeeds(tmp_path):
    def scenario(ns, home):
        plan = ns.faults.FaultPlan({"B": ns.faults.NodeFault(
            ns.faults.RAISE, message="transient blip")})
        with plan.activate():
            result = ns.runner(max_retries=1).run(_chain(ns, home))
        return {"succeeded": result.succeeded, "calls": list(CALLS),
                "retries": result.nodes["B"].retries, "log": plan.log}

    port = _both(tmp_path, scenario)["port"]
    assert port["succeeded"] and port["retries"] == 1
    assert port["calls"] == ["A", "B", "C", "D"]  # the faulted attempt never ran


def test_raise_fault_without_retry_fails_and_cascades(tmp_path):
    def scenario(ns, home):
        plan = ns.faults.FaultPlan({"B": ns.faults.NodeFault(
            ns.faults.RAISE, message="hard fault")})
        with plan.activate():
            with pytest.raises(ns.PipelineRunError) as e:
                ns.runner().run(_chain(ns, home))
        return {"nodes": _nodes(e.value.result), "calls": list(CALLS),
                "executions": _executions(ns, os.path.join(home, "md.sqlite"))}

    port = _both(tmp_path, scenario)["port"]
    assert port["nodes"]["B"] == ("FAILED", False)
    assert port["nodes"]["D"] == ("FAILED", False)


def test_transient_executor_error_is_retried_under_the_node_policy(tmp_path):
    """TRANSIENT_EXECUTOR_ERROR raises a classified TransientError
    ``times`` times: a node policy of three attempts absorbs two, each
    attempt on a clean slate; with two attempts the node fails."""
    def scenario(ns, home):
        out = {}
        for attempts in (3, 2):
            CALLS.clear()
            p = _chain(ns, os.path.join(home, str(attempts)))
            p.components[1].with_retry_policy(
                max_attempts=attempts, base_delay_s=0.0, jitter=False)
            plan = ns.faults.FaultPlan({"B": ns.faults.NodeFault(
                ns.faults.TRANSIENT_EXECUTOR_ERROR, times=2)})
            with plan.activate():
                result = ns.runner().run(p, raise_on_failure=False)
            out[attempts] = (_nodes(result), list(CALLS),
                             result.nodes["B"].retries, plan.log)
        return out

    port = _both(tmp_path, scenario)["port"]
    nodes, calls, retries, log = port[3]
    assert nodes["D"] == ("COMPLETE", False) and retries == 2
    assert calls == ["A", "B", "C", "D"]
    assert log == [("B", "transient_executor_error")] * 2
    nodes, calls, retries, log = port[2]
    assert nodes["B"] == ("FAILED", False) and retries == 1
    assert calls == ["A"]


# -------------------------------------------------------------- deadlines


def _hang_pipeline(ns, home, timeout_s, **pipeline_kw):
    """Hang (deadline) -> Down, plus an independent Side branch that must
    drain normally while the watchdog fires."""

    @ns.component(inputs={}, outputs={"examples": "Examples"}, name="Hang")
    def Hang(ctx):
        CALLS.append(ctx.node_id)
        released = ctx.extras["cancel_event"].wait(30)
        raise RuntimeError("released" if released else "ceiling")

    @ns.component(inputs={"examples": "Examples"}, outputs={"model": "Model"},
                  name="Down")
    def Down(ctx):
        CALLS.append(ctx.node_id)

    @ns.component(inputs={}, outputs={"schema": "Schema"}, name="Side")
    def Side(ctx):
        CALLS.append(ctx.node_id)
        time.sleep(0.1)
        with open(os.path.join(ctx.output("schema").uri, "s.txt"), "w") as f:
            f.write("side")

    h = Hang().with_execution_timeout(timeout_s)
    d = Down(examples=h.outputs["examples"])
    s = Side()
    return ns.Pipeline("deadline", [h, d, s],
                       pipeline_root=os.path.join(home, "root"),
                       metadata_path=os.path.join(home, "md.sqlite"),
                       **pipeline_kw)


def _settle_threads(before):
    """Give released workers a beat to unwind; the live thread count."""
    deadline = time.monotonic() + 2.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    return threading.active_count()


def test_hung_node_fails_within_deadline_and_run_drains(tmp_path):
    def scenario(ns, home):
        p = _hang_pipeline(ns, home, timeout_s=0.5)
        before = threading.active_count()
        t0 = time.monotonic()
        with pytest.raises(ns.PipelineRunError):
            ns.runner(max_parallel_nodes=3).run(p)
        elapsed = time.monotonic() - t0
        (hang,) = [e for e in _executions(ns, p.metadata_path)
                   if e[1] == "Hang"]
        store = ns.MetadataStore(p.metadata_path)
        (ex,) = [e for e in store.get_executions() if e.node_id == "Hang"]
        store.close()
        return {"in_time": elapsed < 0.5 + 2.0, "hang": hang,
                "no_orphans": _settle_threads(before) <= before,
                "deadline_error": "deadline" in ex.properties["error"],
                "executions": _executions(ns, p.metadata_path)}

    port = _both(tmp_path, scenario)["port"]
    assert port["in_time"] and port["no_orphans"] and port["deadline_error"]
    assert port["hang"][2:4] == ("FAILED", True)


def test_deadline_drains_run_and_sibling_branch_completes(tmp_path):
    def scenario(ns, home):
        result = ns.runner(max_parallel_nodes=3).run(
            _hang_pipeline(ns, home, timeout_s=0.4), raise_on_failure=False)
        return {"nodes": _nodes(result), "calls": sorted(CALLS),
                "hang_timeout": "timeout" in result.nodes["Hang"].error,
                "down_error": result.nodes["Down"].error}

    port = _both(tmp_path, scenario)["port"]
    assert port["hang_timeout"] and port["down_error"] == "upstream failure"
    assert "Down" not in port["calls"]  # never started
    assert port["nodes"]["Side"] == ("COMPLETE", False)  # drained, published


def test_timeout_precedence_component_over_pipeline_over_env(monkeypatch):
    def node(mod, t):
        return mod.NodeIR(
            id="n", component_type="X", inputs={}, outputs={},
            exec_properties={}, executor_version="v", upstream=[],
            execution_timeout_s=t,
        )

    def ir(mod, default):
        return mod.PipelineIR(
            name="p", pipeline_root="/r", metadata_path=":memory:",
            enable_cache=True, nodes=[], default_node_timeout_s=default,
        )

    cases = [(None, 0, 0, 0.0), (None, 7, 30, 7.0), (None, 0, 30, 30.0),
             ("90", 0, 0, 90.0), ("90", 0, 30, 30.0), ("bogus", 0, 0, 0.0)]
    for side in SIDES:
        mod = importlib.import_module(
            ("tpu_pipelines_torch" if side == "port" else "tpu_pipelines")
            + ".dsl.compiler")
        for env, t, default, want in cases:
            if env is None:
                monkeypatch.delenv("TPP_NODE_TIMEOUT_S", raising=False)
            else:
                monkeypatch.setenv("TPP_NODE_TIMEOUT_S", env)
            got = PKGS[side].LDR._node_timeout_s(node(mod, t), ir(mod, default))
            assert got == want, (side, env, t, default)


def test_pipeline_default_deadline_applies_via_ir(tmp_path):
    def scenario(ns, home):
        p = _hang_pipeline(ns, home, timeout_s=0)  # no component override
        p.node_timeout_s = 0.4
        default = ns.Compiler().compile(p).default_node_timeout_s
        result = ns.runner(max_parallel_nodes=3).run(
            p, raise_on_failure=False)
        return {"default": default, "nodes": _nodes(result),
                "hang_timeout": "timeout" in result.nodes["Hang"].error}

    port = _both(tmp_path, scenario)["port"]
    assert port["default"] == 0.4 and port["hang_timeout"]
    assert port["nodes"]["Hang"] == ("FAILED", False)


def test_hang_fault_is_released_by_the_watchdog_and_leaves_no_thread(
        tmp_path):
    """The harness's own HANG parks on the runner's cancel event: the
    watchdog's expiry releases it (``hang_released``, not the safety
    ceiling), the run drains, and no thread outlives the run."""
    def scenario(ns, home):
        p = _chain(ns, home)
        p.components[1].with_execution_timeout(0.3)  # B
        plan = ns.faults.FaultPlan({"B": ns.faults.NodeFault(
            ns.faults.HANG, max_hang_s=20)})
        before = threading.active_count()
        t0 = time.monotonic()
        with plan.activate():
            result = ns.runner().run(p, raise_on_failure=False)
        elapsed = time.monotonic() - t0
        names = {t.name for t in threading.enumerate()}
        return {"log": plan.log, "nodes": _nodes(result),
                "calls": list(CALLS), "in_time": elapsed < 0.3 + 2.0,
                "no_orphans": _settle_threads(before) <= before,
                "no_node_thread": not any(n.startswith("tpp-node")
                                          for n in names),
                "executions": _executions(ns, p.metadata_path)}

    port = _both(tmp_path, scenario)["port"]
    assert port["log"] == [("B", "hang_start"), ("B", "hang_released")]
    assert port["in_time"] and port["no_orphans"] and port["no_node_thread"]
    assert port["nodes"]["B"] == ("FAILED", False)
    assert port["calls"] == ["A"]  # B's executor never ran, C and D never started
