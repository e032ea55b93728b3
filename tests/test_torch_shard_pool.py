"""Port parity: the resilient shard pool (``data/shard_plan.py``), the
StatisticsGen that maps through it, and the store-write fault hook,
against the JAX package's (``tests/test_robustness.py``).

All checks are exact:

  - ``map_shards_resilient`` on the same tasks gives the same
    ``ShardResult`` (results in order, quarantined shards, failure
    messages, retries, pool) in both packages, through the fork pool and
    through threads: clean tasks, a transient failure retried, a
    permanent one quarantined, a worker that dies on one shard (the pool
    replaced, the shard quarantined), and ``KILL_SHARD_WORKER`` (the pool
    replaced once, every shard done);
  - ``fork_unsafe_reason`` names the same hazards (a CUDA tensor is the
    port's counterpart of a device array);
  - a retry budget (``deadline_s``) shorter than a shard only stops
    retries, as in the reference: the same ``ShardResult`` in both;
  - the node's cancel event kills a fork round's wedged workers and
    strikes their shards out (the port's bound on a child wedged at the
    fork), and a StatisticsGen past its node deadline leaves no child
    running;
  - StatisticsGen's ``stats.json`` through the fork pool equals the
    thread pool's and the sequential path's byte for byte, and the
    reference's (which maps through its own pool); a killed worker is
    replaced with the same bytes; ``salvage_shards`` quarantines a
    corrupt shard as the reference does, with the same statistics over
    the survivors;
  - ``STORE_CONTENTION`` is absorbed by the publish retry (both port
    backends) with the reference's log and retry count, and raises once
    the retries are spent.
"""

import importlib
import io
import json
import os
import socket
import sqlite3
import threading
import time
import types

import pytest

SIDES = ("ref", "port")
CSV = os.path.join(os.path.dirname(os.path.abspath(__file__)), "testdata",
                   "taxi_sample.csv")


def _pkg(name):
    root = "tpu_pipelines_torch" if name == "port" else "tpu_pipelines"
    ns = types.SimpleNamespace(root=root)
    for attr, mod in (("shard_plan", "data.shard_plan"),
                      ("faults", "testing.faults"),
                      ("robustness", "robustness"),
                      ("examples_io", "data.examples_io"),
                      ("metrics", "observability.metrics"),
                      ("types", "metadata.types"),
                      ("metadata", "metadata"),
                      ("components", "components"),
                      ("component", "dsl.component"),
                      ("pipeline", "dsl.pipeline"),
                      ("orchestration", "orchestration")):
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    cls = ns.orchestration.LocalDagRunner
    ns.runner = (lambda: cls(device="cpu")) if name == "port" else cls
    return ns


PKGS = {side: _pkg(side) for side in SIDES}


# Per-shard workers: module level (they cross the fork), each task naming
# its package so it raises that package's error types.
def _sq(task):
    return task[1] * task[1]


def _poison(task):
    root, x = task
    if x == 1:
        raise importlib.import_module(f"{root}.robustness").PermanentError(
            "poisoned shard file")
    return x + 100


def _flaky(task):
    root, x, flag_dir = task
    marker = os.path.join(flag_dir, f"fired-{x}")
    if x == 2 and not os.path.exists(marker):
        with open(marker, "w") as f:
            f.write("1")
        raise importlib.import_module(f"{root}.robustness").TransientError(
            "worker blip")
    return x


def _killer(task):
    if task[1] == 1:
        os._exit(17)  # a SIGKILL-equivalent: the preempted-worker shape
    return task[1] * 2


def _wedged_first(task):
    if task[1] == 0:
        time.sleep(60)  # a child stuck on a lock held at the fork
    return task[1]


def _flaky_then_slow(task):
    root, x, flag_dir = task
    if x == 0:
        marker = os.path.join(flag_dir, "fired-0")
        if not os.path.exists(marker):
            with open(marker, "w") as f:
                f.write("1")
            raise importlib.import_module(
                f"{root}.robustness").TransientError("worker blip")
        return x
    time.sleep(2.5)  # longer than the retry budget below
    return x


def _wedged_shard(task):
    """StatisticsGen's shard payload stand-in: records its pid, wedges."""
    with open(os.path.join(os.environ["SHARD_PID_DIR"],
                           str(os.getpid())), "w") as f:
        f.write("1")
    time.sleep(60)


def _tasks(side, scenario, tmp):
    root = PKGS[side].root
    if scenario == "flaky":
        return [(root, i, tmp) for i in range(4)]
    return [(root, i) for i in range(4 if scenario in ("ok", "killer",
                                                       "kill_fault") else 3)]


SCENARIOS = {"ok": _sq, "permanent": _poison, "flaky": _flaky,
             "killer": _killer, "kill_fault": _sq}


def _summary(res):
    return {"results": res.results, "quarantined": res.quarantined,
            "errors": res.failure_summary(), "retries": res.retries,
            "pool": res.pool, "ok": res.ok}


# A worker that calls os._exit would end a thread pool's own process: the
# killer runs through the fork pool only.
@pytest.mark.parametrize("scenario,pool", [
    (scenario, pool) for scenario in sorted(SCENARIOS)
    for pool in ("process", "thread")
    if not (scenario == "killer" and pool == "thread")])
def test_map_shards_resilient_matches_the_reference(
        scenario, pool, tmp_path, monkeypatch):
    monkeypatch.setenv("TPP_DATA_POOL", pool)
    got = {}
    for side, ns in PKGS.items():
        tmp = str(tmp_path / side)
        os.makedirs(tmp)
        policy = ns.robustness.RetryPolicy(max_attempts=3, base_delay_s=0.001)
        call = lambda: ns.shard_plan.map_shards_resilient(  # noqa: E731
            SCENARIOS[scenario], _tasks(side, scenario, tmp), workers=2,
            retry_policy=policy)
        deaths = ns.shard_plan._worker_death_counter().labels("map_shards")
        before = deaths.get()
        if scenario == "kill_fault":
            plan = ns.faults.FaultPlan({ns.faults.SHARD_KEY: ns.faults.NodeFault(
                ns.faults.KILL_SHARD_WORKER, shard=1)})
            with plan.activate():
                res = call()
        else:
            res = call()
        summary = _summary(res)
        replaced = res.pool_replacements
        died = deaths.get() - before
        if scenario == "killer":
            # How many rounds the poison takes down depends on which
            # shards shared its pool: the counts differ run to run.
            summary.pop("retries")
            summary["errors"] = {i: e.split(":")[0]
                                 for i, e in summary["errors"].items()}
            assert replaced >= 1 and died == replaced
        elif pool == "process" and scenario == "kill_fault":
            assert (replaced, died) == (1, 1)
        else:
            assert (replaced, died) == (0, 0)
        got[side] = summary
    assert got["port"] == got["ref"]
    port = got["port"]
    if scenario in ("ok", "kill_fault"):
        assert port["ok"] and port["results"] == [0, 1, 4, 9]
    elif scenario == "flaky":
        assert port["ok"] and port["results"] == [0, 1, 2, 3]
        assert port["retries"] == 1
    elif scenario == "permanent":
        assert port["quarantined"] == [1]
        assert port["results"] == [100, None, 102]
    else:
        assert port["quarantined"] == [1]
        assert port["results"] == [0, None, 4, 6]


def test_map_shards_raises_the_original_exception(monkeypatch):
    for side, ns in PKGS.items():
        root = ns.root
        with pytest.raises(ns.robustness.PermanentError):
            ns.shard_plan.map_shards(_poison, [(root, i) for i in range(3)],
                                     workers=2)
        assert ns.shard_plan.map_shards(
            _sq, [(root, i) for i in (1, 2, 3)], workers=2) == [1, 4, 9]


class _FakeCudaTensor:
    is_cuda = True


_FakeCudaTensor.__module__ = "torch.fake"


def test_fork_unsafe_reason_names_the_same_hazards(tmp_path):
    handle = open(tmp_path / "f", "w")
    conn = sqlite3.connect(":memory:")
    sock = socket.socket()
    try:
        values = [threading.Lock(), threading.RLock(), threading.Event(),
                  handle, io.BytesIO(), conn, sock, 3, "text", [1, 2], None]
        got = {side: [ns.shard_plan.fork_unsafe_reason(v) for v in values]
               for side, ns in PKGS.items()}
        assert got["port"] == got["ref"]
        assert got["port"][:7] == [
            "thread synchronization primitive"] * 3 + [
            "open file handle"] * 2 + ["sqlite connection", "socket"]
        reason = PKGS["port"].shard_plan.fork_unsafe_reason
        assert reason(_FakeCudaTensor()) == "device tensor"
        import torch

        assert reason(torch.zeros(2)) is None  # a CPU tensor forks fine
    finally:
        handle.close()
        conn.close()
        sock.close()


@pytest.mark.parametrize("pool", ["process", "thread"])
def test_a_retry_budget_shorter_than_a_shard_only_stops_retries(
        pool, tmp_path, monkeypatch):
    """deadline_s = 1 s, shards of 2.5 s: the budget is checked between
    attempts only and never kills a running shard, so the slow shards
    complete in both packages alike.  The fork pool settles shard 0's
    early transient failure inside the budget and retries it; a thread
    round settles after its slowest shard, past the budget, and strikes
    shard 0 out (the reference's semantics on both sides)."""
    monkeypatch.setenv("TPP_DATA_POOL", pool)
    got = {}
    for side, ns in PKGS.items():
        tmp = str(tmp_path / side)
        os.makedirs(tmp)
        policy = ns.robustness.RetryPolicy(
            max_attempts=3, base_delay_s=0.001, deadline_s=1.0)
        res = ns.shard_plan.map_shards_resilient(
            _flaky_then_slow, [(ns.root, i, tmp) for i in range(3)],
            workers=3, retry_policy=policy)
        got[side] = (_summary(res), res.pool_replacements)
    assert got["port"] == got["ref"]
    summary, replaced = got["port"]
    assert summary["results"][1:] == [1, 2] and replaced == 0
    if pool == "process":
        assert summary["ok"] and summary["results"][0] == 0
        assert summary["retries"] == 1
    else:
        assert summary["quarantined"] == [0] and summary["retries"] == 0


def test_a_cancelled_round_kills_its_wedged_workers(monkeypatch):
    """Shard 0 wedges (a child stuck at the fork); once the node's cancel
    event is set the round's workers are killed and shard 0 strikes out
    as cancelled, with no retry and no pool death; the others finish."""
    sp = PKGS["port"].shard_plan
    monkeypatch.setenv("TPP_DATA_POOL", "process")
    cancel = threading.Event()
    timer = threading.Timer(1.0, cancel.set)
    timer.start()
    t0 = time.monotonic()
    try:
        res = sp.map_shards_resilient(
            _wedged_first, [("tpu_pipelines_torch", i) for i in range(3)],
            workers=3, cancel=cancel)
    finally:
        timer.cancel()
    assert time.monotonic() - t0 < 30
    assert res.results == [None, 1, 2] and res.quarantined == [0]
    assert "cancelled" in res.failure_summary()[0]
    assert (res.retries, res.pool_replacements) == (0, 0)


def test_statistics_gen_past_its_node_deadline_leaves_no_child(
        tmp_path, monkeypatch):
    """Every StatisticsGen shard wedges in its forked child: the node's
    deadline watchdog fails the node with a timeout and its cancel event
    kills the children, so the run returns and no worker outlives it."""
    ns = PKGS["port"]
    pid_dir = tmp_path / "pids"
    pid_dir.mkdir()
    monkeypatch.setenv("SHARD_PID_DIR", str(pid_dir))
    monkeypatch.setenv("TPP_DATA_SHARDS", "4")
    monkeypatch.setenv("TPP_DATA_POOL", "process")
    monkeypatch.setenv("TPP_NODE_TIMEOUT_S", "3")
    stats_mod = importlib.import_module(
        "tpu_pipelines_torch.components.statistics_gen")
    monkeypatch.setattr(stats_mod, "accumulate_split_shard", _wedged_shard)
    gen = ns.components.CsvExampleGen(input_path=CSV)
    stats = ns.components.StatisticsGen(examples=gen.outputs["examples"])
    t0 = time.monotonic()
    result = ns.runner().run(ns.pipeline.Pipeline(
        "wedge", [gen, stats], pipeline_root=str(tmp_path / "root"),
        metadata_path=str(tmp_path / "md.sqlite")), raise_on_failure=False)
    assert time.monotonic() - t0 < 30
    assert result.nodes["CsvExampleGen"].status == "COMPLETE"
    node = result.nodes["StatisticsGen"]
    assert node.status == "FAILED" and "3s deadline" in node.error
    pids = [int(p.name) for p in pid_dir.iterdir()]
    assert pids and os.getpid() not in pids
    deadline = time.monotonic() + 10
    alive = pids
    while alive and time.monotonic() < deadline:
        alive = [p for p in alive if _alive(p)]
        time.sleep(0.1)
    assert alive == []


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def _examples(side, base, shards="4"):
    """CsvExampleGen over the taxi sample in ``side``'s package: the
    Examples artifact."""
    ns = PKGS[side]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPP_DATA_SHARDS", shards)
        mp.setenv("TPP_DATA_POOL", "thread")
        gen = ns.components.CsvExampleGen(input_path=CSV)
        result = ns.runner().run(ns.pipeline.Pipeline(
            "pool", [gen], pipeline_root=os.path.join(base, "root"),
            metadata_path=os.path.join(base, "md.sqlite")))
    return result.nodes["CsvExampleGen"].outputs["examples"][0]


def _stats(side, examples, out_dir, pool, salvage=False, plan=None):
    """StatisticsGen's executor over ``examples`` with TPP_DATA_POOL=
    ``pool``: (properties, stats.json bytes, output artifact)."""
    ns = PKGS[side]
    os.makedirs(out_dir)
    out = ns.types.Artifact(type_name="ExampleStatistics", uri=out_dir)
    ctx = ns.component.ExecutorContext(
        node_id="StatisticsGen", inputs={"examples": [examples]},
        outputs={"statistics": [out]},
        exec_properties={"chunk_rows": 0, "num_shards": 4,
                         "salvage_shards": salvage,
                         "save_accumulators": False})
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPP_DATA_POOL", pool)
        if plan is not None:
            with plan.activate():
                props = ns.components.StatisticsGen.EXECUTOR(ctx)
        else:
            props = ns.components.StatisticsGen.EXECUTOR(ctx)
    with open(os.path.join(out_dir, "stats.json"), "rb") as f:
        return props, f.read(), out


def test_statistics_gen_through_the_fork_pool_gives_the_same_bytes(tmp_path):
    """The port's stats.json through the fork pool == its thread pool's ==
    its sequential path's, byte for byte, and == the reference's through
    the reference's fork pool; a KILL_SHARD_WORKER run is replaced once
    and writes the same bytes."""
    port_ex = _examples("port", str(tmp_path / "port"))
    ref_ex = _examples("ref", str(tmp_path / "ref"))
    n = PKGS["port"].examples_io.num_split_shards(port_ex.uri, "train")
    assert n == 4
    got = {pool: _stats("port", port_ex, str(tmp_path / f"port-{pool}"),
                        pool)[1]
           for pool in ("process", "thread", "none")}
    ns = PKGS["port"]
    deaths = ns.shard_plan._worker_death_counter().labels("map_shards")
    before = deaths.get()
    plan = ns.faults.FaultPlan({ns.faults.SHARD_KEY: ns.faults.NodeFault(
        ns.faults.KILL_SHARD_WORKER, shard=2)})
    killed = _stats("port", port_ex, str(tmp_path / "port-killed"),
                    "process", plan=plan)[1]
    ref = _stats("ref", ref_ex, str(tmp_path / "ref-process"), "process")[1]
    assert got["process"] == got["thread"] == got["none"] == killed == ref
    assert deaths.get() - before == 1
    assert json.loads(ref)["train"]["num_examples"] > 0


def test_salvage_shards_quarantines_a_corrupt_shard_as_the_reference(
        tmp_path):
    """One train shard file overwritten: without salvage the executor
    raises; with ``salvage_shards`` the shard is quarantined on the
    execution and the artifact, and the statistics cover the survivors
    exactly, as in the reference."""
    got = {}
    for side, ns in PKGS.items():
        examples = _examples(side, str(tmp_path / side))
        paths = ns.examples_io.split_shard_paths(examples.uri, "train")
        counts = ns.examples_io.shard_row_counts(examples.uri, "train")
        with open(paths[1], "wb") as f:
            f.write(b"definitely not a shard")
        with pytest.raises(Exception):
            _stats(side, examples, str(tmp_path / f"{side}-strict"),
                   "process")
        props, data, out = _stats(side, examples,
                                  str(tmp_path / f"{side}-salvage"),
                                  "process", salvage=True)
        stats = json.loads(data)
        got[side] = (props["partial_statistics"],
                     sorted(props["quarantined_shards"]["train"]),
                     out.properties["quarantined_shards"],
                     stats["train"]["num_examples"], sum(counts) - counts[1],
                     stats["eval"]["num_examples"])
    assert got["port"][:2] == got["ref"][:2] == (True, [1])
    assert got["port"][2] == got["ref"][2] == {"train": [1]}
    assert got["port"][3:] == got["ref"][3:]
    assert got["port"][3] == got["port"][4]


def _counter_total(ns, name, site):
    metric = ns.metrics.default_registry().get(name)
    return metric.labels(site).get() if metric is not None else 0.0


@pytest.mark.parametrize("backend", ["python", "native"])
def test_store_contention_is_absorbed_by_the_publish_retry(tmp_path,
                                                           backend):
    """STORE_CONTENTION twice: the publish retries twice and lands once,
    the plan's log and the retry counter as the reference's; 99 times:
    StoreUnavailableError and no row."""
    got = {}
    for side, ns in PKGS.items():
        path = str(tmp_path / f"{side}.sqlite")
        if side == "port":
            store = ns.metadata.open_store(path, backend=backend)
            if backend == "native":
                from tpu_pipelines_torch.metadata.native_store import (
                    NativeMetadataStore,
                )

                assert type(store) is NativeMetadataStore
        else:
            store = ns.metadata.MetadataStore(path)
        before = _counter_total(ns, "retry_attempts_total",
                                "metadata.publish")
        plan = ns.faults.FaultPlan({ns.faults.STORE_KEY: ns.faults.NodeFault(
            ns.faults.STORE_CONTENTION, times=2)})
        art = ns.types.Artifact(type_name="Model", uri="/m/1")
        ex = ns.types.Execution(type_name="Stub", node_id="N",
                                state=ns.types.ExecutionState.COMPLETE)
        with plan.activate():
            store.publish_execution(ex, {}, {"model": [art]}, [])
        retried = _counter_total(ns, "retry_attempts_total",
                                 "metadata.publish") - before
        landed = (len(store.get_executions()), store.get_execution(ex.id).node_id,
                  len(store.get_events_by_execution(ex.id)))
        spent = ns.faults.FaultPlan({ns.faults.STORE_KEY: ns.faults.NodeFault(
            ns.faults.STORE_CONTENTION, times=99)})
        ex2 = ns.types.Execution(type_name="Stub", node_id="M",
                                 state=ns.types.ExecutionState.COMPLETE)
        with spent.activate():
            with pytest.raises(ns.metadata.StoreUnavailableError):
                store.publish_execution(ex2, {}, {}, [])
        rows = len(store.get_executions())
        store.close()
        got[side] = ([e for _, e in plan.log], retried, landed, rows)
    assert got["port"] == got["ref"]
    assert got["port"] == (["store_contention:publish_execution"] * 2, 2,
                           (1, "N", 1), 1)
