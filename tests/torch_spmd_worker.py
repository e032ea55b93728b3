"""The ranks of tests/test_torch_spmd_runner.py: the port's runner under
``spmd_sync`` on two gloo processes of the CPU.

Each scenario runs on both ranks of a group spawned by
``tests/torch_dp_worker.py``'s ``spawn`` (kind
``"torch_spmd_worker:<function>"``).  Process 0 works on the shared sqlite
store, process 1 on a copy of it taken at a point the scenario picks (the
snapshot a cluster worker holds), so a store-derived decision can differ
between the two unless process 0's is broadcast.  The pipeline is
:data:`PIPELINE`, written into the scenario's directory: ``Gen -> Train ->
Push`` (Push inside ``Cond(deploy == True)``) and a ``latest_created``
Resolver.  Executors leave a marker file per call under ``<home>/calls``.
"""

from __future__ import annotations

import contextlib
import os
import shutil
from unittest import mock

PIPELINE = '''
import os
import time

import torch.distributed as dist

from tpu_pipelines_torch.components import Resolver
from tpu_pipelines_torch.dsl import Cond, runtime_parameter
from tpu_pipelines_torch.dsl.component import Parameter, component
from tpu_pipelines_torch.dsl.pipeline import Pipeline


def _rank():
    return dist.get_rank() if dist.is_initialized() else 0


def _called(node):
    d = os.path.join(os.environ["SPMD_HOME"], "calls")
    os.makedirs(d, exist_ok=True)
    open(os.path.join(d, f"{node}_{_rank()}_{time.time_ns()}"), "w").close()


@component(outputs={"examples": "Examples"},
           parameters={"content": Parameter(type=str, default="v1")},
           name="Gen")
def Gen(ctx):
    _called("Gen")
    with open(os.path.join(ctx.output("examples").uri, "data"), "w") as f:
        f.write(ctx.exec_properties["content"])


@component(inputs={"examples": "Examples"}, outputs={"model": "Model"},
           resource_class="tpu", name="Train")
def Train(ctx):
    import torch

    _called("Train")
    with open(os.path.join(ctx.input("examples").uri, "data")) as f:
        seen = f.read()
    out = ctx.output("model").uri
    with open(os.path.join(out, f"seen_{_rank()}"), "w") as f:
        f.write(seen)
    x = torch.ones(2, device=ctx.extras["device"]).sum()
    with open(os.path.join(out, f"device_{_rank()}"), "w") as f:
        f.write(f"{x.device.type} {float(x)}")


@component(inputs={"model": "Model"}, outputs={"pushed": "PushedModel"},
           name="Push")
def Push(ctx):
    _called("Push")
    open(os.path.join(ctx.output("pushed").uri, f"ok_{_rank()}"), "w").close()


def create_pipeline():
    home = os.environ["SPMD_HOME"]
    gen = Gen(content=os.environ.get("SPMD_CONTENT", "v1"))
    train = Train(examples=gen.outputs["examples"])
    if os.environ.get("SPMD_RETRY"):
        train.with_retry_policy(max_attempts=3)
    with Cond(runtime_parameter("deploy", default=True) == True):  # noqa: E712
        push = Push(model=train.outputs["model"])
    return Pipeline("spmd-demo",
                    [gen, train, push, Resolver(strategy="latest_created")],
                    pipeline_root=os.path.join(home, "root"),
                    metadata_path=os.path.join(home, "md.sqlite"))
'''


def write_pipeline(home: str) -> str:
    os.makedirs(home, exist_ok=True)
    path = os.path.join(home, "pipeline_def.py")
    with open(path, "w") as f:
        f.write(PIPELINE)
    return path


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank()


def _barrier() -> None:
    import torch.distributed as dist

    dist.barrier()


def _pipeline(home: str, **env):
    from tpu_pipelines_torch.utils.module_loader import load_fn

    os.environ["SPMD_HOME"] = home
    for key in ("SPMD_CONTENT", "SPMD_RETRY"):
        os.environ.pop(key, None)
    os.environ.update(env)
    return load_fn(os.path.join(home, "pipeline_def.py"), "create_pipeline")()


def _snapshot(home: str, tag: str) -> str:
    """Process 1's copy of the shared store, taken now."""
    path = os.path.join(home, f"snapshot_{tag}.sqlite")
    if _rank() == 1:
        shutil.copyfile(os.path.join(home, "md.sqlite"), path)
    _barrier()
    return path


def _store_of(home: str, snapshot: str) -> str:
    """The store this rank runs on: the shared one on process 0, a fresh
    copy of ``snapshot`` on process 1."""
    if _rank() == 0:
        return os.path.join(home, "md.sqlite")
    work = os.path.join(home, f"work_{os.path.basename(snapshot)}")
    shutil.copyfile(snapshot, work)
    return work


def _local(node: str, home: str, **env):
    """One node on process 0 alone (no spmd_sync), then a barrier."""
    from tpu_pipelines_torch.orchestration import LocalDagRunner

    if _rank() == 0:
        LocalDagRunner(device="cpu").run(
            _pipeline(home, **env), from_nodes=[node], to_nodes=[node])
    _barrier()


def _spmd(node: str, home: str, store: str, runtime_parameters=None, **env):
    from tpu_pipelines_torch.orchestration import LocalDagRunner

    p = _pipeline(home, **env)
    p.metadata_path = store
    res = LocalDagRunner(device="cpu", spmd_sync=True).run(
        p, from_nodes=[node], to_nodes=[node], raise_on_failure=False,
        runtime_parameters=runtime_parameters)
    nr = res.nodes[node]
    out = {"status": nr.status, "execution_id": nr.execution_id,
           "error": nr.error,
           "uris": {k: [a.uri for a in v] for k, v in nr.outputs.items()}}
    _barrier()
    return out


def _calls(home: str, node: str):
    d = os.path.join(home, "calls")
    if not os.path.isdir(d):
        return 0
    return sum(1 for f in os.listdir(d) if f.startswith(f"{node}_{_rank()}_"))


def _executions(store: str, node: str):
    from tpu_pipelines_torch.metadata import open_store

    s = open_store(store)
    try:
        return [ex.state.value for ex in s.get_executions(node_id=node)]
    finally:
        s.close()


@contextlib.contextmanager
def _no_broadcasts():
    """The control: every process keeps its own store-derived decisions
    (the runner's collectives patched to local answers)."""
    from tpu_pipelines_torch.orchestration import local_runner

    with mock.patch.object(local_runner._dist, "broadcast_int",
                           side_effect=lambda v: int(v)), \
            mock.patch.object(local_runner._dist, "broadcast_json",
                              side_effect=lambda o: o), \
            mock.patch.object(local_runner._dist, "allgather_int",
                              side_effect=lambda v: [int(v), int(v)]):
        yield


def failure_then_retry(home: str, kind: str):
    """A failure planted in rank 1's executor attempt only (``kind``:
    before the executor body or after it returned) fails the node on both
    ranks (no cache entry); the retry executes; a third run is cached."""
    from tpu_pipelines_torch.testing import faults

    write_pipeline(home) if _rank() == 0 else None
    _barrier()
    _local("Gen", home)
    snap = _snapshot(home, "a")
    plan = faults.FaultPlan({"Train": faults.NodeFault(kind)})
    out = {}
    with plan.activate() if _rank() == 1 else contextlib.nullcontext():
        out["fail"] = _spmd("Train", home, _store_of(home, snap))
    out["retry"] = _spmd("Train", home, _store_of(home, snap))
    calls_before = _calls(home, "Train")
    out["again"] = _spmd("Train", home, _store_of(home, snap))
    out["again_calls"] = _calls(home, "Train") - calls_before
    out["calls"] = calls_before
    out["executions"] = _executions(_store_of(home, snap) if _rank() else
                                    os.path.join(home, "md.sqlite"), "Train")
    if out["retry"]["uris"]:
        out["files"] = sorted(os.listdir(out["retry"]["uris"]["model"][0]))
    return out


def snapshot_skew(home: str, control: bool):
    """Process 1's snapshot predates process 0's second Gen publish: with
    the broadcasts both ranks train on process 0's inputs under process
    0's execution id; without them (the control) they part."""
    write_pipeline(home) if _rank() == 0 else None
    _barrier()
    _local("Gen", home, SPMD_CONTENT="v1")
    snap = _snapshot(home, "old")
    _local("Gen", home, SPMD_CONTENT="v2")
    store = _store_of(home, snap)
    with _no_broadcasts() if control else contextlib.nullcontext():
        out = _spmd("Train", home, store)
    uri = out["uris"].get("model", [""])[0]
    seen = os.path.join(uri, f"seen_{_rank()}")
    out["seen"] = open(seen).read() if os.path.exists(seen) else None
    return out


def cache_on_process_zero(home: str):
    """After a spmd run published Train, process 1 runs again on its
    snapshot from before that publish: process 0's cache hit skips the
    node on both ranks."""
    write_pipeline(home) if _rank() == 0 else None
    _barrier()
    _local("Gen", home)
    snap = _snapshot(home, "before_train")
    first = _spmd("Train", home, _store_of(home, snap))
    calls = _calls(home, "Train")
    second = _spmd("Train", home, _store_of(home, snap))
    return {"first": first, "second": second,
            "second_calls": _calls(home, "Train") - calls}


def cond_verdict(home: str):
    """Push's Cond verdict is process 0's: runtime parameters that differ
    between the ranks skip (or run) the node on both, and only process 0
    records the skip."""
    write_pipeline(home) if _rank() == 0 else None
    _barrier()
    _local("Gen", home)
    _local("Train", home)
    snap = _snapshot(home, "c")
    skip = _spmd("Push", home, _store_of(home, snap),
                 runtime_parameters={"deploy": _rank() == 1})
    skip_calls = _calls(home, "Push")
    store = _store_of(home, snap)
    run = _spmd("Push", home, store,
                runtime_parameters={"deploy": _rank() == 0})
    shared = os.path.join(home, "md.sqlite")
    return {"skip": skip, "skip_calls": skip_calls, "run": run,
            "run_calls": _calls(home, "Push") - skip_calls,
            "executions": _executions(shared if _rank() == 0 else store,
                                      "Push")}


def resolver_verdict(home: str):
    """Process 1's snapshot predates the Model's publish: the resolver's
    answer and its execution id are process 0's on both ranks."""
    write_pipeline(home) if _rank() == 0 else None
    _barrier()
    _local("Gen", home)
    snap = _snapshot(home, "r")
    _local("Train", home)
    store = _store_of(home, snap)
    out = _spmd("Resolver", home, store)
    out["executions"] = _executions(
        os.path.join(home, "md.sqlite") if _rank() == 0 else store,
        "Resolver")
    return out


def card_run_node(home: str):
    """On the card: both ranks run the Train node through
    ``run_node.main`` (default device cuda) with the env torchrun gives
    rank r of two, in the spawned gloo group; process 0 publishes."""
    import torch

    from tpu_pipelines_torch import run_node

    torch.cuda.set_device(0)
    write_pipeline(home) if _rank() == 0 else None
    _barrier()
    _local("Gen", home)
    env = {"SPMD_HOME": home, "RANK": str(_rank()), "LOCAL_RANK": str(_rank()),
           "WORLD_SIZE": "2", "MASTER_ADDR": "localhost",
           "MASTER_PORT": "29500"}
    with mock.patch.dict(os.environ, env):
        code = run_node.main(["--pipeline-module",
                              os.path.join(home, "pipeline_def.py"),
                              "--node-id", "Train"])
    _barrier()
    model = os.path.join(home, "root", "Train", "model")
    out = {"code": code,
           "dirs": {d: sorted(os.listdir(os.path.join(model, d)))
                    for d in sorted(os.listdir(model))}}
    if _rank() == 0:
        out["executions"] = _executions(os.path.join(home, "md.sqlite"),
                                        "Train")
        out["device"] = open(os.path.join(
            model, next(iter(out["dirs"])), "device_1")).read()
    return out
