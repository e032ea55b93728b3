"""The port's ``LocalDagRunner(spmd_sync=True)``: what it refuses (each
refusal held against the reference's, the twins of
``tests/test_robustness.py``'s and ``tests/test_analysis.py``'s spmd
cases), and what two gloo processes on the CPU do under it.

The two-process cases run once, in one spawn of two ranks
(``tests/torch_spmd_worker.py`` through ``tests/torch_dp_worker.py``'s
``spawn``, joined within 120 s), process 1 on a copy of the store taken
where each scenario says: a failure on one rank fails the node on both
and leaves no cache entry; a snapshot that predates an upstream's publish
still trains on process 0's inputs under process 0's execution id (and
with the broadcasts patched out, the control, the ranks part); a cache
hit on process 0 alone skips on both; the Cond and resolver verdicts are
process 0's.
"""

import os

import pytest

import torch_dp_worker
import torch_spmd_worker

SCENARIOS = [
    ("fail", "torch_spmd_worker:failure_then_retry", {"kind": "raise"}),
    ("fail_after", "torch_spmd_worker:failure_then_retry",
     {"kind": "raise_after"}),
    ("skew", "torch_spmd_worker:snapshot_skew", {"control": False}),
    ("skew_control", "torch_spmd_worker:snapshot_skew", {"control": True}),
    ("cache", "torch_spmd_worker:cache_on_process_zero", {}),
    ("cond", "torch_spmd_worker:cond_verdict", {}),
    ("resolver", "torch_spmd_worker:resolver_verdict", {}),
]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    base = tmp_path_factory.mktemp("spmd")
    scenarios = [(name, kind, {**kw, "home": str(base / name)})
                 for name, kind, kw in SCENARIOS]
    old = {k: os.environ.get(k) for k in ("TPP_TRACE", "TPP_DATA_POOL")}
    os.environ["TPP_DATA_POOL"] = "thread"
    try:
        return torch_dp_worker.spawn(2, scenarios, str(base / "out"),
                                     timeout_s=120.0)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.mark.parametrize("scenario,rank1_calls", [("fail", 1),
                                                   ("fail_after", 2)])
def test_a_failure_on_one_rank_fails_the_node_on_both(ranks, scenario,
                                                      rank1_calls):
    r0, r1 = ranks[0][scenario], ranks[1][scenario]
    assert r0["fail"]["status"] == r1["fail"]["status"] == "FAILED"
    assert "executor failed on process(es) [1]" in r0["fail"]["error"]
    # No cache entry: the retry executes, once on each rank.
    assert r0["retry"]["status"] == r1["retry"]["status"] == "COMPLETE"
    # RAISE fires before rank 1's executor body, RAISE_AFTER once it
    # returned; rank 0 ran it twice.
    assert (r0["calls"], r1["calls"]) == (2, rank1_calls)
    assert r0["retry"]["uris"] == r1["retry"]["uris"]
    assert r0["files"] == ["device_0", "device_1", "seen_0", "seen_1"]
    assert r0["executions"] == ["FAILED", "COMPLETE", "CACHED"]
    # Process 1 published nothing into its copy.
    assert r1["executions"] == []
    assert r0["again"]["status"] == r1["again"]["status"] == "CACHED"
    assert r0["again_calls"] == r1["again_calls"] == 0


def test_a_stale_snapshot_trains_on_process_zeros_inputs(ranks):
    r0, r1 = ranks[0]["skew"], ranks[1]["skew"]
    assert r0["status"] == r1["status"] == "COMPLETE"
    assert r0["seen"] == r1["seen"] == "v2"
    assert r0["uris"] == r1["uris"]
    assert r0["uris"]["model"][0].endswith(f"/{r0['execution_id']}")


def test_without_the_broadcasts_the_ranks_part(ranks):
    """The control: process 1 resolves its snapshot's upstream and writes
    under its own execution id."""
    r0, r1 = ranks[0]["skew_control"], ranks[1]["skew_control"]
    assert (r0["seen"], r1["seen"]) == ("v2", "v1")
    assert r0["uris"] != r1["uris"]


def test_a_cache_hit_on_process_zero_alone_skips_on_both(ranks):
    r0, r1 = ranks[0]["cache"], ranks[1]["cache"]
    assert r0["first"]["status"] == r1["first"]["status"] == "COMPLETE"
    assert r0["second"]["status"] == r1["second"]["status"] == "CACHED"
    assert r0["second_calls"] == r1["second_calls"] == 0


def test_the_cond_verdict_is_process_zeros(ranks):
    r0, r1 = ranks[0]["cond"], ranks[1]["cond"]
    assert r0["skip"]["status"] == r1["skip"]["status"] == "COND_SKIPPED"
    assert r0["skip_calls"] == r1["skip_calls"] == 0
    assert r0["run"]["status"] == r1["run"]["status"] == "COMPLETE"
    assert r0["run_calls"] == r1["run_calls"] == 1
    assert r0["executions"] == ["CANCELED", "COMPLETE"]
    # Process 1's copy holds only its own RUNNING registration of the run
    # it did not publish: no CANCELED record of the skip.
    assert r1["executions"] == ["RUNNING"]


def test_the_resolver_verdict_is_process_zeros(ranks):
    r0, r1 = ranks[0]["resolver"], ranks[1]["resolver"]
    assert r0["status"] == r1["status"] == "COMPLETE"
    assert r0["uris"] == r1["uris"] and len(r0["uris"]["model"]) == 1
    assert r0["execution_id"] == r1["execution_id"] > 0
    assert r0["executions"] == ["COMPLETE"] and r1["executions"] == []


# ---------------------------------------------------------------- refusals


def _pipelines(tmp_path):
    """The worker's pipeline, loaded through each package (the reference's
    DSL on the same module text with its package name)."""
    from tpu_pipelines.utils.module_loader import load_fn as ref_load
    from tpu_pipelines_torch.utils.module_loader import load_fn

    out = {}
    for side, pkg, load in (("port", "tpu_pipelines_torch", load_fn),
                            ("ref", "tpu_pipelines", ref_load)):
        home = tmp_path / side
        home.mkdir()
        path = home / "pipeline_def.py"
        text = torch_spmd_worker.PIPELINE.replace("tpu_pipelines_torch", pkg)
        path.write_text(text)
        os.environ["SPMD_HOME"] = str(home)
        out[side] = (lambda load=load, path=path, home=home: (
            os.environ.__setitem__("SPMD_HOME", str(home)),
            load(str(path), "create_pipeline")())[1])
    return out


def _runners():
    from tpu_pipelines.orchestration import LocalDagRunner as Ref
    from tpu_pipelines_torch.orchestration import LocalDagRunner

    return {"port": lambda **kw: LocalDagRunner(device="cpu", **kw),
            "ref": lambda **kw: Ref(**kw)}


def test_max_retries_is_refused_as_the_references():
    for make in _runners().values():
        with pytest.raises(ValueError, match="incompatible with in-runner "
                                             "retries"):
            make(spmd_sync=True, max_retries=2)


def test_ir_retry_policies_are_refused_as_the_references(tmp_path, monkeypatch):
    monkeypatch.setenv("SPMD_RETRY", "1")
    made = _pipelines(tmp_path)
    for side, make in _runners().items():
        with pytest.raises(ValueError, match=r"spmd_sync is incompatible "
                                             r"with in-runner retry policies "
                                             r"\(configured on \['Train'\]\)"):
            make(spmd_sync=True).run(made[side](), from_nodes=["Train"],
                                     to_nodes=["Train"])
    # The env rung does not arm one under spmd_sync.
    from tpu_pipelines_torch.orchestration import LocalDagRunner

    monkeypatch.setenv("TPP_RETRY_MAX_ATTEMPTS", "3")
    runner = LocalDagRunner(device="cpu", spmd_sync=True)
    ir = type("IR", (), {"default_retry_policy": None})()
    node = type("N", (), {"is_resolver": False, "retry_policy": None})()
    assert runner._node_retry_policy(node, ir) is None
    assert LocalDagRunner(device="cpu")._node_retry_policy(node, ir) is not None


def test_resume_from_is_refused_as_the_references(tmp_path):
    made = _pipelines(tmp_path)
    for side, make in _runners().items():
        with pytest.raises(ValueError, match="resume_from is incompatible "
                                             "with spmd_sync"):
            make(spmd_sync=True).run(made[side](), resume_from="latest")


@pytest.mark.parametrize("bounds", [{}, {"to_nodes": ["Train"]}],
                         ids=["whole", "upstream-too"])
def test_more_than_one_node_is_refused_as_the_references(tmp_path, bounds):
    made = _pipelines(tmp_path)
    for side, make in _runners().items():
        with pytest.raises(ValueError, match="spmd_sync requires a "
                                             "single-node partial run"):
            make(spmd_sync=True).run(made[side](), **bounds)


def test_nccl_collectives_take_the_joined_card_from_a_worker_thread(
        monkeypatch):
    """Under NCCL the runner issues its collectives from its worker thread,
    whose current CUDA device is 0 whatever the process drives: they take
    the card the process joined the group on (``LOCAL_RANK`` 1 here).  The
    group and the card are stand-ins: a per-thread current device, as
    CUDA keeps it, and a group that reports the NCCL backend."""
    import concurrent.futures
    import threading

    import torch
    import torch.distributed as dist

    from tpu_pipelines_torch.parallel import distributed

    joined = {"group": False}
    thread = threading.local()
    monkeypatch.setattr(dist, "is_initialized", lambda: joined["group"])
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: joined.update(group=True))
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    monkeypatch.setattr(dist, "get_rank", lambda *a: 1)
    monkeypatch.setattr(dist, "get_backend", lambda *a: "nccl")
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: setattr(thread, "device", int(i)))
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: getattr(thread, "device", 0))
    monkeypatch.setattr(distributed, "_JOINED_CUDA_INDEX", None)
    env = {"WORLD_SIZE": "2", "RANK": "1", "LOCAL_RANK": "1",
           "MASTER_ADDR": "localhost", "MASTER_PORT": "29500"}
    cfg = distributed.maybe_initialize_from_env(device="cuda", env=env)
    assert cfg.process_id == 1 and torch.cuda.current_device() == 1
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        assert pool.submit(torch.cuda.current_device).result() == 0
        got = pool.submit(distributed._collective_device).result()
    assert got == torch.device("cuda", 1)
