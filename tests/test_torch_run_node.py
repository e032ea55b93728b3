"""``python -m tpu_pipelines_torch.run_node``, the port's per-node container
entry point (the twin of ``tests/test_cluster_runner.py``'s run_node cases).

Nodes run one by one in subprocesses on the CPU (``--device cpu``) on a
shared sqlite store, as a cluster's pods would; two gloo workers (the env
torchrun gives its processes) run one Trainer node into one shared output
dir under one execution id; a malformed ``TPP_RUNTIME_PARAMETERS`` is a CLI
error; retries are stripped on two processes; a worker refuses a store that
is not on disk.  Every subprocess has its own timeout of at most 120 s.
"""

import os
import socket
import subprocess
import sys
import textwrap
from unittest import mock

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODES = ["CsvExampleGen", "StatisticsGen", "SchemaGen", "Trainer"]


def _module(tmp_path, retry=False, metadata_path=None):
    """CsvExampleGen -> StatisticsGen -> SchemaGen -> a toy Trainer whose
    run_fn writes ``ok_<rank>`` into the model dir."""
    csv = tmp_path / "data.csv"
    csv.write_text("a,b\n" + "\n".join(f"{i},{i * 2}" for i in range(30)) + "\n")
    trainer = tmp_path / "toy_trainer.py"
    trainer.write_text(textwrap.dedent("""
        import os
        import torch.distributed as dist
        from tpu_pipelines_torch.trainer.fn_args import TrainResult

        def run_fn(fn_args):
            rank = dist.get_rank() if dist.is_initialized() else 0
            os.makedirs(fn_args.serving_model_dir, exist_ok=True)
            with open(os.path.join(fn_args.serving_model_dir,
                                   f"ok_{rank}"), "w") as f:
                f.write("trained")
            return TrainResult(final_metrics={"loss": 0.1},
                               steps_completed=1)
    """))
    md = metadata_path or str(tmp_path / "md.sqlite")
    mod = tmp_path / "pipeline_def.py"
    mod.write_text(textwrap.dedent(f"""
        from tpu_pipelines_torch.components import (
            CsvExampleGen, SchemaGen, StatisticsGen, Trainer,
        )
        from tpu_pipelines_torch.dsl.pipeline import Pipeline

        def create_pipeline():
            gen = CsvExampleGen(input_path={str(csv)!r})
            stats = StatisticsGen(examples=gen.outputs["examples"])
            schema = SchemaGen(statistics=stats.outputs["statistics"])
            trainer = Trainer(examples=gen.outputs["examples"],
                              schema=schema.outputs["schema"],
                              module_file={str(trainer)!r}, train_steps=1)
            if {retry!r}:
                trainer.with_retry_policy(max_attempts=3)
            return Pipeline("cluster-demo", [trainer],
                            pipeline_root={str(tmp_path / "root")!r},
                            metadata_path={md!r})
    """))
    return str(mod)


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "TPP_NUM_PROCESSES",
                        "TPP_RUNTIME_PARAMETERS")}
    env.update(PYTHONPATH=REPO, TPP_DATA_POOL="thread", OMP_NUM_THREADS="1")
    env.update(extra)
    return env


def _run_node(mod, node, *args, **env):
    return subprocess.run(
        [sys.executable, "-m", "tpu_pipelines_torch.run_node",
         "--pipeline-module", mod, "--node-id", node, "--device", "cpu",
         *args],
        env=_env(**env), capture_output=True, text=True, timeout=120)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _upstream(mod):
    """The three upstream nodes in this process (one partial run)."""
    from tpu_pipelines_torch.orchestration import LocalDagRunner
    from tpu_pipelines_torch.utils.module_loader import load_fn

    with mock.patch.dict(os.environ, {"TPP_DATA_POOL": "thread"}):
        LocalDagRunner(device="cpu").run(
            load_fn(mod, "create_pipeline")(), to_nodes=["SchemaGen"])


def _two_workers(mod, *args, **env):
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tpu_pipelines_torch.run_node",
         "--pipeline-module", mod, "--node-id", "Trainer", "--device", "cpu",
         *args],
        env=_env(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                 MASTER_ADDR="localhost", MASTER_PORT=port, **env),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    out = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            out.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _trainer_executions(tmp_path):
    from tpu_pipelines_torch.metadata import open_store

    store = open_store(str(tmp_path / "md.sqlite"))
    try:
        return [ex.state.value for ex in store.get_executions(node_id="Trainer")]
    finally:
        store.close()


def _ok_dirs(tmp_path):
    return {dirpath: sorted(f for f in files if f.startswith("ok_"))
            for dirpath, _, files in os.walk(tmp_path / "root")
            if any(f.startswith("ok_") for f in files)}


def test_nodes_run_one_by_one_on_a_shared_store(tmp_path):
    mod = _module(tmp_path)
    for node in NODES:
        proc = _run_node(mod, node)
        assert proc.returncode == 0, f"{node}: {proc.stderr[-2000:]}"
    assert list(_ok_dirs(tmp_path).values()) == [["ok_0"]]
    # A second pod of the same node finds it in the shared store's cache.
    proc = _run_node(mod, "Trainer")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "cache hit" in proc.stderr
    assert _trainer_executions(tmp_path) == ["COMPLETE", "CACHED"]


def test_two_gloo_workers_share_one_output_dir(tmp_path):
    """The twin of test_multihost_run_node_shares_output_dir: process 0's
    execution id names the one model dir both workers write into, and only
    process 0 publishes."""
    mod = _module(tmp_path)
    _upstream(mod)
    for rank, (rc, err) in enumerate(_two_workers(mod)):
        assert rc == 0, f"worker {rank}: {err[-2000:]}"
    dirs = _ok_dirs(tmp_path)
    assert list(dirs.values()) == [["ok_0", "ok_1"]], dirs
    assert _trainer_executions(tmp_path) == ["COMPLETE"]


@pytest.mark.parametrize("bad,why", [("{not json", "not valid JSON"),
                                     ('["a", "b"]', "JSON object")])
def test_malformed_runtime_parameters_are_a_cli_error(tmp_path, bad, why):
    proc = _run_node(_module(tmp_path), "CsvExampleGen",
                     TPP_RUNTIME_PARAMETERS=bad)
    assert proc.returncode == 2, (bad, proc.returncode)
    assert "TPP_RUNTIME_PARAMETERS" in proc.stderr
    assert why in proc.stderr, proc.stderr[-500:]
    assert "Traceback" not in proc.stderr


def test_runtime_parameters_from_env_and_flags(tmp_path):
    """The env's object overlaid by the flags (a flag's value parsed as
    JSON, a raw string otherwise)."""
    from tpu_pipelines_torch import run_node

    import argparse

    parser = argparse.ArgumentParser()
    with mock.patch.dict(os.environ, {
            "TPP_RUNTIME_PARAMETERS": '{"a": 1, "b": "x"}'}):
        got = run_node._runtime_parameters(parser, ["b=[2, 3]", "c=plain"])
    assert got == {"a": 1, "b": [2, 3], "c": "plain"}
    with pytest.raises(SystemExit):
        run_node._runtime_parameters(parser, ["novalue"])


def test_retries_are_stripped_on_two_processes(tmp_path):
    """An IR retry policy and --max-retries would make the spmd runner
    refuse; on two processes run_node strips both (the substrate owns
    retries) and the node runs."""
    mod = _module(tmp_path, retry=True)
    _upstream(mod)
    results = _two_workers(mod, "--max-retries", "2")
    for rank, (rc, err) in enumerate(results):
        assert rc == 0, f"worker {rank}: {err[-2000:]}"
        assert "ignoring --max-retries=2" in err
        assert "stripped from ['Trainer']" in err
    assert _trainer_executions(tmp_path) == ["COMPLETE"]


def test_a_worker_refuses_a_store_that_is_not_on_disk(tmp_path):
    """Process 1 works on a scratch copy of the store: an in-memory store
    has none to copy, and the worker raises before any collective."""
    from tpu_pipelines_torch import run_node
    from tpu_pipelines_torch.parallel.distributed import DistributedConfig

    mod = _module(tmp_path, metadata_path=":memory:")
    cfg = DistributedConfig("localhost:1", 2, 1)
    with mock.patch.object(run_node.distributed, "maybe_initialize_from_env",
                           return_value=cfg), \
            pytest.raises(FileNotFoundError, match="shared on-disk metadata"):
        run_node.main(["--pipeline-module", mod, "--node-id", "Trainer",
                       "--device", "cpu"])
