"""The multi-process bootstrap and the per-host input (ROADMAP.md A5)
against the reference's: ``tpu_pipelines/parallel/distributed.py`` and
``tpu_pipelines/data/input_pipeline.py``'s ``per_host_input_config`` /
``assigned_shard_files`` are plain Python, called directly with the same
environments and topologies.  Exact equality throughout.
"""

import dataclasses

import numpy as np
import pytest

from tpu_pipelines.data import input_pipeline as ref_input
from tpu_pipelines.parallel import distributed as ref
from tpu_pipelines_torch.data import examples_io
from tpu_pipelines_torch.data import input_pipeline as port_input
from tpu_pipelines_torch.parallel import distributed as port

ENVS = [
    {},
    {"TPP_NUM_PROCESSES": "1"},
    {"TPP_NUM_PROCESSES": "4", "TPP_COORDINATOR_ADDRESS": "10.0.0.1:8476",
     "TPP_PROCESS_ID": "2"},
    {"TPP_NUM_PROCESSES": "3", "TPP_COORDINATOR_ADDRESS": "host-0",
     "JOB_COMPLETION_INDEX": "1"},
    {"TPP_NUM_PROCESSES": "2", "TPP_COORDINATOR_ADDRESS": "h:1",
     "TPP_PROCESS_ID": "0", "JOB_COMPLETION_INDEX": "1"},
]
BAD_ENVS = [
    ({"TPP_NUM_PROCESSES": "2"}, "TPP_COORDINATOR_ADDRESS"),
    ({"TPP_NUM_PROCESSES": "2", "TPP_COORDINATOR_ADDRESS": "h"},
     "TPP_PROCESS_ID"),
]


def _fields(cfg):
    if cfg is None:
        return None
    return (cfg.coordinator_address, cfg.num_processes, cfg.process_id)


@pytest.mark.parametrize("env", ENVS)
def test_environment_parsing_matches_the_reference(env):
    assert _fields(port.DistributedConfig.from_env(env)) == _fields(
        ref.DistributedConfig.from_env(env))
    assert port.local_process_id(env) == ref.local_process_id(env)
    cfg = port.DistributedConfig.from_env(env)
    if cfg is not None:
        assert cfg.env_vars() == ref.DistributedConfig.from_env(env).env_vars()
        assert port.DistributedConfig.from_env(cfg.env_vars()) == cfg


@pytest.mark.parametrize("env,names", BAD_ENVS)
def test_environment_errors_match_the_reference(env, names):
    with pytest.raises(ValueError, match=names) as want:
        ref.DistributedConfig.from_env(env)
    with pytest.raises(ValueError) as got:
        port.DistributedConfig.from_env(env)
    assert str(got.value) == str(want.value)


def test_torchrun_variables_are_the_launchers_equivalent():
    """torchrun's RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR /
    MASTER_PORT describe the same topology when no TPP_* variable is set;
    the TPP_* ones win when both are."""
    env = {"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1",
           "MASTER_ADDR": "10.1.2.3", "MASTER_PORT": "29500"}
    cfg = port.DistributedConfig.from_env(env)
    assert cfg == port.DistributedConfig("10.1.2.3:29500", 4, 3, 1)
    assert cfg.init_method() == "tcp://10.1.2.3:29500"
    assert port.local_device_index(cfg) == 1
    assert port.local_process_id(env) == 3
    assert port.DistributedConfig.from_env({**env, "WORLD_SIZE": "1"}) is None
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        port.DistributedConfig.from_env({"WORLD_SIZE": "2", "RANK": "0"})
    tpp = {**env, "TPP_NUM_PROCESSES": "2", "TPP_PROCESS_ID": "0",
           "TPP_COORDINATOR_ADDRESS": "c"}
    assert _fields(port.DistributedConfig.from_env(tpp)) == ("c", 2, 0)
    assert port.DistributedConfig("c", 2, 0).init_method() == "tcp://c:8476"
    assert port.maybe_initialize_from_env(device="cpu", env={}) is None
    assert port.maybe_join_process_group("cpu", env={}) == (0, 1)


@pytest.mark.parametrize("n,lost", [(4, [1]), (4, [1, 3]), (3, [0]), (2, []),
                                    (4, [0, 1, 2])])
def test_survivor_configs_match_the_reference(n, lost):
    got = port.survivor_configs(n, lost, coordinator_address="c:1")
    want = ref.survivor_configs(n, lost, coordinator_address="c:1")
    assert [(old, _fields(c)) for old, c in got] == [
        (old, _fields(c)) for old, c in want]


@pytest.mark.parametrize("n,lost,match", [(2, [0, 1], "nothing to re-form"),
                                          (2, [5], "not in 0")])
def test_survivor_config_errors_match_the_reference(n, lost, match):
    with pytest.raises(ValueError, match=match) as want:
        ref.survivor_configs(n, lost)
    with pytest.raises(ValueError) as got:
        port.survivor_configs(n, lost)
    assert str(got.value) == str(want.value)


def _configs(pkg):
    return pkg.InputConfig(batch_size=4, shuffle=False, num_epochs=1,
                           drop_remainder=False)


@pytest.mark.parametrize("count", [1, 2, 3, 4])
@pytest.mark.parametrize("files", [1, 3, 4, 6])
def test_per_host_input_matches_the_reference(count, files, tmp_path):
    """``per_host_input_config`` / ``assigned_shard_files`` for topologies
    of 1-4 processes over 1-6 shard files equal the reference's, and the
    port's readers cover the split disjointly and completely."""
    shard_rows = [10] * files
    rows = []
    uri = str(tmp_path / "ex")
    examples_io.write_split(uri, "train", examples_io.table_from_columns(
        {"row": np.arange(10 * files, dtype=np.int64)}), num_shards=files)
    for index in range(count):
        got = port_input.per_host_input_config(
            _configs(port_input), process_index=index, process_count=count)
        want = ref_input.per_host_input_config(
            _configs(ref_input), process_index=index, process_count=count)
        # The port has no Grain backend: its fields, the reference's values.
        assert dataclasses.asdict(got) == {
            f: getattr(want, f) for f in dataclasses.asdict(got)}
        assert port_input.assigned_shard_files(shard_rows, got) == (
            ref_input.assigned_shard_files(shard_rows, want))
        rows += [int(r) for b in port_input.BatchIterator(uri, "train", got)
                 for r in b["row"]]
    assert sorted(rows) == list(range(10 * files))
    pinned = port_input.InputConfig(batch_size=8, shard_index=1, num_shards=3)
    assert port_input.per_host_input_config(
        pinned, process_index=0, process_count=2) is pinned


def test_per_host_input_reads_the_process_group_without_one():
    """With no process group the topology is one process: the config
    comes back unchanged, as the reference's on one JAX process."""
    cfg = _configs(port_input)
    assert port_input.per_host_input_config(cfg) is cfg
    assert port.process_topology() == (0, 1)
