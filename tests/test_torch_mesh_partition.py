"""The port's mesh and partitions (``tpu_pipelines_torch/parallel/mesh.py``
and ``partition.py``, ROADMAP.md A5) against the reference's, on the CPU.

  - ``MeshConfig.resolve`` and its errors: equal;
  - ``shard_batch``: each rank's rows (a ``DeviceMesh`` of W ranks with no
    group), concatenated in rank order, equal the reference's global
    (padded) arrays on its W-device mesh, mask included: exact;
  - ``masked_mean`` against the reference's: 1e-6 relative;
  - ``fsdp_param_partition`` on BERT-small's parameters for n = 2, 4, 8,
    through ``models/convert.py``'s name map (each flax leaf filled with
    its index, converted, read back): the same leaves sharded, the same
    spec wherever the two layouts are the same shape (a transposed kernel
    shards the first divisible dim of its own layout) and the same bytes
    a rank holds: exact;
  - ``foreign_axis_paths`` / ``validate_partition`` over the tensor-
    parallel rules, which name the same leaves as the reference's; the
    rules on a ``model`` axis take a model built on the mesh
    (tests/test_torch_tensor_parallel.py), the MoE experts' ff dim over it
    waits for ROADMAP.md A6c.
"""

import jax
import numpy as np
import pytest
import torch

from tpu_pipelines.models import bert as ref_bert
from tpu_pipelines.models import t5 as ref_t5
from tpu_pipelines.parallel import mesh as ref_mesh
from tpu_pipelines.parallel import partition as ref_part
from tpu_pipelines_torch.models import t5 as port_t5
from tpu_pipelines_torch.models.bert import build_bert_model
from tpu_pipelines_torch.models.convert import (
    bert_state_dict_from_flax,
    t5_state_dict_from_flax,
)
from tpu_pipelines_torch.parallel import mesh as port_mesh
from tpu_pipelines_torch.parallel import partition as port_part

BERT_SMALL = {"vocab_size": 128, "d_model": 64, "n_layers": 2, "n_heads": 4,
              "d_ff": 128, "max_len": 32, "dropout_rate": 0.0,
              "num_classes": 2}
T5_TINY = {"vocab_size": 48, "d_model": 16, "n_layers": 2, "n_heads": 2,
           "head_dim": 16, "d_ff": 32, "dropout_rate": 0.0}


def _devices(n):
    return ref_mesh.make_mesh(ref_mesh.MeshConfig(), devices=jax.devices()[:n])


def _port_mesh(n, rank=0):
    return port_mesh.DeviceMesh(None, rank, {"data": n, "model": 1, "seq": 1,
                                             "expert": 1, "pipe": 1},
                                torch.device("cpu"))


CASES = [
    ({}, 8), ({"data": 2, "model": 4}, 8), ({"data": -1, "seq": 2}, 8),
    ({"data": 3}, 3), ({"model": -1, "data": 2}, 4),
]
ERRORS = [({"data": 2}, 1), ({"data": -1, "model": -1}, 4),
          ({"data": -1, "model": 3}, 8), ({"data": 2, "model": 2}, 8)]


@pytest.mark.parametrize("axes,n", CASES)
def test_mesh_config_resolve_matches_the_reference(axes, n):
    assert port_mesh.MeshConfig(**axes).resolve(n) == (
        ref_mesh.MeshConfig(**axes).resolve(n))
    assert port_mesh.AXES == ref_mesh.AXES


@pytest.mark.parametrize("axes,n", ERRORS)
def test_mesh_config_errors_match_the_reference(axes, n):
    with pytest.raises(ValueError) as want:
        ref_mesh.MeshConfig(**axes).resolve(n)
    with pytest.raises(ValueError) as got:
        port_mesh.MeshConfig(**axes).resolve(n)
    assert str(got.value) == str(want.value)


def test_make_mesh_of_one_process_and_the_a6_refusal():
    mesh = port_mesh.make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.backend) == (None, 0, 1, "")
    assert mesh.shape == {"data": 1, "model": 1, "seq": 1, "expert": 1, "pipe": 1}
    assert port_mesh.make_mesh({"data": 1}, device="cpu").shape["data"] == 1
    assert port_mesh.make_mesh({"seq": 1, "expert": 1}, device="cpu").world == 1
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        port_mesh.make_mesh({"data": 2}, device="cpu")
    # seq and expert (A6a), model and pipe (A6b) are ported: two of any of
    # them do not cover one process (the reference's error), and an axis
    # of 1 is a mesh of the one process.
    for axis in ("seq", "expert", "model", "pipe"):
        with pytest.raises(ValueError, match="does not cover 1 devices"):
            port_mesh.make_mesh({"data": 1, axis: 2}, device="cpu")
        assert port_mesh.make_mesh({axis: 1}, device="cpu").world == 1
    # Ranks map to coordinates as the reference reshapes its devices: AXES
    # order, row-major, the last axis fastest.
    sizes = {"data": 2, "model": 1, "seq": 2, "expert": 2, "pipe": 1}
    devices = np.arange(8).reshape([sizes[a] for a in ref_mesh.AXES])
    for rank in range(8):
        coords = port_mesh.coords_of(rank, sizes)
        assert devices[tuple(coords[a] for a in ref_mesh.AXES)] == rank


def _batch(rows, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(rows, 3)).astype(np.float32),
            "ids": rng.integers(0, 9, size=(rows, 5)).astype(np.int32)}


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("rows", [16, 12, 13])
def test_shard_batch_rows_concatenate_to_the_reference(n, rows):
    batch = _batch(rows)
    want = {k: np.asarray(v) for k, v in
            ref_mesh.shard_batch(batch, _devices(n)).items()}
    parts = [port_mesh.shard_batch(batch, _port_mesh(n, r)) for r in range(n)]
    assert sorted(parts[0]) == sorted(want)
    for key, value in want.items():
        got = np.concatenate([p[key].numpy() for p in parts])
        assert got.dtype == value.dtype and np.array_equal(got, value), key
    padded = rows % n != 0
    assert (port_mesh.VALID_MASK_KEY in want) == padded
    if not padded:  # the exact path: rank r's rows are the slice
        k = rows // n
        assert np.array_equal(parts[1]["x"].numpy(), batch["x"][k:2 * k])


def test_shard_batch_of_one_array_must_divide():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    assert np.array_equal(port_mesh.shard_batch(x, _port_mesh(3, 2)).numpy(), x[4:])
    with pytest.raises(ValueError, match="not divisible"):
        port_mesh.shard_batch(x, _port_mesh(4))
    assert port_mesh.pad_to_multiple(13, 4) == ref_mesh.pad_to_multiple(13, 4) == 16


def test_masked_mean_matches_the_reference():
    rng = np.random.default_rng(3)
    # Losses are positive: values away from 0, where a relative 1e-6 is a
    # statement about the sums (near 0 it would be one about cancellation).
    values = (2.0 + rng.normal(size=(16, 3))).astype(np.float32)
    mask = (np.arange(16) < 11).astype(np.float32)
    for v, m in ((values, mask), (values[:, 0], mask), (values, None)):
        want = float(ref_mesh.masked_mean(v, m))
        got = float(port_mesh.masked_mean(
            torch.from_numpy(v), None if m is None else torch.from_numpy(m)))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert torch.equal(port_mesh.masked_mean(torch.from_numpy(values)),
                       torch.mean(torch.from_numpy(values)))


# ---- partitions, through convert.py's name map

def _flax_bert():
    model = ref_bert.build_bert_model(BERT_SMALL)
    feats = {"input_ids": np.ones((2, 8), np.int32),
             "attention_mask": np.ones((2, 8), np.int32)}
    return jax.tree.map(np.asarray, model.init(jax.random.key(0), feats)["params"])


def _paths(tree):
    return [ref_part.path_str(path) for path, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _name_map(flax_params, convert):
    """port name -> reference path: every flax leaf filled with its index
    + 1, converted, and read back from the converted tensor."""
    paths = _paths(flax_params)
    leaves, treedef = jax.tree_util.tree_flatten(flax_params)
    marked = jax.tree_util.tree_unflatten(treedef, [
        np.full(np.shape(x), i + 1, np.float32) for i, x in enumerate(leaves)])
    return {name: paths[int(t.reshape(-1)[0]) - 1]
            for name, t in convert(marked).items()}


def _ref_specs(partition):
    flat = jax.tree_util.tree_flatten_with_path(
        partition, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {ref_part.path_str(path): tuple(spec) for path, spec in flat}


@pytest.mark.parametrize("n", [2, 4, 8])
def test_fsdp_partition_of_bert_small_matches_the_reference(n):
    flax_params = _flax_bert()
    shapes = {p: np.shape(x) for p, x in zip(
        _paths(flax_params), jax.tree_util.tree_leaves(flax_params))}
    names = _name_map(flax_params, bert_state_dict_from_flax)
    want = _ref_specs(ref_part.fsdp_param_partition(flax_params, _devices(n)))
    model = build_bert_model(BERT_SMALL)
    got = port_part.fsdp_param_partition(model, _port_mesh(n))
    port_shapes = {k: tuple(v.shape) for k, v in model.named_parameters()}
    assert sorted(got) == sorted(names)
    held = {"port": 0, "ref": 0}
    for name, spec in got.items():
        path = names[name]
        assert bool(spec) == bool(want[path]), (name, spec, want[path])
        if port_shapes[name] == shapes[path]:
            assert spec == want[path], name
        size = int(np.prod(port_shapes[name]))
        held["port"] += size // n if spec else size
        held["ref"] += size // n if want[path] else size
    assert held["port"] == held["ref"]
    assert port_part.validate_partition(model, got, _port_mesh(n)) == []
    assert port_part.foreign_axis_paths(model, got) == []


def test_tensor_parallel_rules_name_the_reference_leaves_and_wait_for_a6():
    flax_params = _flax_bert()
    names = _name_map(flax_params, bert_state_dict_from_flax)
    ref_partition = ref_part.make_param_partition(
        flax_params, ref_bert.bert_partition_rules())
    ref_foreign = {line.split(":")[0] for line in
                   ref_part.foreign_axis_paths(flax_params, ref_partition)}
    model = build_bert_model(BERT_SMALL)
    partition = port_part.make_param_partition(model, port_part.bert_partition_rules())
    foreign = port_part.foreign_axis_paths(model, partition)
    assert {names[line.split(":")[0]] for line in foreign} == ref_foreign
    assert partition["encoder.layers.0.attn.query.weight"] == ("model", None)
    assert partition["encoder.layers.1.mlp.wo.weight"] == (None, "model")
    assert partition["encoder.pos_embed.weight"] == ()
    # A model axis of 3 does not divide the head dims: both packages say so
    # for the same leaves.
    three = {"data": 1, "model": 3, "seq": 1, "expert": 1, "pipe": 1}
    problems = port_part.validate_partition(
        model, partition, port_mesh.DeviceMesh(None, 0, three, torch.device("cpu")))
    ref_problems = ref_part.validate_partition(
        flax_params, ref_partition,
        jax.sharding.Mesh(np.asarray(jax.devices()[:3]).reshape(1, 3, 1, 1, 1),
                          ref_mesh.AXES))
    assert {names[p.split(":")[0]] for p in problems} == {
        p.split(":")[0] for p in ref_problems}
    assert all("not divisible by mesh axes ('model',) (size 3)" in p
               for p in problems)

    # On a model axis of 1 every spec is replicated and the implicit mode
    # takes them; fsdp shards over 'data' only and the explicit modes
    # exchange over it alone, psum keeps parameters replicated; above 1
    # the implicit mode takes the specs of a model built on the mesh
    # (tests/test_torch_tensor_parallel.py), not of one built whole.
    from tpu_pipelines_torch.trainer.data_parallel import DataParallel
    from tpu_pipelines_torch.trainer.train_loop import TrainLoopConfig

    def build(mode, mesh):
        return DataParallel.build(
            TrainLoopConfig(train_steps=1, batch_size=8, dp_collective=mode,
                            param_partition=partition),
            mesh, model, mode, False)

    assert build("", _port_mesh(1)).held == {}
    assert port_part.effective_partition(partition, _port_mesh(1)) == {
        name: () for name in partition}
    two = port_mesh.DeviceMesh(None, 0, {**three, "model": 2}, torch.device("cpu"))
    for mode in ("fsdp", "psum_bucketed"):
        with pytest.raises(ValueError, match="'data' axis only"):
            build(mode, two)
    with pytest.raises(ValueError, match="keeps params replicated"):
        build("psum_bucketed", _port_mesh(1))
    with pytest.raises(ValueError, match="its module holds the whole"):
        build("", two)
    # The MoE experts' ff dim over 'model' is a spec like the dense ones
    # (tests/test_torch_moe_tensor_parallel.py trains it on four ranks): a
    # model built whole is refused for holding the experts whole, and on a
    # model axis of 1 the experts' specs replicate.
    moe = build_bert_model({**BERT_SMALL, "moe_experts": 2})
    moe_partition = port_part.make_param_partition(moe, port_part.bert_partition_rules())
    assert moe_partition["encoder.layers.1.moe.wi"] == ("expert", None, "model")
    assert moe_partition["encoder.layers.1.moe.wo"] == ("expert", "model", None)

    def build_moe(mesh):
        return DataParallel.build(
            TrainLoopConfig(train_steps=1, batch_size=8,
                            param_partition=moe_partition), mesh, moe, "", False)

    with pytest.raises(ValueError, match=r"layers\.1\.moe\.wi: spec \(None, None, "
                       r"'model'\) shards it over 'model'"):
        build_moe(two)
    assert build_moe(_port_mesh(1)).held == {}


def test_t5_rules_over_the_port_names():
    params = ref_t5.T5(**T5_TINY).init(jax.random.key(0), {
        "inputs": np.ones((1, 4), np.int32), "targets": np.ones((1, 3), np.int32)})
    flax_params = jax.tree.map(np.asarray, params["params"])
    names = _name_map(flax_params, t5_state_dict_from_flax)
    ref_partition = ref_part.make_param_partition(
        flax_params, ref_t5.t5_partition_rules())
    ref_foreign = {line.split(":")[0] for line in
                   ref_part.foreign_axis_paths(flax_params, ref_partition)}
    model = port_t5.T5(**T5_TINY)
    partition = port_part.make_param_partition(model, port_part.t5_partition_rules())
    foreign = port_part.foreign_axis_paths(model, partition)
    assert {names[line.split(":")[0]] for line in foreign} == ref_foreign
    assert partition["encoder.rel_pos.rel_embedding"] == (None, "model")
    assert partition["shared.weight"] == ("model", None)


def test_gather_leaf_is_the_identity_without_a_group():
    x = torch.arange(6.0).reshape(3, 2)
    assert port_part.gather_leaf(x, (None, "data"), _port_mesh(1)) is x
    assert port_part.spec_dim((None, ("data", "model"))) == 1
    assert port_part.spec_dim(()) is None
    assert torch.equal(port_part.shard_of(torch.arange(8), 0, _port_mesh(4, 3)),
                       torch.tensor([6, 7]))
    assert port_part.path_str(("a", 0, "weight")) == "a.0.weight"
