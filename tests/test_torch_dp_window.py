"""Data-parallel training (ROADMAP.md A5) on the CPU, over gloo: the port's
counterparts of tests/test_multichip_window.py and tests/test_fsdp_window.py.

Each world size (1, 2, 4) is one group of spawned processes
(tests/torch_dp_worker.py, one CPU thread a rank) that runs every scenario
of that size once; the module fixture joins each group within 300 s (a
group takes 10-40 s alone) and kills it past that.  The JAX side runs here, on the reference's virtual
8-device CPU mesh (tests/conftest.py), on the same models and batches.
Tolerances:

  - ordered mode is held bit for bit across W = 1, 2 and 4 (the port's own
    contract: the same blocks reduced by one ``torch.sum`` over the same
    [G, ...] tensor), and against the reference's ordered run at rtol
    1e-5 plus 1e-5 absolute (Adam over 16 steps at lr 0.05 on two
    libraries' f32 gradients; measured 3.7e-6 at most);
  - psum_bucketed against the reference's psum_bucketed at the same W
    (Adam: as for ordered), and against the port's ordered run on a
    per-row loss (where both compute the same mean gradient, summed in
    another order): rtol 1e-5, atol 1e-6;
  - fsdp against the unsharded run of one process (SGD, as the
    reference's fsdp parity test uses: Adam's normalisation turns
    ulp-level differences of near-zero gradients into drift): rtol 1e-5,
    atol 1e-6;
  - one step's gradients with and without grad accumulation, in every
    mode, against the reference's ``_make_dp_forward_backward``: rtol
    1e-5, atol 1e-7 (the reference test's tolerance);
  - the model state (sync-BN) against the reference's, under SGD: rtol
    1e-5;
  - BERT-small through ``run_fn`` at W = 2: bf16 compute on both sides
    (the reference's and the port's BERT cast to bf16 per product, with
    different accumulation orders), held at 2e-2 on each step's loss and
    2e-3 on each parameter after 3 AdamW steps at lr 1e-4 (|update| <=
    lr a step, so two runs whose gradients differ in sign on a few
    elements sit at most 6e-4 apart per element, plus bf16 noise).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dp_worker as w
from tpu_pipelines.parallel.distributed import survivor_configs as ref_survivors
from tpu_pipelines.parallel.mesh import (
    MeshConfig as RefMeshConfig,
    make_mesh as ref_make_mesh,
    masked_mean as ref_masked_mean,
    shard_batch as ref_shard_batch,
)
from tpu_pipelines.parallel.partition import fsdp_param_partition as ref_fsdp_partition
from tpu_pipelines.trainer import TrainLoopConfig as RefConfig
from tpu_pipelines.trainer import train_loop as ref_train_loop
from tpu_pipelines.trainer.train_loop import _make_dp_forward_backward
from tpu_pipelines_torch.parallel.distributed import survivor_configs
from tpu_pipelines_torch.trainer import TrainLoopConfig, train_loop
from tpu_pipelines_torch.trainer.data_parallel import effective_dp_collective

TOL = dict(rtol=1e-5, atol=1e-6)
# 16 Adam steps at lr 0.05 from two libraries' f32 gradients: 3.7e-6 apart
# at most on parameters of magnitude 0.03-0.8.
ADAM_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-7)
MODES = ("psum_bucketed", "ordered", "fsdp")
TAIL_ROWS = 62
BERT_HP = {
    "vocab_size": 128, "d_model": 64, "n_layers": 2, "n_heads": 4,
    "d_ff": 128, "max_len": 32, "dropout_rate": 0.0, "num_classes": 2,
    "attn_impl": "dense", "learning_rate": 1e-4, "batch_size": 16,
}
BERT_STEPS = 3
BERT_ROWS = 64
# BERT-small computes in bf16 in both packages, each rounding in its own
# order.  Losses: 3.6e-3 apart at most over the 3 steps; with both ranks
# reading shard 0 they are 1.8e-2 to 9.9e-2 from the reference's.
BERT_LOSS_ATOL = 1e-2
# The relative L2 distance of the port's parameter changes from the
# shared init to the reference's: 0.120 (AdamW moves a parameter by about
# lr a step whatever its gradient, so bf16 noise on small gradients shows
# at full size); no update at all is 1.0, both ranks on shard 0 1.02.
BERT_CHANGE_GAP = 0.25


# ---- the reference's models (tests/test_multichip_window.py,
# tests/test_fsdp_window.py)

def _ref_mesh(n):
    return ref_make_mesh(RefMeshConfig(), devices=jax.devices()[:n])


def _ref_loss(params, b, rng):
    pred = jnp.tanh(b["x"] @ params["w1"]) @ params["w2"]
    return jnp.mean((pred - b["y"]) ** 2), {"w_norm": jnp.sum(params["w1"] ** 2)}


def _ref_masked_loss(params, b, rng):
    pred = (jnp.tanh(b["x"] @ params["w1"]) @ params["w2"])[:, 0]
    loss = ref_masked_mean((pred - b["y"]) ** 2, b.get("__valid__"))
    return loss, {"w_norm": jnp.sum(params["w1"] ** 2)}


def _ref_init(rng, b):
    m = w.MLP()
    return {"w1": jnp.asarray(m.w1.detach().numpy()),
            "w2": jnp.asarray(m.w2.detach().numpy())}


def _ref_deep_loss(params, b, rng):
    h = b["x"]
    for i in range(w.LAYERS):
        h = jnp.tanh(h @ params["layers"][f"w_{i}"] + params["layers"][f"b_{i}"])
    pred = h @ params["head"]
    return jnp.mean((pred - b["y"]) ** 2), {"pred_mean": jnp.mean(pred)}


def _ref_deep_sloss(params, mstate, b, rng):
    loss, metrics = _ref_deep_loss(params, b, rng)
    return loss, (metrics, {
        "running": 0.9 * mstate["running"] + 0.1 * metrics["pred_mean"],
        "count": mstate["count"] + 1,
    })


def _ref_deep_init(rng, b):
    m = w.DeepMLP()
    return {
        "layers": {k: jnp.asarray(v.detach().numpy()) for k, v in m.layers.items()},
        "head": jnp.asarray(m.head.detach().numpy()),
    }


def _ref_deep_sinit(rng, b):
    return _ref_deep_init(rng, b), {
        "running": jnp.zeros(()), "count": jnp.zeros((), jnp.int32)}


def _ref_run(n, *, loss=_ref_loss, init=_ref_init, dp="ordered", steps=16,
             window=4, log_every=4, data=None, ckpt="", checkpoint_every=0,
             opt=None, state=False, **kw):
    hist = []
    params, result = ref_train_loop(
        loss_fn=loss, init_params_fn=init, optimizer=opt or optax.adam(0.05),
        train_iter=iter(data if data is not None else w.batches(steps)),
        config=RefConfig(
            train_steps=steps, batch_size=w.BATCH, log_every=log_every,
            window_steps=window, prng_impl=None, dp_collective=dp,
            dp_grad_blocks=w.G, checkpoint_every=checkpoint_every, **kw),
        mesh=_ref_mesh(n), checkpoint_dir=ckpt, has_model_state=state,
        metrics_cb=lambda s, m: hist.append(
            (s, float(m["loss"]), float(m.get("w_norm", m.get("pred_mean", 0))))),
    )
    return params, result, hist


def _ref_leaves(params):
    """A reference params tree as the port's parameter names."""
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        flat[".".join(str(getattr(p, "key", p)) for p in path)] = np.asarray(leaf)
    return flat


def _close(port_params, ref_params, tol):
    ref = _ref_leaves(ref_params)
    assert sorted(port_params) == sorted(ref)
    for name, v in port_params.items():
        np.testing.assert_allclose(v.numpy(), ref[name], err_msg=name, **tol)


def param_change_gap(a, b, init):
    """Relative L2 distance of the parameter changes from ``init`` of two
    state dicts, over every parameter: |(a - init) - (b - init)| / |b - init|."""
    num = den = 0.0
    for name, p in a.items():
        da = p.float() - init[name].float()
        db = b[name].float() - init[name].float()
        num += float((da - db).pow(2).sum())
        den += float(db.pow(2).sum())
    return (num / den) ** 0.5


def _equal(a, b):
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


# ---- the slice as a whole: BERT-small examples and base model

def _bert_rows(seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(4, BERT_HP["max_len"] + 1, size=BERT_ROWS)
    mask = np.arange(BERT_HP["max_len"])[None, :] < lengths[:, None]
    ids = np.where(mask, rng.integers(4, BERT_HP["vocab_size"],
                                      size=mask.shape), 0)
    return {"input_ids": ids.astype(np.int32),
            "attention_mask": mask.astype(np.int32),
            "label": (ids[:, 1] % 2).astype(np.int32)}


def _bert_setup(root):
    """A two-shard examples artifact and a base model exported from the
    reference's flax init (``models/convert.py``)."""
    from tpu_pipelines.models.bert import build_bert_model as ref_build_bert
    from tpu_pipelines_torch.data import examples_io
    from tpu_pipelines_torch.examples import bert_module
    from tpu_pipelines_torch.models.convert import bert_state_dict_from_flax
    from tpu_pipelines_torch.trainer.export import export_model

    examples = os.path.join(root, "examples")
    rows = _bert_rows()
    for split in ("train", "eval"):
        examples_io.write_split(examples, split,
                                examples_io.table_from_columns(rows), num_shards=2)
    model = ref_build_bert(BERT_HP)
    feats = {k: v[:2] for k, v in rows.items() if k != "label"}
    flax_params = jax.tree.map(
        np.asarray, model.init(jax.random.key(0), feats)["params"])
    base = os.path.join(root, "base_model")
    export_model(serving_model_dir=base, params={
        k: v.float() for k, v in bert_state_dict_from_flax(flax_params).items()},
        module_file=bert_module.__file__, hyperparameters=BERT_HP)
    return examples, base, flax_params


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp"))
    data = w.batches(16)
    ckpt = os.path.join(root, "elastic")
    tail = [*w.batches(2), {k: v[:TAIL_ROWS] for k, v in w.batches(1, seed=5)[0].items()}]
    examples, base, flax_params = _bert_setup(root)
    common = [
        ("ordered", "run", {}),
        ("ordered_accum", "run", {"accum": 2}),
    ]
    per_row = [
        ("masked_psum", "run", {"model": "masked", "dp": "psum_bucketed"}),
    ]
    out = {"root": root, "flax": flax_params, "tail": tail}
    out[1] = w.spawn(1, common + [
        ("masked_ordered", "run", {"model": "masked"}),
        ("deep_plain", "run", {"model": "deep", "dp": None, "steps": 8,
                               "opt": "sgd", "lr": 0.1, "log_every": 0}),
        ("deep_plain_adam", "run", {"model": "deep", "dp": None, "steps": 8,
                                    "log_every": 0}),
    ], os.path.join(root, "w1"))
    out[4] = w.spawn(4, common + per_row + [
        ("psum", "run", {"dp": "psum_bucketed"}),
        ("elastic_a", "run", {"data": data[:10], "ckpt": ckpt,
                              "checkpoint_every": 4, "log_every": 0}),
        ("tail", "run", {"model": "masked", "dp": "psum_bucketed", "steps": 3,
                         "window": 1, "log_every": 1, "data": tail,
                         "opt": "sgd", "lr": 0.1}),
    ], os.path.join(root, "w4"))
    # The kill: run A's final save at step 10 never became durable; the
    # progress marker says 10 steps ran, the newest checkpoint is 8.
    os.unlink(os.path.join(ckpt, "ckpt_10.pt"))
    out[2] = w.spawn(2, common + per_row + [
        ("psum", "run", {"dp": "psum_bucketed"}),
        ("deep_fsdp", "run", {"model": "deep", "dp": "fsdp", "steps": 8,
                              "opt": "sgd", "lr": 0.1, "log_every": 0}),
        ("deep_fsdp_adam", "run", {"model": "deep", "dp": "fsdp", "steps": 8,
                                   "log_every": 0}),
        *[(f"grads_{dp}_{a}", "grads", {"dp": dp, "accum": a})
          for dp in MODES for a in (1, 2)],
        *[(f"state_{dp}", "run", {"model": "deep", "dp": dp, "steps": 8,
                                  "state": True, "accum": 2, "log_every": 0,
                                  "opt": "sgd", "lr": 0.1})
          for dp in MODES],
        ("elastic_b", "run", {"data": data[8:], "ckpt": ckpt,
                              "checkpoint_every": 4, "log_every": 0}),
        ("bert", "bert", {"examples": examples, "base_model": base,
                          "out_dir": os.path.join(root, "bert"), "hp": BERT_HP,
                          "steps": BERT_STEPS}),
    ], os.path.join(root, "w2"))
    return out


# ---- 1. ordered across world sizes

def test_ordered_is_bitwise_invariant_to_the_world_size(worlds):
    """Ordered at W = 1, 2, 4: the same parameters and loss series bit for
    bit, with and without grad accumulation (the same fixed G = 8), on
    every rank; and within 1e-5 of the reference's ordered run on its
    8-device mesh."""
    for name in ("ordered", "ordered_accum"):
        base = worlds[1][0][name]
        assert base["steps_completed"] == 16 and base["dp_collective"] == "ordered"
        assert len(base["hist"]) == 4
        for world in (2, 4):
            for rank in worlds[world]:
                got = rank[name]
                assert _equal(got["params"], base["params"]), (name, world)
                assert got["hist"] == base["hist"], (name, world)
                assert got["final_metrics"] == base["final_metrics"]
    ref, result, hist = _ref_run(8)
    assert result.dp_collective == "ordered"
    _close(worlds[1][0]["ordered"]["params"], ref, ADAM_TOL)
    got = worlds[1][0]["ordered"]["hist"]
    assert [s for s, _, _ in got] == [s for s, _, _ in hist]
    np.testing.assert_allclose([v[1:] for v in got], [v[1:] for v in hist],
                               rtol=1e-5)


# ---- 2. psum_bucketed

@pytest.mark.parametrize("world", [2, 4])
def test_psum_bucketed_matches_the_reference_and_ordered(worlds, world):
    """psum_bucketed at W ranks against the reference's psum_bucketed on W
    devices (the reference's loss broadcasts a [B, 1] prediction against
    [B] targets, so its mean depends on the rows a device holds: the same
    W is the same function); and, on a per-row loss, against the port's
    ordered run, which computes the same mean gradient in another order."""
    got = worlds[world][0]["psum"]
    assert got["dp_collective"] == "psum_bucketed"
    for rank in worlds[world][1:]:
        assert _equal(rank["psum"]["params"], got["params"])
    ref, _, hist = _ref_run(world, dp="psum_bucketed")
    _close(got["params"], ref, ADAM_TOL)
    np.testing.assert_allclose([v[1] for v in got["hist"]],
                               [v[1] for v in hist], rtol=1e-5)
    ordered = worlds[1][0]["masked_ordered"]["params"]
    for name, v in worlds[world][0]["masked_psum"]["params"].items():
        np.testing.assert_allclose(v.numpy(), ordered[name].numpy(), **TOL)


# ---- 3. fsdp

def test_fsdp_matches_unsharded_and_holds_its_shards(worlds):
    """fsdp at W = 2 lands on the unsharded run of one process (SGD), the
    backward gathers the saved weights again, and each rank holds half of
    every parameter and of AdamW's moments (every leaf of the deep MLP
    has a dim divisible by 2: none is replicated)."""
    got = worlds[2][0]["deep_fsdp"]
    want = worlds[1][0]["deep_plain"]
    assert got["dp_collective"] == "fsdp" and got["steps_completed"] == 8
    assert sorted(got["params"]) == sorted(want["params"])
    for name, v in got["params"].items():
        np.testing.assert_allclose(v.numpy(), want["params"][name].numpy(),
                                   err_msg=name, **TOL)
    assert _equal(worlds[2][1]["deep_fsdp"]["params"], got["params"])
    whole = want["param_bytes"]
    assert whole == sum(p.numel() * 4 for p in w.DeepMLP().parameters())
    # Each step gathers the 9 shards in the forward and again the 4
    # weights the matmuls saved (the saved-tensor hook: no full weight is
    # held for the backward; the first layer's weight multiplies the input,
    # which needs no gradient, so autograd saves none), reduce-scatters the
    # 9 gradients and all-reduces the loss; the returned model gathers
    # each shard once more.
    assert got["collectives"] == {"all_gather_into_tensor": 8 * (9 + 4) + 9,
                                  "reduce_scatter_tensor": 8 * 9,
                                  "all_reduce": 8}
    for rank in worlds[2]:
        held = rank["deep_fsdp_adam"]
        assert held["param_bytes"] <= whole / 2
        assert held["moment_bytes"] <= worlds[1][0]["deep_plain_adam"]["moment_bytes"] / 2
    # The default partition is the reference's rule, leaf for leaf.
    from tpu_pipelines_torch.parallel.mesh import DeviceMesh
    from tpu_pipelines_torch.parallel.partition import fsdp_param_partition

    mesh = DeviceMesh(None, 0, {"data": 2}, torch.device("cpu"))
    ref = ref_fsdp_partition(_ref_deep_init(None, None), _ref_mesh(2))
    assert fsdp_param_partition(w.DeepMLP(), mesh) == _ref_specs(ref)


def _ref_specs(partition):
    """A reference partition (a tree of PartitionSpec) as name -> tuple."""
    flat = jax.tree_util.tree_flatten_with_path(
        partition, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {".".join(str(getattr(p, "key", p)) for p in path): tuple(spec)
            for path, spec in flat}


# ---- 4. grad accumulation

def test_grad_accum_composes_with_every_mode(worlds):
    """One step's gradient at W = 2, with and without grad_accum_steps 2,
    in every mode, against the reference's dp forward-backward on its
    8-device mesh (the gradient of the global batch's mean loss)."""
    mesh = _ref_mesh(8)
    params = _ref_deep_init(None, None)
    batch = w.deep_batches(1)[0]
    for dp in MODES:
        kw = dict(buckets=2, grad_blocks=8)
        if dp == "fsdp":
            kw["fsdp_specs"] = ref_fsdp_partition(params, mesh)
        for accum in (1, 2):
            ref = _make_dp_forward_backward(_ref_deep_loss, mesh, dp,
                                            accum=accum, **kw)(
                params, None, batch, jax.random.key(0))[2]
            for rank in worlds[2]:
                _close(rank[f"grads_{dp}_{accum}"], ref, GRAD_TOL)


# ---- 5. model state

@pytest.mark.parametrize("dp", MODES)
def test_model_state_is_synced_in_every_mode(worlds, dp):
    """The deep MLP's EMA state through every mode at W = 2 with
    grad_accum_steps 2: equal on both ranks, the counter advanced once per
    micro-batch, and the running value equal to the reference's sync-BN
    average (psum and fsdp: the mean over ranks; ordered: the blocks'
    states in block order), under SGD (Adam's normalisation would turn
    the libraries' ulp differences in this model's near-zero bias
    gradients into drift of up to lr a step)."""
    got = [rank[f"state_{dp}"] for rank in worlds[2]]
    assert _equal(got[0]["buffers"], got[1]["buffers"])
    assert got[0]["buffers"]["count"].item() == 16
    (ref_params, ref_state), _, _ = _ref_run(
        2, loss=_ref_deep_sloss, init=_ref_deep_sinit, dp=dp, steps=8,
        log_every=0, data=w.deep_batches(8), state=True, grad_accum_steps=2,
        opt=optax.sgd(0.1))
    assert int(ref_state["count"]) == 16
    np.testing.assert_allclose(got[0]["buffers"]["running"].numpy(),
                               np.asarray(ref_state["running"]), rtol=1e-5)
    _close(got[0]["params"], ref_params, TOL)


# ---- 6. elastic resume

def test_elastic_resume_onto_the_survivors(worlds, tmp_path):
    """W = 4 runs 10 steps (durable checkpoints at 4 and 8; the save at 10
    is lost with the job), then the survivors of ``survivor_configs(4,
    [1, 3])`` resume at W = 2 from step 8: the ordered trajectory equals
    the uninterrupted run bit for bit, and ``replayed_steps`` equals the
    reference's for the same schedule (its 8-device mesh, then 4)."""
    survivors = survivor_configs(4, [1, 3])
    assert [(old, c.process_id, c.num_processes) for old, c in survivors] == [
        (old, c.process_id, c.num_processes)
        for old, c in ref_survivors(4, [1, 3])] == [(0, 0, 2), (2, 1, 2)]
    a, b = worlds[4][0]["elastic_a"], worlds[2][0]["elastic_b"]
    assert a["steps_completed"] == 10 and a["replayed_steps"] == 0
    assert b["resumed_from_step"] == 8 and b["steps_completed"] == 16
    assert _equal(b["params"], worlds[1][0]["ordered"]["params"])
    assert _equal(worlds[2][1]["elastic_b"]["params"], b["params"])

    import orbax.checkpoint as ocp
    import shutil

    ckpt = str(tmp_path / "ref")
    data = w.batches(16)
    _ref_run(8, data=data[:10], ckpt=ckpt, checkpoint_every=4, log_every=0)
    shutil.rmtree(os.path.join(ckpt, "10"))
    assert ocp.CheckpointManager(ckpt).latest_step() == 8
    _, ref_b, _ = _ref_run(4, data=data[8:], ckpt=ckpt, checkpoint_every=4,
                           log_every=0)
    assert b["replayed_steps"] == ref_b.replayed_steps == 2
    assert b["resumed_from_step"] == ref_b.resumed_from_step


# ---- 7. the short tail

def test_short_tail_is_padded_and_weighted_out(worlds):
    """A last batch of 62 rows at W = 4: padded to 64 with the validity
    mask (the last rank holds 14 real rows and 2 zero rows) and weighted
    out by ``masked_mean``; the run lands where the reference lands when
    its psum_bucketed loop is fed ``shard_batch``'s padded batch."""
    got = worlds[4][0]["tail"]
    assert got["steps_completed"] == 3
    tail = worlds["tail"]
    padded = {k: np.asarray(v) for k, v in
              ref_shard_batch(tail[2], _ref_mesh(4)).items()}
    assert padded["__valid__"].sum() == TAIL_ROWS
    # The reference loop keys its input shardings by the first batch, so
    # its full batches carry an all-ones mask (the same masked mean).
    full = [{**b, "__valid__": np.ones(w.BATCH, np.float32)} for b in tail[:2]]
    ref, _, hist = _ref_run(4, loss=_ref_masked_loss, dp="psum_bucketed",
                            steps=3, window=1, log_every=1,
                            data=[*full, padded], opt=optax.sgd(0.1))
    _close(got["params"], ref, TOL)
    np.testing.assert_allclose([v[1] for v in got["hist"]],
                               [v[1] for v in hist], rtol=1e-5)


# ---- 8. mode validation

def _one_process(**kw):
    return train_loop(
        loss_fn=w.mlp_loss, init_params_fn=w.mlp_init,
        optimizer=lambda p: torch.optim.Adam(p, lr=0.05),
        train_iter=iter(w.batches(4)),
        config=TrainLoopConfig(train_steps=4, batch_size=w.BATCH,
                               log_every=0, window_steps=2, **kw),
        device="cpu")


def test_dp_collective_validation_and_env(monkeypatch):
    """The reference's ``test_dp_collective_validation_and_env`` on a mesh
    of one process."""
    with pytest.raises(ValueError, match="expected one of"):
        _one_process(dp_collective="ring")
    with pytest.raises(ValueError, match="dp_grad_blocks"):
        _one_process(dp_collective="ordered", dp_grad_blocks=5)
    _, result = _one_process(dp_collective="ordered", grad_accum_steps=2)
    assert result.steps_completed == 4
    with pytest.raises(ValueError, match="fsdp"):
        _one_process(dp_collective="ordered", param_partition={"w1": ("data",)})
    with pytest.raises(ValueError, match="'data' axis only"):
        _one_process(dp_collective="fsdp", param_partition={"w1": ("model",)})
    with pytest.raises(ValueError, match="not divisible by grad_accum_steps 3"):
        _one_process(dp_collective="psum_bucketed", grad_accum_steps=3)
    with pytest.raises(NotImplementedError, match="A6"):
        _one_process(dp_collective="psum_bucketed",
                     batch_partition={"x": ("data", "seq")})

    monkeypatch.setenv("TPP_DP_COLLECTIVE", "ordered")
    assert effective_dp_collective(TrainLoopConfig(train_steps=1)) == "ordered"
    assert effective_dp_collective(
        TrainLoopConfig(train_steps=1, dp_collective="auto")) == ""
    _, result = _one_process()
    assert result.dp_collective == "ordered"
    monkeypatch.delenv("TPP_DP_COLLECTIVE")
    _, result = _one_process(dp_collective="ordered")
    assert result.dp_collective == "ordered"
    assert result.step_capture == "eager: the CPU captures nothing"


# ---- 9. the slice as a whole

def test_bert_run_fn_at_two_ranks_matches_the_reference(worlds):
    """BERT-small through ``bert_module.run_fn`` with ``mesh_config
    {"data": 2}`` in psum_bucketed, each rank reading its half of the
    train split (``per_host_input_config``: one of the two shard files,
    8 rows a step), from a base model converted from the reference's flax
    init; against the reference's ``train_loop`` with its BERT and the
    reference trainer module's loss and AdamW on a 2-device mesh, fed the
    global batches (rank 0's rows, then rank 1's).  The losses are held at
    BERT_LOSS_ATOL and the parameters' changes from the shared init at
    BERT_CHANGE_GAP; a reference run whose ranks both read shard 0 fails
    both, so neither limit lets a rank's wrong rows through."""
    from tpu_pipelines.models.bert import build_bert_model as ref_build_bert
    from tpu_pipelines_torch.data.input_pipeline import (
        BatchIterator,
        InputConfig,
        per_host_input_config,
    )
    from tpu_pipelines_torch.models.convert import bert_state_dict_from_flax
    from tpu_pipelines_torch.trainer.export import load_exported_model

    got = worlds[2][0]["bert"]
    assert got["dp_collective"] == "psum_bucketed"
    assert got["steps_completed"] == BERT_STEPS
    assert worlds[2][1]["bert"]["losses"] == got["losses"]
    examples = os.path.join(worlds["root"], "examples")
    local = BERT_HP["batch_size"] // 2
    streams = [iter(BatchIterator(examples, "train", per_host_input_config(
        InputConfig(batch_size=local, shuffle=True, seed=0),
        process_index=r, process_count=2))) for r in range(2)]
    global_batches = [
        {k: np.concatenate([a[k], b[k]]) for k in a}
        for a, b in zip(*(list(next(s) for _ in range(BERT_STEPS)) for s in streams))]

    model = ref_build_bert(BERT_HP)

    def loss_fn(params, batch, rng):
        logits = model.apply(
            {"params": params}, {k: v for k, v in batch.items() if k != "label"},
            deterministic=False, rngs={"dropout": rng})
        labels = jnp.asarray(batch["label"], jnp.int32)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean(), {}

    def reference(global_batches):
        hist = []
        params, _ = ref_train_loop(
            loss_fn=loss_fn, init_params_fn=lambda rng, b: worlds["flax"],
            optimizer=optax.adamw(BERT_HP["learning_rate"]),
            train_iter=iter(global_batches),
            config=RefConfig(train_steps=BERT_STEPS,
                             batch_size=BERT_HP["batch_size"], log_every=1,
                             window_steps=1, prng_impl=None,
                             dp_collective="psum_bucketed"),
            mesh=_ref_mesh(2),
            metrics_cb=lambda s, m: hist.append((s, float(m["loss"]))),
        )
        return (bert_state_dict_from_flax(jax.tree.map(np.asarray, params)),
                [v for _, v in hist])

    init = bert_state_dict_from_flax(worlds["flax"])
    port = load_exported_model(os.path.join(worlds["root"], "bert", "model"),
                               device="cpu").params
    want, want_losses = reference(global_batches)
    assert [s for s, _ in got["losses"]] == [1, 2, 3]
    losses = [v for _, v in got["losses"]]
    assert sorted(port) == sorted(want)
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=BERT_LOSS_ATOL)
    gap = param_change_gap(port, want, init)
    assert gap <= BERT_CHANGE_GAP, gap

    # The same checks would fail a run whose ranks both read shard 0.
    shard0 = [{k: np.concatenate([v[:local]] * 2) for k, v in gb.items()}
              for gb in global_batches]
    wrong, wrong_losses = reference(shard0)
    assert np.abs(np.subtract(losses, wrong_losses)).max() > BERT_LOSS_ATOL
    assert param_change_gap(port, wrong, init) > BERT_CHANGE_GAP
