"""The MoE experts' ff dim over ``model`` (ROADMAP.md A6c) on the CPU over
gloo (tests/torch_t5_moe_worker.py, four ranks, one CPU thread a rank),
against the reference on its virtual 8-device CPU mesh with its expert
rules: on data = 2 x model = 2, and on expert = 2 x model = 2, where a
rank holds ``wi [E/2, d, ff/2]`` and ``wo [E/2, ff/2, d]``.

Tolerances (f32 compute on both sides):

  - the MoE block (4 experts, capacity factor 8, every token kept):
    2e-5 on the output and 1e-6 on the aux loss, 2e-4 on the gradients
    (tests/test_torch_moe.py's: two libraries' f32 products, and the
    partial outputs summed over ranks in another order than one einsum),
    each rank's expert gradients its own slice of the reference's;
  - a tiny BERT-MoE (4 experts on the odd layers) through three SGD steps
    of ``train_loop`` with ``bert_partition_rules``: the losses and the
    gathered parameters at rtol 1e-4, atol 1e-5 (as
    tests/test_torch_tensor_parallel.py), each step's aux loss at 1e-6
    (f32 means of about 1, summed in another order), with the
    reference's objective task + 0.01 x aux on both meshes: on data = 2
    the aux loss's token means are the whole batch's (summed over
    ``data``), as the reference's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import torch_dp_worker as w
from tpu_pipelines.models import bert as ref_bert
from tpu_pipelines.models.transformer import MoEMlpBlock as RefMoE
from tpu_pipelines.models.transformer import apply_with_moe_aux as ref_aux
from tpu_pipelines.parallel import partition as ref_part
from tpu_pipelines.trainer import TrainLoopConfig as RefConfig
from tpu_pipelines.trainer import train_loop as ref_train_loop
from tpu_pipelines_torch.models.convert import bert_state_dict_from_flax

TINY = {"vocab_size": 64, "d_model": 64, "n_layers": 2, "n_heads": 4,
        "d_ff": 128, "max_len": 16, "dropout_rate": 0.0, "num_classes": 2,
        "attn_impl": "dense", "moe_experts": 4}
F32_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
TOL = dict(rtol=1e-4, atol=1e-5)
AUX_TOL = dict(rtol=0, atol=1e-6)
STEPS = 3
LR = 0.1
MESHES = {"model": {"data": 2, "model": 2},
          "expert_model": {"data": 1, "model": 2, "expert": 2}}
AUX = 0.01


def _ref_mesh(data=1, model=1, expert=1):
    devs = np.array(jax.devices()[:data * model * expert]).reshape(
        data, model, 1, expert, 1)
    return Mesh(devs, ("data", "model", "seq", "expert", "pipe"))


def _block():
    block = RefMoE(num_experts=4, d_ff=32, capacity_factor=8.0, dtype=jnp.float32)
    x = np.random.default_rng(5).normal(size=(4, 8, 16)).astype(np.float32)
    params = jax.tree.map(np.asarray,
                          block.init(jax.random.key(0), jnp.asarray(x))["params"])
    return block, params, x


def _block_state(params):
    return {"router.weight": torch.from_numpy(params["router"]["kernel"].T.copy()),
            "router.bias": torch.from_numpy(params["router"]["bias"].copy()),
            "wi": torch.from_numpy(np.array(params["wi"])),
            "wo": torch.from_numpy(np.array(params["wo"]))}


def _bert_batch(b=8, l=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(4, 64, size=(b, l)).astype(np.int32),
            "attention_mask": np.ones((b, l), np.int32),
            "label": rng.integers(0, 2, size=(b,)).astype(np.int32)}


def _features(batch):
    return {k: v for k, v in batch.items() if k != "label"}


def _ref_bert():
    enc = ref_bert.BertEncoder(
        vocab_size=TINY["vocab_size"], d_model=TINY["d_model"],
        n_layers=TINY["n_layers"], n_heads=TINY["n_heads"], d_ff=TINY["d_ff"],
        max_len=TINY["max_len"], dropout_rate=0.0, dtype=jnp.float32,
        moe_experts=TINY["moe_experts"])
    return ref_bert.BertClassifier(encoder=enc, num_classes=TINY["num_classes"],
                                   dropout_rate=0.0)


def _ref_train(params, batches, mesh, aux_weight):
    model = _ref_bert()

    def loss_fn(p, b, rng):
        logits, aux = ref_aux(model, {"params": p}, _features(b))
        task = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(b["label"], jnp.int32)).mean()
        return task + aux_weight * aux, {"moe_aux": aux}

    hist = []
    out, _ = ref_train_loop(
        loss_fn=loss_fn, init_params_fn=lambda rng, b: params,
        optimizer=optax.sgd(LR), train_iter=iter(batches),
        config=RefConfig(train_steps=STEPS, batch_size=len(batches[0]["label"]),
                         log_every=1, window_steps=1, prng_impl=None,
                         param_partition=ref_part.make_param_partition(
                             params, ref_bert.bert_partition_rules())),
        mesh=mesh, metrics_cb=lambda s, m: hist.append(
            (s, float(m["loss"]), float(m["moe_aux"]))))
    return bert_state_dict_from_flax(jax.tree.map(np.asarray, out)), hist


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("moetp"))
    _, block_params, x = _block()
    batches = [_bert_batch(seed=s) for s in range(STEPS)]
    params = jax.tree.map(np.asarray, _ref_bert().init(
        jax.random.key(1), _features(batches[0]))["params"])
    state = bert_state_dict_from_flax(params)
    four = w.spawn(4, [
        *[(f"block_{name}", "torch_t5_moe_worker:moe_block",
           {"state": _block_state(block_params), "x": x, "capacity_factor": 8.0,
            "mesh_config": mesh}) for name, mesh in MESHES.items()],
        *[(f"bert_{name}", "torch_t5_moe_worker:bert_moe_train",
           {"hp": TINY, "state": state, "batches": batches, "steps": STEPS,
            "lr": LR, "mesh_config": mesh, "aux_weight": AUX})
          for name, mesh in MESHES.items()],
    ], os.path.join(root, "w4"))
    return {"block_params": block_params, "x": x, "params": params,
            "batches": batches, 4: four}


@pytest.mark.parametrize("name", list(MESHES))
def test_moe_block_with_its_ff_dim_over_model_matches_the_reference(ranks, name):
    """Every rank gives the reference block's output and aux loss, the
    gradients of x and the router whole, and its slice of the experts'
    gradients: experts [e E/2, (e+1) E/2) over expert (all 4 off it),
    columns [m ff/2, (m+1) ff/2) over model."""
    block, params, x = _block()[0], ranks["block_params"], ranks["x"]

    def total(p, xs):
        out, state = block.apply({"params": p}, xs, mutable=["losses"])
        return out.sum(), (out, jax.tree_util.tree_leaves(state["losses"])[0])

    (_, (out, aux)), (g_p, g_x) = jax.value_and_grad(total, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    e_n = 2 if "expert" in MESHES[name] else 1
    for rank in ranks[4]:
        got = rank[f"block_{name}"]
        e, m = got["expert"], got["model"]
        k, f = 4 // e_n, params["wi"].shape[2] // 2
        assert got["wi_shape"] == (k, 16, f)
        np.testing.assert_allclose(got["out"].numpy(), np.asarray(out), **F32_TOL)
        np.testing.assert_allclose(float(got["aux"]), float(aux), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["dx"].numpy(), np.asarray(g_x), **GRAD_TOL)
        np.testing.assert_allclose(got["grads"]["router.weight"].numpy(),
                                   np.asarray(g_p["router"]["kernel"]).T, **GRAD_TOL)
        wi = np.asarray(g_p["wi"])[e * k:(e + 1) * k, :, m * f:(m + 1) * f]
        wo = np.asarray(g_p["wo"])[e * k:(e + 1) * k, m * f:(m + 1) * f, :]
        np.testing.assert_allclose(got["grads"]["wi"].numpy(), wi, **GRAD_TOL)
        np.testing.assert_allclose(got["grads"]["wo"].numpy(), wo, **GRAD_TOL)


@pytest.mark.parametrize("name", list(MESHES))
def test_bert_moe_train_loop_with_expert_rules_matches_the_reference(ranks, name):
    """Three SGD steps of a tiny BERT-MoE through ``train_loop`` with
    ``bert_partition_rules`` (the experts over ``expert`` and their ff dim
    over ``model``): every rank reports the reference's losses on its
    mesh, and the model the loop returns (gathered whole over both axes)
    holds the reference's parameters.  The aux loss each step reports is
    the reference's, the whole batch's on data = 2."""
    mesh = MESHES[name]
    want, want_hist = _ref_train(ranks["params"], ranks["batches"],
                                 _ref_mesh(mesh["data"], mesh["model"],
                                           mesh.get("expert", 1)), AUX)
    e_n = mesh.get("expert", 1)
    for rank in ranks[4]:
        got = rank[f"bert_{name}"]
        assert got["wi"] == (4 // e_n, TINY["d_model"], TINY["d_ff"] // 2)
        np.testing.assert_allclose([l for _, l, _ in got["hist"]],
                                   [l for _, l, _ in want_hist], **TOL)
        np.testing.assert_allclose([a for _, _, a in got["hist"]],
                                   [a for _, _, a in want_hist], **AUX_TOL)
        assert set(got["params"]) == set(want)
        for n, p in want.items():
            np.testing.assert_allclose(got["params"][n].numpy(), p.numpy(), **TOL,
                                       err_msg=n)
