"""The Switch mixture-of-experts MLP (ROADMAP.md A6a): the port's
``MoEMlpBlock`` and MoE BERT against the reference's
(``tpu_pipelines/models/transformer.py``, ``models/bert.py``) with
converted weights, and expert parallelism over two gloo processes
(tests/torch_sp_worker.py) against one process: the cases of
tests/test_moe.py.

Tolerances:
  - the f32 block: 2e-5 on the output and 1e-6 on the aux loss (the
    reference test's; two libraries' f32 products in other orders) with
    the same experts chosen and the same tokens dropped;
  - MoE BERT in bf16: 5e-2 on logits of magnitude ~1 (as tests/
    test_torch_bert.py: the frameworks round bf16 products at different
    places); the aux loss 1e-2;
  - expert parallelism against one process, f32: 2e-5 on the output and
    2e-4 on the gradients (the reference's EP tests: the partial outputs
    summed by an all-reduce in another order than one einsum), and 1e-5
    on the parameters of a BERT-MoE after two SGD steps through
    ``train_loop``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worker as w
from tpu_pipelines.models import bert as ref_bert
from tpu_pipelines.models.transformer import MoEMlpBlock as RefMoE
from tpu_pipelines.models.transformer import apply_with_moe_aux as ref_aux
from tpu_pipelines_torch.models import bert as port_bert
from tpu_pipelines_torch.models.convert import bert_state_dict_from_flax
from tpu_pipelines_torch.models.transformer import MoEMlpBlock, apply_with_moe_aux

F32_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=0, atol=5e-2)
TINY = {"vocab_size": 64, "d_model": 16, "n_layers": 2, "n_heads": 2,
        "d_ff": 32, "max_len": 16, "dropout_rate": 0.0, "num_classes": 2,
        "attn_impl": "dense", "moe_experts": 4}


def _ref_block(e=4, ff=16, cap=8.0, d=8, seed=0, x_shape=(2, 6)):
    block = RefMoE(num_experts=e, d_ff=ff, capacity_factor=cap, dtype=jnp.float32)
    x = np.random.default_rng(seed).normal(size=(*x_shape, d)).astype(np.float32)
    params = jax.tree.map(np.asarray,
                          block.init(jax.random.key(0), jnp.asarray(x))["params"])
    return block, params, x


def _state(params):
    return {"router.weight": torch.from_numpy(params["router"]["kernel"].T.copy()),
            "router.bias": torch.from_numpy(params["router"]["bias"].copy()),
            "wi": torch.from_numpy(params["wi"]), "wo": torch.from_numpy(params["wo"])}


def _port_block(params, cap, mesh=None):
    e, d, ff = params["wi"].shape
    block = MoEMlpBlock(d, e, ff, capacity_factor=cap, dtype=torch.float32, mesh=mesh)
    block.load_state_dict(_state(params))
    return block


@pytest.mark.parametrize("cap,shape", [(8.0, (2, 6)), (0.1, (1, 20)), (1.25, (4, 16))],
                         ids=["all-kept", "tiny-capacity", "switch-default"])
def test_block_matches_the_reference(cap, shape):
    """Output, dropped tokens and the aux loss of the block with the
    reference's weights; with capacity 0.1 at most one token an expert
    survives (the reference's drop test)."""
    block, params, x = _ref_block(cap=cap, x_shape=shape, e=4 if cap != 0.1 else 2)
    out, state = block.apply({"params": params}, jnp.asarray(x), mutable=["losses"])
    (want_aux,) = jax.tree_util.tree_leaves(state["losses"])
    port = _port_block(params, cap)
    losses = []
    got = port(torch.from_numpy(x), losses=losses)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **F32_TOL)
    np.testing.assert_allclose(float(losses[0].detach()), float(want_aux),
                               rtol=0, atol=1e-6)
    kept = (np.abs(got.detach().numpy()).sum(-1) > 1e-9)
    assert (kept == (np.abs(np.asarray(out)).sum(-1) > 1e-9)).all()
    routing = port.routing(torch.from_numpy(x))
    assert int(routing["tokens_per_expert"].sum()) == x.shape[0] * x.shape[1]
    if cap == 0.1:
        assert kept.sum() <= 2
    if cap == 8.0:
        assert kept.all() and float(routing["kept_share"]) == 1.0
    assert 1.0 <= float(losses[0].detach()) <= params["wi"].shape[0]


def test_expert_init_variance_matches_dense():
    """Per-expert fan-in init: std within 15% of the dense kernel's
    1/sqrt(d_model), as the reference's (a fan over the stacked expert dim
    would shrink it sqrt(e))."""
    block = MoEMlpBlock(128, 8, 256, capacity_factor=2.0)
    block.reset_parameters(torch.Generator().manual_seed(0))
    ref_block = RefMoE(num_experts=8, d_ff=256, capacity_factor=2.0, dtype=jnp.float32)
    ref_wi = np.asarray(ref_block.init(jax.random.key(0), jnp.zeros((2, 4, 128)))
                        ["params"]["wi"])
    dense_std = 1.0 / np.sqrt(128)
    for std in (float(block.wi.std()), float(ref_wi.std())):
        assert abs(std - dense_std) / dense_std < 0.15, std
    assert abs(float(block.wo.std()) - 1 / 16) / (1 / 16) < 0.15
    assert float(block.wi.abs().max()) <= 2 * dense_std / 0.87962566103423978 + 1e-6


def _bert_batch(b=8, l=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(4, 64, size=(b, l)).astype(np.int32),
            "attention_mask": np.ones((b, l), np.int32),
            "label": rng.integers(0, 2, size=(b,)).astype(np.int32)}


def test_bert_with_moe_layers_matches_the_reference():
    """``moe_experts`` puts the MoE MLP on the odd layers only; the port's
    bf16 classifier with the reference's weights gives its logits and aux
    loss (0 for a BERT without experts)."""
    data = _bert_batch()
    feats = {k: v for k, v in data.items() if k != "label"}
    ref_model = ref_bert.build_bert_model(TINY)
    params = jax.tree.map(np.asarray, ref_model.init(jax.random.key(0), feats)["params"])
    assert "moe" in params["encoder"]["layer_1"] and "mlp" in params["encoder"]["layer_0"]
    want, want_aux = ref_aux(ref_model, {"params": params}, feats)

    model = port_bert.build_bert_model(TINY)
    model.load_state_dict(bert_state_dict_from_flax(params))
    model.eval()
    got, aux = apply_with_moe_aux(model, {k: torch.from_numpy(v) for k, v in feats.items()})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **BF16_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=0, atol=1e-2)
    _, plain = apply_with_moe_aux(port_bert.build_bert_model({**TINY, "moe_experts": 0}),
                                  {k: torch.from_numpy(v) for k, v in feats.items()})
    assert float(plain) == 0.0



def test_bert_with_moe_layers_trains():
    """The reference's ``test_bert_with_moe_layers_trains``: a
    ``train_loop`` run with task + 0.01 x aux reports ``moe_aux`` >= 1
    (the aux loss flowed) and finite losses."""
    import torch_sp_worker as sp

    got = sp.bert_moe_train(TINY, [_bert_batch()] * 2, None, 2)
    assert [s for s, _, _ in got["hist"]] == [1, 2]
    assert all(np.isfinite(l) and a >= 1.0 for _, l, a in got["hist"])


@pytest.fixture(scope="module")
def two_experts(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ep"))
    _, params, x = _ref_block(seed=5, x_shape=(4, 8))
    data = [_bert_batch(seed=s) for s in range(2)]
    ranks = w.spawn(2, [
        ("block", "torch_sp_worker:moe_ep",
         {"state": _state(params), "x": x, "capacity_factor": 8.0}),
        ("tight", "torch_sp_worker:moe_ep",
         {"state": _state(params), "x": x, "capacity_factor": 1.0}),
        ("bert", "torch_sp_worker:bert_moe_train",
         {"hp": TINY, "batches": data, "mesh_config": {"data": 1, "expert": 2},
          "steps": 2}),
        ("nudged", "torch_sp_worker:bert_moe_train",
         {"hp": TINY, "batches": data, "mesh_config": {"data": 1, "expert": 2},
          "steps": 2, "nudge": True}),
    ], os.path.join(root, "w2"))
    return {"ranks": ranks, "params": params, "x": x, "data": data}


@pytest.mark.parametrize("name,cap", [("block", 8.0), ("tight", 1.0)])
def test_expert_parallel_matches_one_process(two_experts, name, cap):
    """Two ranks of two experts each (the whole batch on both): the output
    and aux loss of one process on both ranks, the gradients of x and the
    router whole and equal on both, each expert's gradient whole on its
    rank (tests/test_moe.py's EP output and gradient tests)."""
    params, x = two_experts["params"], two_experts["x"]
    one = _port_block(params, cap)
    xs = torch.from_numpy(x).requires_grad_()
    losses = []
    out = one(xs, losses=losses)
    out.sum().backward()
    for r, rank in enumerate(two_experts["ranks"]):
        got = rank[name]
        assert got["first_expert"] == 2 * r
        np.testing.assert_allclose(got["out"].numpy(), out.detach().numpy(), **F32_TOL)
        assert float(got["aux"]) == float(losses[0])
        np.testing.assert_allclose(got["dx"].numpy(), xs.grad.numpy(), **GRAD_TOL)
        for n in ("router.weight", "router.bias"):
            np.testing.assert_allclose(got["grads"][n].numpy(),
                                       dict(one.named_parameters())[n].grad.numpy(),
                                       **GRAD_TOL)
        for n in ("wi", "wo"):
            want = getattr(one, n).grad[2 * r:2 * r + 2]
            np.testing.assert_allclose(got["grads"][n].numpy(), want.numpy(), **GRAD_TOL)
    # Each rank's expert gradients are its own experts', not another's.
    partial = two_experts["ranks"][0][name]["grads"]["wi"]
    assert not np.allclose(partial.numpy(), one.wi.grad[2:4].numpy(), **GRAD_TOL)


def test_expert_parallel_train_loop_matches_one_process(two_experts):
    """BERT-MoE through ``train_loop`` on ``expert`` = 2: both ranks report
    one process's losses and return its whole model (the loop gathers the
    experts), after two SGD steps."""
    import torch_sp_worker as sp

    one = sp.bert_moe_train(TINY, two_experts["data"], None, 2)
    for rank in two_experts["ranks"]:
        got = rank["bert"]
        np.testing.assert_allclose([l for _, l, _ in got["hist"]],
                                   [l for _, l, _ in one["hist"]], rtol=1e-5, atol=1e-5)
        assert sorted(got["params"]) == sorted(one["params"])
        for n, p in one["params"].items():
            np.testing.assert_allclose(got["params"][n].float().numpy(),
                                       p.float().numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=n)


def test_expert_ranks_hold_one_copy_of_the_shared_parameters(two_experts):
    """The shared gradients are averaged over ``expert``: where one rank's
    type-embedding gradient comes out apart from the other's (``nudge``),
    both ranks still end with the same parameters bit for bit, and the
    nudge moved them (so the ranks route every token alike)."""
    r0, r1 = (rank["nudged"] for rank in two_experts["ranks"])
    for n, p in r0["params"].items():
        assert torch.equal(p, r1["params"][n]), n
    assert r0["hist"] == r1["hist"]
    plain = two_experts["ranks"][0]["bert"]["params"]["encoder.type_embed.weight"]
    assert not torch.equal(r0["params"]["encoder.type_embed.weight"], plain)
