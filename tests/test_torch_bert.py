"""Port parity: BERT with converted weights, PyTorch vs JAX, on the CPU.

A tiny geometry (2 layers, d_model 64, 4 heads of 16, L=16) with a ragged
padding mask.  The flax params are initialised by JAX, converted with
``bert_state_dict_from_flax`` and loaded strictly into the port's module;
both sides then run the same numpy batch.  The JAX flash path runs the
Pallas kernel in interpret mode.

Tolerances:
  - f32 encoder: 2e-5 (the reference suite's f32 forward tolerance) —
    both sides compute every product in f32 and differ only in the order
    of sums, through two layers and the head;
  - bf16 encoder (``build_bert_model``): 5e-2 on logits of magnitude ~1 —
    the two frameworks round the bf16 products, adds and casts at
    different places (fused bias add, gather-then-cast), a few bf16 steps
    (2^-8 relative) per layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pipelines.models import bert as jax_bert
from tpu_pipelines_torch.models import bert as port_bert
from tpu_pipelines_torch.models.convert import bert_state_dict_from_flax

TINY = {
    "vocab_size": 64, "d_model": 64, "n_layers": 2, "n_heads": 4,
    "d_ff": 128, "max_len": 32, "dropout_rate": 0.0, "num_classes": 3,
}
F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=0, atol=5e-2)


def _batch(lengths=(16, 10, 5, 1), l=16, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lengths), l), np.int32)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(1, TINY["vocab_size"], size=n)
    return {"input_ids": ids, "attention_mask": (ids > 0).astype(np.int32)}


def _numpy_tree(params):
    return jax.tree.map(np.asarray, params)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_f32_classifier(attn_impl):
    encoder = jax_bert.BertEncoder(
        vocab_size=TINY["vocab_size"], d_model=TINY["d_model"],
        n_layers=TINY["n_layers"], n_heads=TINY["n_heads"],
        d_ff=TINY["d_ff"], max_len=TINY["max_len"], dropout_rate=0.0,
        dtype=jnp.float32, attn_impl=attn_impl,
    )
    return jax_bert.BertClassifier(
        encoder=encoder, num_classes=TINY["num_classes"], dropout_rate=0.0
    )


def _port_f32_classifier(attn_impl):
    encoder = port_bert.BertEncoder(
        vocab_size=TINY["vocab_size"], d_model=TINY["d_model"],
        n_layers=TINY["n_layers"], n_heads=TINY["n_heads"],
        d_ff=TINY["d_ff"], max_len=TINY["max_len"], dropout_rate=0.0,
        dtype=torch.float32, attn_impl=attn_impl,
    )
    return port_bert.BertClassifier(
        encoder, num_classes=TINY["num_classes"], dropout_rate=0.0
    )


def _run_port(model, params, batch):
    model.load_state_dict(bert_state_dict_from_flax(params), strict=True)
    model.eval()
    with torch.inference_mode():
        return model(_torch_batch(batch)).numpy()


@pytest.mark.parametrize("attn_impl", ["flash", "dense"])
def test_classifier_f32_matches_jax(attn_impl):
    batch = _batch()
    jmodel = _jax_f32_classifier(attn_impl)
    params = _numpy_tree(jmodel.init(jax.random.key(0), batch)["params"])
    want = np.asarray(jmodel.apply({"params": params}, batch))
    got = _run_port(_port_f32_classifier(attn_impl), params, batch)
    assert got.shape == (4, TINY["num_classes"]) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("attn_impl", ["flash", "dense"])
def test_classifier_bf16_matches_jax(attn_impl):
    hp = {**TINY, "attn_impl": attn_impl}
    batch = _batch(seed=1)
    jmodel = jax_bert.build_bert_model(hp)
    params = _numpy_tree(jmodel.init(jax.random.key(1), batch)["params"])
    want = np.asarray(jmodel.apply({"params": params}, batch))
    port = port_bert.build_bert_model(hp)
    assert port.encoder.dtype == torch.bfloat16
    got = _run_port(port, params, batch)
    np.testing.assert_allclose(got, want, **BF16_TOL)


def test_mlm_head_f32_matches_jax():
    batch = _batch(seed=2)
    jencoder = _jax_f32_classifier("dense").encoder
    jmodel = jax_bert.BertMLMHead(encoder=jencoder)
    params = _numpy_tree(jmodel.init(jax.random.key(2), batch)["params"])
    want = np.asarray(jmodel.apply({"params": params}, batch))
    port = port_bert.BertMLMHead(_port_f32_classifier("dense").encoder)
    got = _run_port(port, params, batch)
    assert got.shape == (4, 16, TINY["vocab_size"])
    np.testing.assert_allclose(got, want, **F32_TOL)


def _flax_from_state_dict(sd, n_layers):
    """Independent inverse of the converter's layouts, for the round trip."""
    def dense(prefix):
        return {"kernel": sd[f"{prefix}.weight"].T, "bias": sd[f"{prefix}.bias"]}

    def norm(prefix):
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    enc = {
        name: {"embedding": sd[f"encoder.{name}.weight"]}
        for name in ("embed", "pos_embed", "type_embed")
    }
    enc["embed_norm"] = norm("encoder.embed_norm")
    for i in range(n_layers):
        p = f"encoder.layers.{i}"
        attn = {}
        for proj in ("query", "key", "value"):
            w = sd[f"{p}.attn.{proj}.weight"].T           # [d_model, H*Dh]
            attn[proj] = {
                "kernel": w.reshape(w.shape[0], TINY["n_heads"], -1),
                "bias": sd[f"{p}.attn.{proj}.bias"].reshape(TINY["n_heads"], -1),
            }
        w = sd[f"{p}.attn.out.weight"].T                    # [H*Dh, d_model]
        attn["out"] = {
            "kernel": w.reshape(TINY["n_heads"], -1, w.shape[-1]),
            "bias": sd[f"{p}.attn.out.bias"],
        }
        enc[f"layer_{i}"] = {
            "attn": attn,
            "attn_norm": norm(f"{p}.attn_norm"),
            "mlp": {"wi": dense(f"{p}.mlp.wi"), "wo": dense(f"{p}.mlp.wo")},
            "mlp_norm": norm(f"{p}.mlp_norm"),
        }
    return {"encoder": enc, "pooler": dense("pooler"), "head": dense("head")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converter_round_trips_flax_tree_exactly(dtype):
    jmodel = jax_bert.build_bert_model(TINY)
    params = jmodel.init(jax.random.key(3), _batch())["params"]
    params = _numpy_tree(jax.tree.map(lambda x: x.astype(dtype), params))
    sd = bert_state_dict_from_flax(params)
    port = port_bert.build_bert_model(TINY)
    assert set(sd) == set(port.state_dict())        # every tensor, once
    for name, t in port.state_dict().items():
        assert sd[name].shape == t.shape, name
        assert sd[name].dtype == getattr(torch, dtype), name

    def bits(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()

    back = _flax_from_state_dict(
        {k: bits(v) for k, v in sd.items()}, TINY["n_layers"]
    )
    want = jax.tree.map(
        lambda x: x.view(np.int16) if x.dtype.name == "bfloat16" else x,
        params,
    )
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_back) == len(flat_want)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(leaf, flat_want[path])


def test_init_bert_weights_is_seeded():
    a = port_bert.init_bert_weights(
        port_bert.build_bert_model(TINY), torch.Generator().manual_seed(7)
    )
    b = port_bert.init_bert_weights(
        port_bert.build_bert_model(TINY), torch.Generator().manual_seed(7)
    )
    for (name, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), name
    assert torch.all(a.encoder.embed_norm.weight == 1)
    assert torch.all(a.pooler.bias == 0)
    assert 0.015 < float(a.encoder.embed.weight.detach().std()) < 0.025


def test_unported_options_raise():
    """"ring", "ulysses" and ``moe_experts`` were refused until A6a: on a
    mesh of one process ring and Ulysses are dense attention (the
    reference's ``n == 1`` branch), bit for bit, and ``moe_experts`` puts
    an MoE MLP on the odd layers.  T5 on a seq mesh, refused until A6c,
    builds, and without a split sequence it computes what one process
    computes (tests/test_torch_t5_parallel.py trains it on two ranks).
    An unknown attention raises."""
    from tpu_pipelines_torch.models.t5 import build_t5_model
    from tpu_pipelines_torch.parallel.mesh import DeviceMesh, make_mesh

    batch = _torch_batch(_batch())
    mesh = make_mesh(device="cpu")
    dense = port_bert.init_bert_weights(
        port_bert.build_bert_model({**TINY, "attn_impl": "dense"}),
        torch.Generator().manual_seed(7)).eval()
    for impl in ("ring", "ulysses"):
        model = port_bert.build_bert_model({**TINY, "attn_impl": impl}, mesh=mesh)
        model.load_state_dict(dense.state_dict())
        assert torch.equal(model.eval()(batch), dense(batch))
    moe = port_bert.build_bert_model({**TINY, "moe_experts": 2})
    assert hasattr(moe.encoder.layers[1], "moe") and hasattr(moe.encoder.layers[0], "mlp")
    assert tuple(moe.encoder.layers[1].moe.wi.shape) == (2, TINY["d_model"], TINY["d_ff"])
    seq2 = DeviceMesh(None, 0, {"data": 1, "model": 1, "seq": 2, "expert": 1,
                                "pipe": 1}, torch.device("cpu"))
    from tpu_pipelines_torch.models.t5 import init_t5_weights

    t5_hp = {"vocab_size": 48, "d_model": 16, "n_layers": 1, "n_heads": 2,
             "head_dim": 8, "d_ff": 32, "dropout_rate": 0.0}
    whole = init_t5_weights(build_t5_model(t5_hp), torch.Generator().manual_seed(3))
    on_seq = build_t5_model(t5_hp, mesh=seq2)
    on_seq.load_state_dict(whole.state_dict())
    t5_batch = {"inputs": torch.arange(2, 14).reshape(2, 6),
                "targets": torch.arange(3, 13).reshape(2, 5)}
    with torch.no_grad():
        assert torch.equal(on_seq.eval()(t5_batch), whole.eval()(t5_batch))
    with pytest.raises(ValueError, match="attn_impl 'sparse'"):
        port_bert.build_bert_model({**TINY, "attn_impl": "sparse"})
