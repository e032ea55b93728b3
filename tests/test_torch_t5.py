"""The port's T5 against the JAX package's, on a tiny model.

The tiny T5 of ``tests/torch_t5_tiny.py`` (2 + 2 layers, d_model 16, 2
heads of 16, f32, initialised by JAX and carried bit for bit into the port
by ``t5_state_dict_from_flax``).  Same numpy inputs on both sides.

Tolerances: relative-position buckets must match exactly; RMSNorm (f32)
1e-6, bf16 one ulp; teacher-forced logits (rtol, atol) = (2e-5, 2e-5), the
JAX package's own decode-parity tolerance.  The incremental decode is in
``tests/test_torch_t5_decode.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import torch_t5_tiny as tiny
from tpu_pipelines.models import t5 as jt5
from tpu_pipelines_torch.models import t5 as pt5
from tpu_pipelines_torch.models.convert import t5_state_dict_from_flax
from tpu_pipelines_torch.models.transformer import RMSNorm

TOL = tiny.TOL


@pytest.fixture(scope="module")
def flax_params():
    return tiny.flax_params()


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("qlen,klen", [(1, 1), (7, 5), (40, 300)])
def test_relative_position_buckets_match_exactly(bidirectional, qlen, klen):
    want = np.asarray(jt5.relative_position_buckets(
        qlen, klen, bidirectional=bidirectional))
    got = pt5.relative_position_buckets(qlen, klen, bidirectional=bidirectional)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_flax(dtype):
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((3, 5, 16))).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    jdtype = jnp.dtype(dtype)
    want = nn.RMSNorm(dtype=jdtype).apply(
        {"params": {"scale": scale}}, jnp.asarray(x, jdtype))
    norm = RMSNorm(16, getattr(torch, dtype))
    norm.weight.data = torch.from_numpy(scale)
    with torch.no_grad():
        got = norm(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else dict(
        rtol=2.0 ** -7, atol=1e-5)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


def test_state_dict_carries_flax_values_bit_for_bit(flax_params):
    state = t5_state_dict_from_flax(flax_params)
    flat = tiny.flat(flax_params)
    assert state["shared.weight"].numpy().tobytes() == \
        flat["shared.embedding"].tobytes()
    np.testing.assert_array_equal(state["decoder.rel_pos.rel_embedding"].numpy(),
                                  flat["decoder.rel_pos.rel_embedding"])
    np.testing.assert_array_equal(
        state["decoder.layers.1.cross.query.weight"].numpy(),
        flat["decoder.layer_1.cross.query.kernel"].reshape(16, -1).T)
    assert sum(t.numel() for t in state.values()) == sum(
        a.size for a in flat.values())


def test_teacher_forced_logits_match(flax_params):
    """Biased attention takes the dense path in both packages whatever
    attn_impl says, so "flash" is the served payload's setting here."""
    inputs, mask, targets = tiny.batch()
    want = jax.jit(tiny.jax_model("flash").apply)(
        {"params": flax_params},
        {"inputs": inputs, "targets": targets, "input_mask": mask})
    model, _ = tiny.port_model(flax_params, "flash")
    with torch.no_grad():
        got = model({"inputs": torch.from_numpy(inputs),
                     "targets": torch.from_numpy(targets),
                     "input_mask": torch.from_numpy(mask)})
    assert got.dtype == torch.float32 and got.shape == (2, 5, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_weights_follow_flax_scales():
    model = pt5.T5(vocab_size=64, d_model=32, n_layers=1, n_heads=2,
                   head_dim=16, d_ff=64)
    pt5.init_t5_weights(model, torch.Generator().manual_seed(0))
    wi = model.encoder.layers[0].mlp.wi.weight
    assert abs(wi.std().item() - 32 ** -0.5) < 0.2 * 32 ** -0.5
    assert wi.abs().max().item() <= 2 * 32 ** -0.5 / 0.87962566103423978
    assert abs(model.shared.weight.std().item() - 32 ** -0.5) < 0.1 * 32 ** -0.5
    assert torch.all(model.decoder.final_norm.weight == 1.0)
    assert torch.all(model.encoder.layers[0].attn.query.bias == 0.0)
    assert abs(model.encoder.rel_pos.rel_embedding.std().item() - 1.0) < 0.3
