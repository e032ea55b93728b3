"""Port parity: flash attention forward and plain attention, PyTorch vs JAX.

Inputs are made with numpy from a seed and handed to both frameworks.  The
JAX side runs the Pallas forward kernel in interpret mode on the CPU
(``_flash_forward(..., interpret=True)``, blocks of 16 over L=64); the port
side is the plain version the wrapper runs for CPU tensors.  Both compute
in f32, so they agree to the reference suite's own f32 forward tolerance
(tests/test_flash_attention.py): 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pipelines.models import transformer as jax_transformer
from tpu_pipelines.ops.flash_attention import _flash_forward
from tpu_pipelines.parallel.ring_attention import (
    dense_attention as jax_dense_attention,
)
from tpu_pipelines_torch.models import transformer as port_transformer
from tpu_pipelines_torch.ops import flash_attention as fa
from tpu_pipelines_torch.parallel.ring_attention import dense_attention

F32_TOL = dict(rtol=2e-5, atol=2e-5)
B, L, H, D = 2, 64, 2, 16


def _qkv(seed=0, l=L, d=D):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, l, H, d)).astype(np.float32) for _ in range(3)]


def _mask(kind, seed=1, l=L):
    if kind == "none":
        return np.ones((B, l), np.int32)
    rng = np.random.default_rng(seed)
    mask = (rng.random((B, l)) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    if kind == "empty_row":
        mask[1] = 0
    return mask


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize(
    "causal,mask_kind",
    [(False, "none"), (True, "none"), (False, "padding"), (True, "padding"),
     (False, "empty_row")],
)
def test_reference_matches_jax_flash_forward(causal, mask_kind):
    q, k, v = _qkv()
    mask = _mask(mask_kind)
    want_out, want_lse = _flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        causal=causal, block_q=16, block_k=16, interpret=True,
    )
    tq, tk, tv, tmask = _torch(q, k, v, mask)
    got_out, got_lse = fa.flash_attention_reference(
        tq, tk, tv, causal=causal, kv_mask=tmask
    )
    assert got_out.dtype == torch.float32 and got_lse.shape == (B * H, L)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), **F32_TOL)
    np.testing.assert_allclose(
        got_lse.numpy(), np.asarray(want_lse)[..., 0], **F32_TOL
    )
    if mask_kind == "empty_row":
        assert np.all(got_out.numpy()[1] == 0.0)
        assert np.all(got_lse.numpy().reshape(B, H, L)[1] == fa.NEG_INF)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_on_cpu_matches_port_dense(causal):
    q, k, v = _qkv(seed=3)
    tq, tk, tv, tmask = _torch(q, k, v, _mask("padding", seed=4))
    before = fa.launches
    got = fa.flash_attention(tq, tk, tv, causal=causal, kv_mask=tmask)
    want = dense_attention(tq, tk, tv, causal=causal, kv_mask=tmask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)
    assert fa.launches == before  # the plain version is never counted


def test_flash_attention_ragged_length_and_bf16_dtype():
    # L=50 is no multiple of the kernel's 64-row block; bf16 in, bf16 out,
    # f32 math inside (tolerance: one bf16 rounding step at |out| <= 4).
    q, k, v = _qkv(seed=5, l=50)
    tq, tk, tv = (t.to(torch.bfloat16) for t in _torch(q, k, v))
    out, lse = fa.flash_attention_forward(tq, tk, tv)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    want = dense_attention(tq.float(), tk.float(), tv.float())
    np.testing.assert_allclose(
        out.float().numpy(), want.numpy(), rtol=0, atol=3e-2
    )


@pytest.mark.parametrize(
    "causal,mask_kind,with_bias",
    [(False, "padding", False), (True, "none", False), (True, "padding", True)],
)
def test_port_dense_attention_matches_jax(causal, mask_kind, with_bias):
    q, k, v = _qkv(seed=6)
    mask = _mask(mask_kind, seed=7)
    bias = None
    if with_bias:  # an additive [1, heads, q, kv] term (T5-style)
        bias = np.random.default_rng(8).normal(size=(1, H, L, L)).astype(np.float32)
    want = jax_dense_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        kv_mask=jnp.asarray(mask),
        bias=None if bias is None else jnp.asarray(bias),
    )
    tq, tk, tv, tmask = _torch(q, k, v, mask)
    got = dense_attention(
        tq, tk, tv, causal=causal, kv_mask=tmask,
        bias=None if bias is None else torch.from_numpy(bias),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize(
    "shape", [(8, 12, 128, 128), (32, 12, 512, 512), (64, 16, 8192, 8192)]
)
def test_choose_attn_impl_matches_reference_on_cpu(shape):
    # No device memory to read on the CPU: both sides assume 16 GiB.
    want = jax_transformer.choose_attn_impl(*shape, 2)
    assert port_transformer.choose_attn_impl(*shape, 2) == want
    assert port_transformer.dense_attn_fits(*shape, 2) == (
        jax_transformer.dense_attn_fits(*shape, 2)
    )


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = _torch(*_qkv())
    with pytest.raises(ValueError, match="head_dim 8"):
        x = torch.zeros(B, L, H, 8)
        fa.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="block_q"):
        fa.flash_attention(q, k, v, block_q=16)
    with pytest.raises(TypeError, match="float32, float16, bfloat16"):
        fa.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="kv_mask"):
        fa.flash_attention(q, k, v, kv_mask=torch.ones(B, L + 1))
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(B, L, H, 2 * D)[..., ::2]
        fa.flash_attention(t, t, t)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        m = torch.empty(B, L, H, D, device="meta")
        fa.flash_attention(m, m, m)
