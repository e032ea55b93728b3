"""Port parity: flash attention forward and plain attention, PyTorch vs JAX.

Inputs are made with numpy from a seed and handed to both frameworks.  The
JAX side runs the Pallas forward kernel in interpret mode on the CPU
(``_flash_forward(..., interpret=True)``, blocks of 16 over L=64); the port
side is the plain version the wrapper runs for CPU tensors.  Both compute
in f32, so they agree to the reference suite's own f32 forward tolerance
(tests/test_flash_attention.py): 2e-5.

The forward parity test also holds each side to a float64 evaluation of
the same function (``_attention_f64``), so a miss names the side that moved
(see ``test_reference_matches_jax_flash_forward``).
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
U = 2.0 ** -24  # f32 unit roundoff


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


def _attention_f64(q, k, v, mask, causal):
    """The kernels' function in float64 numpy: ``(out [b, l, h, d],
    lse [b*h, l])``, zero output and lse = -1e30 for a row with no allowed
    key."""
    qd, kd, vd = (x.astype(np.float64) for x in (q, k, v))
    s = np.einsum("bqhd,bkhd->bhqk", qd * D ** -0.5, kd)
    allowed = np.broadcast_to(mask[:, None, None, :] > 0, s.shape)
    if causal:
        allowed = allowed & (np.arange(L)[:, None] >= np.arange(L)[None, :])
    s = np.where(allowed, s, fa.NEG_INF)
    m = s.max(-1, keepdims=True)
    p = np.where(allowed, np.exp(s - m), 0.0)
    denom = np.maximum(p.sum(-1, keepdims=True), 1e-30)
    out = np.einsum("bhqk,bkhd->bqhd", p / denom, vd)
    return out, (m + np.log(denom)).reshape(B * H, L)


def _diagnosis(sides, out64, lse64, live, inputs):
    """What a failure of the forward parity test prints: each side's worst
    error against float64, the elements where the two sides part (with
    their float64 value and the row's inputs), and the global settings
    that could lower either side's precision."""
    import jax

    lines = []
    for side, (out, lse) in sides.items():
        lines.append(
            f"{side}: max |out - f64| {np.abs(out - out64).max():.3e}, "
            f"max |lse - f64| {np.abs(lse[live] - lse64[live]).max():.3e}")
    (port, _), (ref, _) = sides["port"], sides["jax"]
    apart = np.argwhere(np.abs(port - ref) > F32_TOL["atol"]
                        + F32_TOL["rtol"] * np.abs(ref))
    q, k, v = inputs
    for b, l, h, d in apart[:8]:
        lines.append(
            f"[{b},{l},{h},{d}] port {port[b, l, h, d]!r} jax "
            f"{ref[b, l, h, d]!r} f64 {out64[b, l, h, d]!r}; q row "
            f"{q[b, l, h].tolist()}")
    if len(apart):
        b, l, h = apart[0][:3]
        lines.append(f"k[{b}, :, {h}] sum {k[b, :, h].sum()!r}, v[{b}, :, "
                     f"{h}] sum {v[b, :, h].sum()!r}")
    mkldnn = getattr(getattr(torch.backends.mkldnn, "matmul", None),
                     "fp32_precision", "n/a")
    lines.append(
        f"torch threads {torch.get_num_threads()}, float32 matmul precision "
        f"{torch.get_float32_matmul_precision()}, oneDNN matmul fp32 "
        f"{mkldnn}; jax "
        f"default matmul precision {jax.config.jax_default_matmul_precision}, "
        f"x64 {jax.config.jax_enable_x64}, backend {jax.default_backend()}")
    return "\n".join(lines)


@pytest.mark.parametrize(
    "causal,mask_kind",
    [(False, "none"), (True, "none"), (False, "padding"), (True, "padding"),
     (False, "empty_row")],
)
def test_reference_matches_jax_flash_forward(causal, mask_kind):
    """Each side against float64, then JAX against the port.

    The float64 bound is the first-order worst case of an f32 evaluation:
    each output is a weighted mean over L=64 keys of scores that are dot
    products over D=16, so at most L + D roundings of relative size 2^-24
    (all aligned) land on values no larger than max|v| (the output) or
    max|lse| (the LSE): |err| <= (L + D) * 2^-24 * scale, 2.0e-5 for
    max|v| ~ 4.2.  Measured on both sides: <= 3.3e-7.

    The JAX-vs-port check keeps the reference suite's 2e-5.  This case
    has missed it at 1 to 4 of 4096 elements (|diff| <= 2.9e-5) in two
    full parallel runs of the suite (``-n 6 --dist loadfile``), both times
    as the first case of this file, after ``test_recovery.py`` in the
    same worker.  Twenty-one further full runs, 104 repeats of that
    order in one xdist worker, single-process runs of it and 626 repeats
    under concurrent JAX and torch load did not reproduce it, and neither
    side moves under the global settings that could lower its precision
    (JAX's default matmul precision, torch's float32 matmul precision and
    oneDNN fp32 precision, the thread count, the persistent compile cache,
    the rounding mode).  The cause is not named yet (ROADMAP.md C); a
    failure prints ``_diagnosis``, which names the side that moved, the
    elements and the settings."""
    q, k, v = _qkv()
    mask = _mask(mask_kind)
    want_out, want_lse = _flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        causal=causal, block_q=16, block_k=16, interpret=True,
    )
    want_out = np.array(want_out)
    want_lse = np.array(want_lse)[..., 0]
    tq, tk, tv, tmask = _torch(q, k, v, mask)
    got_out, got_lse = fa.flash_attention_reference(
        tq, tk, tv, causal=causal, kv_mask=tmask
    )
    assert got_out.dtype == torch.float32 and got_lse.shape == (B * H, L)
    out64, lse64 = _attention_f64(q, k, v, mask, causal)
    live = lse64 > fa.NEG_INF / 2                   # rows with an allowed key
    out_tol = (L + D) * U * np.abs(v).max()
    lse_tol = (L + D) * U * np.abs(lse64[live]).max()
    sides = {"port": (got_out.numpy(), got_lse.numpy()),
             "jax": (want_out, want_lse)}
    try:
        for side, (out, lse) in sides.items():
            np.testing.assert_allclose(out, out64, rtol=0, atol=out_tol,
                                       err_msg=f"{side} out vs float64")
            np.testing.assert_allclose(lse[live], lse64[live], rtol=0,
                                       atol=lse_tol,
                                       err_msg=f"{side} lse vs float64")
        np.testing.assert_allclose(got_out.numpy(), want_out, **F32_TOL)
        np.testing.assert_allclose(got_lse.numpy(), want_lse, **F32_TOL)
    except AssertionError as e:
        raise AssertionError(
            f"{e}\n{_diagnosis(sides, out64, lse64, live, (q, k, v))}"
        ) from None
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
