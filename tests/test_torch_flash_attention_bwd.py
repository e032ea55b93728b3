"""Port parity: the flash-attention backward, PyTorch vs JAX, on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks.  The
JAX side runs the Pallas backward kernels (``_dq_kernel``, ``_dkv_kernel``)
in interpret mode on the CPU (``_flash_backward(..., interpret=True)``,
blocks of 16 over L=64); the port side is
``flash_attention_backward_reference``, the plain version the wrapper runs
for CPU tensors and the CUDA kernels are held to on the card.  Both sides
get the same ``out`` and ``lse`` (the JAX forward's), so the comparison
isolates the backward.

Tolerance, 2e-5 absolute plus 2e-5 relative: both sides compute every
product in f32 and differ only in the order of sums.  Each gradient element
is a sum of at most L=64 products (D=16 for the recomputed scores), and two
summation orders differ by at most about L * 2^-24 ~ 3.8e-6 of the sum of
|terms|, which is O(1) here (the largest gradients are ~4): the tolerance
leaves a factor of ~5 on that worst case.  Measured: <= 1.1e-6.

The bf16/fp16 CUDA kernels round p and dS to the input dtype before their
second products; the card-side checks hold them to the plain version by a
per-element bound built from ``fa.bwd_rounding_terms``.  The last test
validates that bound here: the plain formula with that rounding emulated
stays inside it, and the same emulation fed the mask shifted by one key
lands outside it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pipelines.ops.flash_attention import _flash_backward, _flash_forward
from tpu_pipelines_torch.ops import flash_attention as fa

F32_TOL = dict(rtol=2e-5, atol=2e-5)
B, L, H, D = 2, 64, 2, 16
CASES = [(False, "none"), (True, "none"), (False, "padding"),
         (True, "padding"), (False, "empty_row")]


def _arrays(seed=0, n=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, L, H, D)).astype(np.float32) for _ in range(n)]


def _mask(kind, seed=1):
    if kind == "none":
        return np.ones((B, L), np.int32)
    rng = np.random.default_rng(seed)
    mask = (rng.random((B, L)) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    if kind == "empty_row":
        mask[1] = 0
    return mask


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("causal,mask_kind", CASES)
def test_backward_reference_matches_jax_flash_backward(causal, mask_kind):
    q, k, v, g = _arrays()
    mask = _mask(mask_kind)
    jq, jk, jv, jmask = map(jnp.asarray, (q, k, v, mask))
    out, lse = _flash_forward(jq, jk, jv, jmask, causal=causal, block_q=16,
                              block_k=16, interpret=True)
    want = _flash_backward(jq, jk, jv, jmask, out, lse, jnp.asarray(g),
                           causal=causal, block_q=16, block_k=16,
                           interpret=True)
    got = fa.flash_attention_backward_reference(
        _t(q), _t(k), _t(v), _t(out), _t(np.asarray(lse)[..., 0]), _t(g),
        causal=causal, kv_mask=_t(mask),
    )
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **F32_TOL)
    if mask_kind == "empty_row":
        # The all-masked batch row: zero dq, and its keys get nothing.
        for name, a in zip(("dq", "dk", "dv"), got):
            assert np.all(a.numpy()[1] == 0.0), name


@pytest.mark.parametrize("causal,mask_kind", CASES)
def test_flash_attention_gradients_match_autograd_through_plain_forward(
    causal, mask_kind
):
    """The autograd Function on CPU tensors (forward and backward plain
    versions) against PyTorch's own autograd through the plain forward."""
    q, k, v, g = (_t(a) for a in _arrays(seed=2))
    mask = _t(_mask(mask_kind, seed=3))
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention(*leaves, causal=causal, kv_mask=mask).backward(g)
    got = [t.grad for t in leaves]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, _ = fa.flash_attention_reference(*leaves, causal=causal, kv_mask=mask)
    out.backward(g)
    for name, a, b in zip(("dq", "dk", "dv"), got, (t.grad for t in leaves)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name,
                                   **F32_TOL)
    # The plain versions are never counted as kernel launches.
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == before


def test_flash_attention_backward_keeps_the_input_dtype():
    q, k, v, g = (_t(a).to(torch.bfloat16) for a in _arrays(seed=4))
    mask = _t(_mask("padding", seed=5))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, kv_mask=mask)
    assert out.dtype == torch.bfloat16
    out.backward(g)
    for t in leaves:
        assert t.grad.dtype == torch.bfloat16 and t.grad.shape == q.shape
    with torch.no_grad():  # serving: the forward alone, nothing saved
        assert not fa.flash_attention(q, k, v, kv_mask=mask).requires_grad


def test_backward_wrapper_rejects_what_the_kernels_do_not_take():
    q, k, v, g = (_t(a) for a in _arrays(seed=6))
    out, lse = fa.flash_attention_forward(q, k, v)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_backward(q, k, v, out, lse[:, :-1], g)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_backward(q, k, v, out, lse.double(), g)
    with pytest.raises(ValueError, match="dout"):
        fa.flash_attention_backward(q, k, v, out, lse, g[:, :-1])
    with pytest.raises(ValueError, match="dout"):
        fa.flash_attention_backward(q, k, v, out, lse, g.to(torch.bfloat16))
    m = torch.empty(B, L, H, D, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fa.flash_attention_backward(
            m, m, m, m, torch.empty(B * H, L, device="meta"), m
        )


OUT_RTOL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


def _emulated_kernel_rounding(q, k, v, dout, lse, dvec, dtype, causal, mask):
    """The 16-bit backward kernels' arithmetic: the plain formula in f32
    with p and dS rounded to ``dtype`` before the second products and the
    gradients written in ``dtype``."""
    p, ds, scale = fa._probs(q, k, v, dout, lse, dvec, causal, mask)
    p, ds = p.to(dtype).float(), ds.to(dtype).float()
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def _bound_ratio(got, want, term, dtype, u=None):
    """max |got - want| / (u * term + L * 2^-24 * max|want| + rtol * |want|),
    u the dtype's ``BWD_UNIT_ROUNDOFF`` unless given."""
    want = want.double()
    u = fa.BWD_UNIT_ROUNDOFF[dtype] if u is None else u
    bound = (u * term.double()
             + L * 2.0 ** -24 * want.abs().max() + OUT_RTOL[dtype] * want.abs())
    err = (got.double() - want).abs()
    return torch.where(err == 0, 0.0, err / bound).max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "padding"])
def test_rounding_bound_holds_for_the_kernels_rounding_and_not_a_shifted_mask(
    dtype, causal
):
    q, k, v, g = (_t(a).to(dtype) for a in _arrays(seed=8))
    mask = _t(_mask("padding", seed=9))
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal, kv_mask=mask)
    args = (q, k, v, g, lse, fa.flash_bwd_dvec(out, g))
    refs = (fa.flash_bwd_dq_reference(*args, causal=causal, kv_mask=mask),
            *fa.flash_bwd_dkv_reference(*args, causal=causal, kv_mask=mask))
    terms = fa.bwd_rounding_terms(*args, causal=causal, kv_mask=mask)
    sound = _emulated_kernel_rounding(*args, dtype, causal, mask)
    shifted = _emulated_kernel_rounding(*args, dtype, causal,
                                        torch.roll(mask, 1, dims=1))
    for name, got, wrong, want, term in zip(("dq", "dk", "dv"), sound, shifted,
                                            refs, terms):
        assert _bound_ratio(got, want, term, dtype) <= 1.0, name
        assert _bound_ratio(wrong, want, term, dtype) > 1.0, name
    # Without the rounding term (the f32 kernels' bound) the same rounding
    # does not fit: the term is needed, not a loosening for its own sake.
    assert max(_bound_ratio(got, want, term, dtype, u=0.0)
               for got, want, term in zip(sound, refs, terms)) > 1.0


def test_dvec_wrapper_runs_the_plain_version_on_cpu_and_checks_its_inputs():
    out, g = (_t(a) for a in _arrays(seed=10, n=2))
    assert torch.equal(fa.flash_bwd_dvec(out, g), fa._dvec(out, g))
    assert fa.flash_bwd_dvec(out, g).shape == (B * H, L)
    with pytest.raises(ValueError, match="dout"):
        fa.flash_bwd_dvec(out, g[:, :-1])
    with pytest.raises(ValueError, match="head_dim 12"):
        fa.flash_bwd_dvec(out[..., :12], g[..., :12])
    m = torch.empty(B, L, H, D, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fa.flash_bwd_dvec(m, m)
