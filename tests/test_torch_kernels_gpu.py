"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs an NVIDIA GPU with ``nvcc``: marked ``gpu`` and
skipped (by the ``cuda`` fixture) where there is none.  Run on the card:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: each kernel and its plain version compute in f32 and differ
only in the order of f32 sums, so each output element agrees to one
rounding step (ulp) of the output dtype:
|out - ref| <= atol + rtol * |ref| with (rtol, atol) = bf16 (2^-7, 1e-5),
fp16 (2^-10, 1e-6), f32 (1e-6, 1e-6); the f32 LSE to (1e-6, 1e-5).  The
backward kernels' gradients take the same rtol and, for elements that
cancel, atol = L * 2^-24 * max|ref| (two orders of a sum of L terms differ
by at most about L * 2^-24 of the sum of |terms|).  Gradients through the
autograd Function against autograd through dense attention, f32: (1e-5,
2e-5) — two formulas (softmax vs the saved LSE), f32 sums over <= 100 keys.
"""

import pytest
import torch

from tpu_pipelines_torch.models.transformer import MultiHeadAttention
from tpu_pipelines_torch.ops import flash_attention as fa
from tpu_pipelines_torch.parallel.ring_attention import dense_attention

pytestmark = pytest.mark.gpu

OUT_TOL = {  # dtype: (rtol, atol)
    torch.bfloat16: (2.0 ** -7, 1e-5),
    torch.float16: (2.0 ** -10, 1e-6),
    torch.float32: (1e-6, 1e-6),
}
LSE_TOL = (1e-6, 1e-5)


def _within(got, want, rtol_atol):
    rtol, atol = rtol_atol
    got, want = got.double(), want.double()
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, l, h, d, dtype, device, seed, empty_row=False):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, l, h, d, generator=gen).to(device, dtype)
               for _ in range(3))
    lengths = torch.randint(1, l + 1, (b,), generator=gen)
    mask = (torch.arange(l)[None, :] < lengths[:, None]).to(torch.int32)
    if empty_row:
        mask[-1] = 0
    return q, k, v, mask.to(device)


@pytest.mark.parametrize(
    "b,l,h,d,dtype,causal,empty_row",
    [
        (32, 128, 12, 64, torch.bfloat16, False, False),   # BERT-base serving
        (2, 200, 4, 64, torch.bfloat16, False, False),     # ragged L
        (2, 200, 4, 32, torch.bfloat16, True, False),      # causal
        (3, 128, 2, 64, torch.bfloat16, False, True),      # all-masked row
        (2, 130, 3, 128, torch.float16, True, False),
        (3, 96, 2, 16, torch.float32, False, False),
        (1, 1, 1, 64, torch.float32, False, False),        # one token
    ],
)
def test_kernel_matches_plain_version(cuda, b, l, h, d, dtype, causal, empty_row):
    q, k, v, mask = _inputs(b, l, h, d, dtype, cuda, seed=l + d, empty_row=empty_row)
    before = fa.launches
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal, kv_mask=mask)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref_out, ref_lse = fa.flash_attention_reference(
        q, k, v, causal=causal, kv_mask=mask
    )
    assert out.dtype == dtype and lse.shape == (b * h, l)
    assert _within(out, ref_out, OUT_TOL[dtype])
    assert _within(lse, ref_lse, LSE_TOL)
    if empty_row:
        assert out[-1].abs().max().item() == 0.0
        assert bool((lse.view(b, h, l)[-1] == fa.NEG_INF).all())


def test_kernel_reads_strided_inputs_and_no_mask(cuda):
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(2, 70, 3, 4, 64, generator=gen).to(cuda, torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out, lse = fa.flash_attention_forward(q, k, v, causal=True)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal=True)
    assert _within(out, ref_out, OUT_TOL[torch.bfloat16])
    assert _within(lse, ref_lse, LSE_TOL)


def test_wrapper_raises_on_cuda_for_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(1, 8, 1, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim 48"):
        fa.flash_attention(x, x, x)
    y = torch.zeros(1, 8, 1, 64, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        fa.flash_attention(y, y, y)


def test_flash_attention_layer_matches_dense_on_the_card(cuda):
    torch.manual_seed(0)
    flash = MultiHeadAttention(64, 4, 16, attn_impl="flash").to(cuda).eval()
    dense = MultiHeadAttention(64, 4, 16, attn_impl="dense").to(cuda).eval()
    dense.load_state_dict(flash.state_dict())
    x = torch.randn(4, 40, 64, device=cuda)
    mask = torch.ones(4, 40, dtype=torch.int32, device=cuda)
    mask[1, 20:] = 0
    with torch.inference_mode():
        got, want = flash(x, mask), dense(x, mask)
    assert (got.float() - want.float()).abs().max().item() <= 5e-2


@pytest.mark.parametrize(
    "b,l,h,d,dtype,causal,mask_kind,strided",
    [
        (256, 128, 12, 64, torch.bfloat16, False, "ragged", False),  # training
        (2, 200, 4, 64, torch.bfloat16, False, "ragged", False),
        (2, 200, 4, 32, torch.bfloat16, True, "ragged", False),
        (4, 128, 2, 64, torch.bfloat16, False, "empty_row", False),
        (2, 130, 3, 128, torch.float16, False, "ragged", True),
        (3, 96, 2, 16, torch.float32, False, "ragged", False),
        (2, 77, 2, 64, torch.bfloat16, True, "none", False),
    ],
)
def test_backward_kernels_match_plain_versions(
    cuda, b, l, h, d, dtype, causal, mask_kind, strided
):
    gen = torch.Generator().manual_seed(l + d)
    if strided:  # q, k, v, dO as slices of one packed tensor
        packed = torch.randn(b, l, 4, h, d, generator=gen).to(cuda, dtype)
        q, k, v, dout = (packed[:, :, i] for i in range(4))
    else:
        q, k, v, dout = (torch.randn(b, l, h, d, generator=gen).to(cuda, dtype)
                         for _ in range(4))
    mask = None
    if mask_kind != "none":
        lengths = torch.randint(1, l + 1, (b,), generator=gen)
        mask = (torch.arange(l)[None, :] < lengths[:, None]).to(torch.int32)
        if mask_kind == "empty_row":
            mask[1] = 0
        mask = mask.to(cuda)
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal, kv_mask=mask)
    dvec = fa._dvec(out, dout)
    args = (q, k, v, dout, lse, dvec)
    before = (fa.dq_launches, fa.dkv_launches)
    dq = fa.flash_bwd_dq(*args, causal=causal, kv_mask=mask)
    dk, dv = fa.flash_bwd_dkv(*args, causal=causal, kv_mask=mask)
    torch.cuda.synchronize()
    assert (fa.dq_launches, fa.dkv_launches) == (before[0] + 1, before[1] + 1)
    ref_dq = fa.flash_bwd_dq_reference(*args, causal=causal, kv_mask=mask)
    ref_dk, ref_dv = fa.flash_bwd_dkv_reference(*args, causal=causal,
                                                kv_mask=mask)
    for got, want in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert got.dtype == dtype and got.shape == q.shape
        atol = l * 2.0 ** -24 * want.double().abs().max().item()
        assert _within(got, want, (OUT_TOL[dtype][0], atol))
        if mask_kind == "empty_row":
            assert got[1].abs().max().item() == 0.0


@pytest.mark.parametrize("causal", [False, True])
def test_attention_gradients_match_autograd_through_dense(cuda, causal):
    gen = torch.Generator().manual_seed(7)
    q, k, v, dout = (torch.randn(2, 100, 3, 32, generator=gen).to(cuda)
                     for _ in range(4))
    lengths = torch.tensor([100, 37])
    mask = (torch.arange(100)[None, :] < lengths[:, None]).to(cuda, torch.int32)
    grads = []
    for attend in (fa.flash_attention, dense_attention):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        attend(*leaves, causal=causal, kv_mask=mask).backward(dout)
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert _within(got, want, (1e-5, 2e-5))


def test_backward_wrapper_raises_on_cuda_for_bad_saved_tensors(cuda):
    q = torch.zeros(1, 8, 1, 64, device=cuda)
    lse = torch.zeros(1, 8, device=cuda)
    with pytest.raises(ValueError, match="dvec"):
        fa.flash_bwd_dq(q, q, q, q, lse, lse[:, :4])
    with pytest.raises(ValueError, match="lse"):
        fa.flash_bwd_dkv(q, q, q, q, lse.double(), lse)
