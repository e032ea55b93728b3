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
by at most about L * 2^-24 of the sum of |terms|); the bf16 and fp16
kernels round p and dS to the input dtype before their second products
(the plain versions keep them in f32), which adds u times
``fa.bwd_rounding_terms`` per element, u = ``fa.BWD_UNIT_ROUNDOFF`` (2^-8
bf16, 2^-11 fp16, 0 for the f32 FMA kernels).  Dvec: two orders of a sum
of D f32 products, 2 * D * 2^-24 of the row's sum of |dO * O|.  Gradients
through the autograd Function against autograd through dense attention,
f32: (1e-5, 2e-5) — two formulas (softmax vs the saved LSE), f32 sums over
<= 100 keys.
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


def _bwd_inputs(b, l, h, d, dtype, device, seed, mask_kind="ragged",
                strided=False):
    """q, k, v, dO and the key mask: "ragged" lengths, "empty_row" (row 1
    all masked), "hole" (keys 64..127 masked in every row) or "none"."""
    gen = torch.Generator().manual_seed(seed)
    if strided:  # q, k, v, dO as slices of one packed tensor
        packed = torch.randn(b, l, 4, h, d, generator=gen).to(device, dtype)
        q, k, v, dout = (packed[:, :, i] for i in range(4))
    else:
        q, k, v, dout = (torch.randn(b, l, h, d, generator=gen).to(device, dtype)
                         for _ in range(4))
    mask = None
    if mask_kind == "hole":
        mask = torch.ones(b, l, dtype=torch.int32)
        mask[:, 64:128] = 0
    elif mask_kind != "none":
        lengths = torch.randint(1, l + 1, (b,), generator=gen)
        mask = (torch.arange(l)[None, :] < lengths[:, None]).to(torch.int32)
        if mask_kind == "empty_row":
            mask[1] = 0
    return q, k, v, dout, None if mask is None else mask.to(device)


def _within_bwd_bound(got, want, term, dtype, l):
    """|got - want| <= u * term + L * 2^-24 * max|want| + rtol * |want|."""
    want = want.double()
    bound = (fa.BWD_UNIT_ROUNDOFF[dtype] * term.double()
             + l * 2.0 ** -24 * want.abs().max() + OUT_TOL[dtype][0] * want.abs())
    return bool(((got.double() - want).abs() <= bound).all())


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
        (2, 200, 4, 64, torch.bfloat16, False, "hole", False),
        (3, 96, 2, 16, torch.bfloat16, True, "ragged", False),
    ],
)
def test_backward_kernels_match_plain_versions(
    cuda, b, l, h, d, dtype, causal, mask_kind, strided
):
    q, k, v, dout, mask = _bwd_inputs(b, l, h, d, dtype, cuda, l + d, mask_kind,
                                      strided)
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal, kv_mask=mask)
    before = (fa.dvec_launches, fa.dq_launches, fa.dkv_launches)
    dvec = fa.flash_bwd_dvec(out, dout)
    args = (q, k, v, dout, lse, dvec)
    dq = fa.flash_bwd_dq(*args, causal=causal, kv_mask=mask)
    dk, dv = fa.flash_bwd_dkv(*args, causal=causal, kv_mask=mask)
    torch.cuda.synchronize()
    assert (fa.dvec_launches, fa.dq_launches, fa.dkv_launches) == tuple(
        n + 1 for n in before)
    refs = (fa.flash_bwd_dq_reference(*args, causal=causal, kv_mask=mask),
            *fa.flash_bwd_dkv_reference(*args, causal=causal, kv_mask=mask))
    terms = fa.bwd_rounding_terms(*args, causal=causal, kv_mask=mask)
    for got, want, term in zip((dq, dk, dv), refs, terms):
        assert got.dtype == dtype and got.shape == q.shape
        assert _within_bwd_bound(got, want, term, dtype, l)
        if mask_kind == "empty_row":
            assert got[1].abs().max().item() == 0.0
    if mask_kind == "hole":  # the masked 64-key block gets nothing
        assert dk[:, 64:128].abs().max().item() == 0.0
        assert dv[:, 64:128].abs().max().item() == 0.0
    if mask is not None:  # the mask shifted by one key must fail the bound
        shifted = torch.roll(mask, 1, dims=1)
        wrong = (fa.flash_bwd_dq(*args, causal=causal, kv_mask=shifted),
                 *fa.flash_bwd_dkv(*args, causal=causal, kv_mask=shifted))
        for got, want, term in zip(wrong, refs, terms):
            assert not _within_bwd_bound(got, want, term, dtype, l)


@pytest.mark.parametrize("dtype,d,causal", [(torch.bfloat16, 64, False),
                                            (torch.float16, 128, True),
                                            (torch.float32, 32, False)])
def test_backward_kernels_repeat_bit_for_bit(cuda, dtype, d, causal):
    q, k, v, dout, mask = _bwd_inputs(8, 200, 4, d, dtype, cuda, seed=3)
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal, kv_mask=mask)
    runs = [fa.flash_attention_backward(q, k, v, out, lse, dout, causal=causal,
                                        kv_mask=mask) for _ in range(3)]
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(run, runs[0]))


def test_f32_backward_runs_the_fma_kernels_within_the_f32_bound(cuda):
    from torch.profiler import ProfilerActivity, profile

    q, k, v, dout, mask = _bwd_inputs(3, 96, 2, 16, torch.float32, cuda, seed=5)
    out, lse = fa.flash_attention_forward(q, k, v, kv_mask=mask)
    dvec = fa.flash_bwd_dvec(out, dout)
    args = (q, k, v, dout, lse, dvec)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        grads = (fa.flash_bwd_dq(*args, kv_mask=mask),
                 *fa.flash_bwd_dkv(*args, kv_mask=mask))
        torch.cuda.synchronize()
    names = " ".join(e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
    assert "flash_bwd_dq_kernel<float" in names
    assert "flash_bwd_dkv_kernel<float" in names
    assert "_mma_kernel" not in names
    refs = (fa.flash_bwd_dq_reference(*args, kv_mask=mask),
            *fa.flash_bwd_dkv_reference(*args, kv_mask=mask))
    for got, want in zip(grads, refs):
        atol = 96 * 2.0 ** -24 * want.double().abs().max().item()
        assert _within(got, want, (OUT_TOL[torch.float32][0], atol))


def test_backward_wrapper_raises_on_misaligned_16bit_rows(cuda):
    gen = torch.Generator().manual_seed(0)
    wide = torch.randn(2, 16, 2, 72, generator=gen).to(cuda, torch.bfloat16)
    q = wide[..., 1:65]  # rows 2 bytes past a 16-byte boundary
    good = wide[..., :64].contiguous()
    lse = torch.zeros(4, 16, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_bwd_dq(q, good, good, good, lse, lse)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_bwd_dkv(good, good, good, q, lse, lse)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_bwd_dvec(q, good)


@pytest.mark.parametrize("dtype,d,strided", [(torch.bfloat16, 64, False),
                                             (torch.float16, 128, True),
                                             (torch.bfloat16, 16, True),
                                             (torch.float32, 32, False)])
def test_dvec_kernel_matches_plain_version(cuda, dtype, d, strided):
    out, _, _, dout, _ = _bwd_inputs(5, 77, 3, d, dtype, cuda, seed=d,
                                     strided=strided)
    before = fa.dvec_launches
    dvec = fa.flash_bwd_dvec(out, dout)
    torch.cuda.synchronize()
    assert fa.dvec_launches == before + 1
    ref = fa._dvec(out, dout)
    assert dvec.dtype == torch.float32 and dvec.shape == ref.shape
    bound = 2 * d * 2.0 ** -24 * (dout.float() * out.float()).abs().sum(-1)
    assert bool(((dvec - ref).abs() <= bound.permute(0, 2, 1).reshape(-1, 77)).all())


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


def _decode_inputs(b, l, h, d, dtype, device, seed, arena=False):
    """q [b, 1, h, d] and k, v [b, l, h, d]; ``arena``: k and v are the
    ``[:b, :l]`` slices of a larger cache, as the engine hands them over."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(b, 1, h, d, generator=gen).to(device, dtype)
    if arena:
        cache = torch.randn(b + 3, l + 40, 2, h, d, generator=gen).to(device, dtype)
        k, v = cache[:b, :l, 0], cache[:b, :l, 1]
    else:
        k, v = (torch.randn(b, l, h, d, generator=gen).to(device, dtype)
                for _ in range(2))
    return q, k, v, gen


@pytest.mark.parametrize(
    "b,l,h,d,dtype,bias_kind,arena",
    [
        (16, 128, 8, 64, torch.bfloat16, "broadcast", False),  # served beam
        (8, 64, 8, 64, torch.bfloat16, "per_row", True),       # engine bucket
        (3, 1, 2, 64, torch.bfloat16, "broadcast", False),     # L = 1
        (3, 100, 2, 64, torch.bfloat16, "per_row", False),     # ragged L
        (4, 96, 2, 32, torch.float16, "none", False),
        (2, 70, 3, 128, torch.float32, "per_row", True),
        (5, 33, 4, 16, torch.bfloat16, "broadcast", False),
    ],
)
def test_decode_kernel_matches_plain_version(cuda, b, l, h, d, dtype,
                                             bias_kind, arena):
    q, k, v, gen = _decode_inputs(b, l, h, d, dtype, cuda, seed=l + d,
                                  arena=arena)
    pos = torch.randint(0, l, (b,), generator=gen)
    mask = (torch.arange(l)[None, :] <= pos[:, None]).to(cuda, torch.int32)
    mask[-1] = 0                                   # an all-masked row
    bias = None
    if bias_kind != "none":
        rows = 1 if bias_kind == "broadcast" else b
        bias = torch.randn(rows, h, 1, l, generator=gen).to(cuda)
    before = fa.decode_launches
    out = fa.flash_decode_attention(q, k, v, kv_mask=mask, bias=bias)
    torch.cuda.synchronize()
    assert fa.decode_launches == before + 1
    ref = fa.flash_decode_attention_reference(q, k, v, kv_mask=mask, bias=bias)
    assert out.dtype == dtype and out.shape == (b, 1, h, d)
    assert _within(out, ref, OUT_TOL[dtype])
    assert out[-1].abs().max().item() == 0.0
    # A bool mask is the same mask; no mask attends to every key.
    assert torch.equal(fa.flash_decode_attention(q, k, v, kv_mask=mask > 0,
                                                 bias=bias), out)
    full = fa.flash_decode_attention(q, k, v, bias=bias)
    assert _within(full, fa.flash_decode_attention_reference(q, k, v, bias=bias),
                   OUT_TOL[dtype])


def test_decode_wrapper_raises_on_cuda_for_what_the_kernel_does_not_take(cuda):
    q, k, v, _ = _decode_inputs(2, 16, 2, 64, torch.bfloat16, cuda, seed=0)
    with pytest.raises(ValueError, match="block_k"):
        fa.flash_decode_attention(q, k, v, block_k=128)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_decode_attention(q[..., 1:33], k[..., 1:33], v[..., 1:33])
    with pytest.raises(ValueError, match="kv_mask on"):
        fa.flash_decode_attention(q, k, v,
                                  kv_mask=torch.ones(2, 16, dtype=torch.int32))


def test_backward_wrapper_raises_on_cuda_for_bad_saved_tensors(cuda):
    q = torch.zeros(1, 8, 1, 64, device=cuda)
    lse = torch.zeros(1, 8, device=cuda)
    with pytest.raises(ValueError, match="dvec"):
        fa.flash_bwd_dq(q, q, q, q, lse, lse[:, :4])
    with pytest.raises(ValueError, match="lse"):
        fa.flash_bwd_dkv(q, q, q, q, lse.double(), lse)
