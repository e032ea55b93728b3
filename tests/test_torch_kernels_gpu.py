"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs an NVIDIA GPU with ``nvcc``: marked ``gpu`` and
skipped (by the ``cuda`` fixture) where there is none.  Run on the card:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: each kernel and its plain version compute in f32 and differ
only in the order of f32 sums, so each output element agrees to one
rounding step (ulp) of the output dtype:
|out - ref| <= atol + rtol * |ref| with (rtol, atol) = bf16 (2^-7, 1e-5),
fp16 (2^-10, 1e-6), f32 (1e-6, 1e-6); the f32 LSE to (1e-6, 1e-5).  That
holds for the decode kernel and the f32 forward.  The bf16 and fp16
forward kernel rounds p to the input dtype before O = p v (the plain
version keeps it in f32), which adds u times ``fa.fwd_rounding_terms``
and, for the order of the L-term f32 sums, L * 2^-24 * max|ref| per
element, u = ``fa.UNIT_ROUNDOFF`` (2^-8 bf16, 2^-11 fp16).  The backward
kernels' gradients take the same rtol and, for elements that cancel,
atol = L * 2^-24 * max|ref| (two orders of a sum of L terms differ by at
most about L * 2^-24 of the sum of |terms|); the bf16 and fp16 kernels
round p and dS to the input dtype before their second products, which
adds u times ``fa.bwd_rounding_terms`` per element (u = 0 for the f32
FMA kernels).  A kernel fed the key mask shifted by one key must miss
each bound.  Dvec: two orders of a sum
of D f32 products, 2 * D * 2^-24 of the row's sum of |dO * O|.  Gradients
through the autograd Function against autograd through dense attention,
f32: (1e-5, 2e-5) — two formulas (softmax vs the saved LSE), f32 sums over
<= 100 keys.

The last tests drive ``train_loop`` on the card with a tiny BERT (flash
attention, dropout 0.1): its CUDA-graph steps equal the same steps run
eagerly bit for bit (losses and parameters), the four attention counters
read layers x steps (counted at replay), and a capture that cannot
succeed raises instead of running the step eagerly (kept last: a failed
capture is the one test here that leaves the context in an unusual state).
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


def _inputs(b, l, h, d, dtype, device, seed, mask_kind="ragged"):
    """q, k, v and the key mask: "ragged" lengths, "empty_row" (the last
    row all masked) or "hole" (keys 64..127 masked in every row)."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, l, h, d, generator=gen).to(device, dtype)
               for _ in range(3))
    lengths = torch.randint(1, l + 1, (b,), generator=gen)
    mask = (torch.arange(l)[None, :] < lengths[:, None]).to(torch.int32)
    if mask_kind == "empty_row":
        mask[-1] = 0
    if mask_kind == "hole":
        mask = torch.ones(b, l, dtype=torch.int32)
        mask[:, 64:128] = 0
    return q, k, v, mask.to(device)


def _within_fwd_bound(out, ref, term, dtype, l):
    """f32: OUT_TOL; bf16 and fp16: |out - ref| <= u * term +
    L * 2^-24 * max|ref| + rtol * |ref| + atol."""
    if dtype == torch.float32:
        return _within(out, ref, OUT_TOL[dtype])
    ref = ref.double()
    rtol, atol = OUT_TOL[dtype]
    bound = (fa.UNIT_ROUNDOFF[dtype] * term.double()
             + l * 2.0 ** -24 * ref.abs().max() + rtol * ref.abs() + atol)
    return bool(((out.double() - ref).abs() <= bound).all())


@pytest.mark.parametrize(
    "b,l,h,d,dtype,causal,mask_kind",
    [
        (32, 128, 12, 64, torch.bfloat16, False, "ragged"),   # BERT-base serving
        (256, 128, 12, 64, torch.bfloat16, False, "ragged"),  # BERT-base training
        (256, 64, 12, 64, torch.bfloat16, False, "ragged"),   # the BERT DAG
        (2, 200, 4, 64, torch.bfloat16, False, "ragged"),     # ragged L
        (2, 200, 4, 32, torch.bfloat16, True, "ragged"),      # causal
        (3, 128, 2, 64, torch.bfloat16, False, "empty_row"),  # all-masked row
        (2, 200, 4, 64, torch.bfloat16, False, "hole"),       # masked 64-key block
        (2, 130, 3, 128, torch.float16, True, "ragged"),
        (3, 96, 2, 16, torch.bfloat16, True, "ragged"),
        (3, 96, 2, 16, torch.float32, False, "ragged"),
        (1, 1, 1, 64, torch.float32, False, "ragged"),        # one token
        (1, 1, 1, 64, torch.bfloat16, False, "ragged"),
    ],
)
def test_kernel_matches_plain_version(cuda, b, l, h, d, dtype, causal, mask_kind):
    q, k, v, mask = _inputs(b, l, h, d, dtype, cuda, seed=l + d, mask_kind=mask_kind)
    before = fa.launches
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal, kv_mask=mask)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref_out, ref_lse = fa.flash_attention_reference(
        q, k, v, causal=causal, kv_mask=mask
    )
    term = fa.fwd_rounding_terms(q, k, v, causal=causal, kv_mask=mask)
    assert out.dtype == dtype and lse.shape == (b * h, l)
    assert _within_fwd_bound(out, ref_out, term, dtype, l)
    assert _within(lse, ref_lse, LSE_TOL)
    if mask_kind == "empty_row":
        assert out[-1].abs().max().item() == 0.0
        assert bool((lse.view(b, h, l)[-1] == fa.NEG_INF).all())
    if l > 1:  # the mask shifted by one key must fail both checks
        wrong_out, wrong_lse = fa.flash_attention_forward(
            q, k, v, causal=causal, kv_mask=torch.roll(mask, 1, dims=1))
        assert not _within_fwd_bound(wrong_out, ref_out, term, dtype, l)
        assert not _within(wrong_lse, ref_lse, LSE_TOL)


def test_kernel_reads_strided_inputs_and_no_mask(cuda):
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(2, 70, 3, 4, 64, generator=gen).to(cuda, torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out, lse = fa.flash_attention_forward(q, k, v, causal=True)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal=True)
    term = fa.fwd_rounding_terms(q, k, v, causal=True)
    assert _within_fwd_bound(out, ref_out, term, torch.bfloat16, 70)
    assert _within(lse, ref_lse, LSE_TOL)


@pytest.mark.parametrize("dtype,d,causal", [(torch.bfloat16, 64, False),
                                            (torch.float16, 128, True),
                                            (torch.float32, 32, False)])
def test_forward_kernel_repeats_bit_for_bit(cuda, dtype, d, causal):
    q, k, v, mask = _inputs(8, 200, 4, d, dtype, cuda, seed=4)
    runs = [fa.flash_attention_forward(q, k, v, causal=causal, kv_mask=mask)
            for _ in range(3)]
    for out, lse in runs[1:]:
        assert torch.equal(out, runs[0][0]) and torch.equal(lse, runs[0][1])


def test_forward_runs_the_fma_kernel_for_f32_and_the_tensor_cores_for_bf16(cuda):
    from torch.profiler import ProfilerActivity, profile

    q, k, v, mask = _inputs(3, 96, 2, 32, torch.float32, cuda, seed=6)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out, lse = fa.flash_attention_forward(q, k, v, kv_mask=mask)
        fa.flash_attention_forward(*(t.to(torch.bfloat16) for t in (q, k, v)),
                                   kv_mask=mask)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("flash_fwd_kernel<float" in n for n in names) == 1
    assert sum("flash_fwd_mma_kernel<__nv_bfloat16" in n for n in names) == 1
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, kv_mask=mask)
    assert _within(out, ref_out, OUT_TOL[torch.float32])
    assert _within(lse, ref_lse, LSE_TOL)


def test_forward_wrapper_raises_on_misaligned_16bit_rows(cuda):
    gen = torch.Generator().manual_seed(0)
    wide = torch.randn(2, 16, 2, 72, generator=gen).to(cuda, torch.bfloat16)
    q = wide[..., 1:65]  # rows 2 bytes past a 16-byte boundary
    good = wide[..., :64].contiguous()
    before = fa.launches
    for args in ((q, good, good), (good, q, good), (good, good, q)):
        with pytest.raises(ValueError, match="16-byte"):
            fa.flash_attention_forward(*args)
    assert fa.launches == before


def test_forward_kernel_info_reports_no_spills_at_head_dims_up_to_64(cuda):
    for dtype in (torch.bfloat16, torch.float16):
        for d in (16, 32, 64):
            info = fa.fwd_kernel_info(dtype, d, 128)
            assert info["local_bytes"] == 0, (dtype, d, info)
            assert 0 < info["registers"] <= 128, (dtype, d, info)
            # Q and two stages of K and V (64 rows each), the mask's bits.
            assert info["shared_bytes"] == 5 * 64 * d * 2 + 4 * 4


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
    bound = (fa.UNIT_ROUNDOFF[dtype] * term.double()
             + l * 2.0 ** -24 * want.abs().max() + OUT_TOL[dtype][0] * want.abs())
    return bool(((got.double() - want).abs() <= bound).all())


@pytest.mark.parametrize(
    "b,l,h,d,dtype,causal,mask_kind,strided",
    [
        (256, 128, 12, 64, torch.bfloat16, False, "ragged", False),  # training
        (256, 64, 12, 64, torch.bfloat16, False, "ragged", False),   # BERT DAG
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
        (256, 32, 8, 64, torch.bfloat16, "broadcast", False),  # T5 DAG's beam
        (8, 64, 8, 64, torch.bfloat16, "per_row", True),       # engine bucket
        (3, 1, 2, 64, torch.bfloat16, "broadcast", False),     # L = 1
        (3, 100, 2, 64, torch.bfloat16, "per_row", False),     # ragged L
        (4, 96, 2, 32, torch.float16, "none", False),
        (2, 70, 3, 128, torch.float32, "per_row", True),
        (5, 33, 4, 16, torch.bfloat16, "broadcast", False),
        # Split-KV shapes (B*H < the SMs, so S = fa.decode_splits > 1): a long
        # cache, uneven spans with L not a multiple of 64, f32 and D=128,
        # clusters of 8, 3 and 5.
        (4, 4096, 8, 64, torch.bfloat16, "broadcast", False),
        (2, 1100, 4, 64, torch.float32, "per_row", True),
        (3, 2048, 8, 128, torch.bfloat16, "per_row", True),
        (11, 1000, 8, 64, torch.float16, "broadcast", False),
        (8, 2048, 8, 64, torch.bfloat16, "per_row", True),
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
    # Two launches agree bit for bit (the splits merge in rank order).
    assert torch.equal(fa.flash_decode_attention(q, k, v, kv_mask=mask,
                                                 bias=bias), out)


@pytest.mark.parametrize("b,l", [(16, 128), (256, 32), (4, 4096), (2, 1000),
                                 (4, 1)])
def test_decode_kernel_reads_a_bool_stride0_mask_in_place(cuda, b, l):
    """The scalar-position decode step's mask: one bool row expanded over
    the batch (batch stride 0), read in place, equal to its int32 copy."""
    h, d = 8, 64
    q, k, v, gen = _decode_inputs(b, l, h, d, torch.bfloat16, cuda, seed=b + l)
    expanded = (torch.arange(l, device=cuda) <= l // 2)[None, :].expand(b, l)
    assert expanded.stride() == (0, 1)
    bias = torch.randn(1, h, 1, l, generator=gen).to(cuda)
    out = fa.flash_decode_attention(q, k, v, kv_mask=expanded, bias=bias)
    copy = expanded.to(torch.int32).contiguous()
    assert torch.equal(fa.flash_decode_attention(q, k, v, kv_mask=copy,
                                                 bias=bias), out)
    ref = fa.flash_decode_attention_reference(q, k, v, kv_mask=copy, bias=bias)
    assert _within(out, ref, OUT_TOL[torch.bfloat16])
    assert torch.equal(fa.flash_decode_attention(q, k, v, kv_mask=expanded,
                                                 bias=bias), out)


def test_decode_all_masked_splits_and_rows_are_exact_zero(cuda):
    """Validity below L/8 leaves every split past the first with no allowed
    key; a row with no allowed key at all outputs exact 0."""
    b, l, h, d = 4, 2048, 8, 64
    q, k, v, gen = _decode_inputs(b, l, h, d, torch.bfloat16, cuda, seed=11)
    assert fa.decode_splits(b, h, l, fa.sm_count(cuda)) == 8
    pos = torch.randint(0, l // 8, (b,), generator=gen)
    mask = (torch.arange(l)[None, :] <= pos[:, None]).to(cuda)
    mask[2] = False
    bias = torch.randn(b, h, 1, l, generator=gen).to(cuda)
    out = fa.flash_decode_attention(q, k, v, kv_mask=mask, bias=bias)
    ref = fa.flash_decode_attention_reference(q, k, v, kv_mask=mask, bias=bias)
    assert _within(out, ref, OUT_TOL[torch.bfloat16])
    assert out[2].abs().max().item() == 0.0


def test_decode_kernel_info_reports_no_spills_and_clusters_fit(cuda):
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for d in fa.HEAD_DIMS:
            info = fa.decode_kernel_info(dtype, d, fa.DECODE_MAX_SPLITS)
            assert info["local_bytes"] == 0, (dtype, d, info)
            assert info["ctas_per_sm"] >= 4, (dtype, d, info)
            assert info["max_active_clusters"] >= 1, (dtype, d, info)


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


# ---- the captured training step (train_loop on CUDA)

# A tiny BERT with the kernels' head_dim 64, dropout on, bf16 compute.
TINY_TRAIN = {"vocab_size": 128, "d_model": 128, "n_layers": 2, "n_heads": 2,
              "d_ff": 256, "max_len": 64, "dropout_rate": 0.1,
              "num_classes": 2, "attn_impl": "flash"}


def _train_batches(n, b=8, l=64, seed=0):
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        lengths = torch.randint(4, l + 1, (b,), generator=gen)
        mask = (torch.arange(l)[None, :] < lengths[:, None]).to(torch.int32)
        ids = torch.randint(1, TINY_TRAIN["vocab_size"], (b, l), generator=gen)
        out.append({"input_ids": (ids * mask).to(torch.int32).numpy(),
                    "attention_mask": mask.numpy(),
                    "label": (ids[:, 0] % 2).to(torch.int32).numpy()})
    return out


def _graph_train(batches, loss_fn=None, seed=3, window=4):
    import functools

    from tpu_pipelines_torch.examples import bert_module
    from tpu_pipelines_torch.trainer import TrainLoopConfig, train_loop

    losses = []
    model, result = train_loop(
        loss_fn=loss_fn or bert_module.loss_fn,
        init_params_fn=functools.partial(bert_module.init_params_fn,
                                         hyperparameters=TINY_TRAIN),
        optimizer=bert_module.adamw(1e-3),
        train_iter=iter(batches),
        config=TrainLoopConfig(train_steps=len(batches), batch_size=8,
                               log_every=1, window_steps=window, seed=seed),
        metrics_cb=lambda s, m: losses.append(m["loss"]),
        device="cuda",
    )
    return model, result, losses


def test_graph_train_loop_equals_eager_steps_and_counts_launches_at_replay(cuda):
    from tpu_pipelines_torch.examples import bert_module
    from tpu_pipelines_torch.trainer.train_loop import step_generator

    batches = _train_batches(12)
    saved = {name: getattr(fa, name) for name in fa.COUNTERS}
    try:
        for name in fa.COUNTERS:
            setattr(fa, name, 0)
        model, result, losses = _graph_train(batches)
        counts = {name: getattr(fa, name) for name in fa.COUNTERS}
    finally:
        for name, value in saved.items():
            setattr(fa, name, value)
    want = TINY_TRAIN["n_layers"] * len(batches)
    assert counts == {"launches": want, "dq_launches": want, "dkv_launches": want,
                      "dvec_launches": want, "decode_launches": 0}
    assert result.compiles_after_warm == 0

    eager = bert_module.init_params_fn(torch.Generator().manual_seed(3),
                                       batches[0], TINY_TRAIN).to(cuda).train()
    opt = bert_module.adamw(1e-3)(eager.parameters())
    eager_losses = []
    for s, b in enumerate(batches):
        loss, _ = bert_module.loss_fn(
            eager, {k: torch.as_tensor(v, device=cuda) for k, v in b.items()},
            step_generator(3, s, cuda))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        eager_losses.append(loss.item())
    assert losses == eager_losses
    for (name, p), q in zip(model.named_parameters(), eager.parameters()):
        assert torch.equal(p, q), name


def test_a_capture_that_cannot_succeed_raises_instead_of_running_eagerly(cuda):
    from tpu_pipelines_torch.examples import bert_module

    calls = []

    def syncing_loss_fn(model, batch, generator):
        loss, metrics = bert_module.loss_fn(model, batch, generator)
        calls.append(loss.item())      # a host sync: no capture can hold it
        return loss, metrics

    with pytest.raises(RuntimeError,
                       match=r"capturing the training step .* step 1 .*input_ids"):
        _graph_train(_train_batches(4), loss_fn=syncing_loss_fn)
    assert len(calls) == 1             # the eager first step, then no other
