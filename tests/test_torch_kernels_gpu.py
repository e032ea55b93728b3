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
eagerly bit for bit (losses and parameters), two loops at once on two
threads hold side streams of their own and each equals its run alone,
the four attention counters
read layers x steps (counted at replay), each checkpoint the saver writes
from its thread equals the eager run's model and optimizer state at its
step bit for bit, a ResNet-18's captured steps equal its eager steps
with their BatchNorm running statistics, and a capture that cannot
succeed raises instead of running the step eagerly (kept last: a failed
capture is the one test here that leaves the context in an unusual
state).  Before them, a ResNet payload's bucket graphs replay its
eval-mode step bit for bit and leave its running statistics as they
were.  Between them, the
MoE BERT's captured train steps and its payload's bucket graphs
equal their eager runs bit for bit.  The
crossover measurement of ``chip_smoke.py`` records both crossovers for
the card's name, "auto" attention launches the kernels at or above a
recorded crossover and nothing below it, and a continuous controller's
tick on the card launches every training kernel inside its window
Trainer, and StatisticsGen's fork shard pool, forked after a kernel
launch, writes the thread pool's stats.json bytes (a killed worker
replaced).  A world of one over NCCL captures the data-parallel
psum_bucketed step with its all-reduces inside the graph, equal to its
eager steps bit for bit; two ranks on the one card share every
collective over gloo, and NCCL refuses them.  A speculating engine's
draft-step and verify-window graphs replay as its eager programs, its
arenas after the rejected-KV scrub equal the eager engine's bit for bit,
and a payload's ``torch.export`` artifact launches the forward kernel.
The decode kernel runs at a tensor-parallel T5 rank's shape (4 heads,
a 2048-key cache, the rank's bias rows), and a rank's whole-shape
dropout draw replays in a captured graph as the eager draw of its seed.
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


def _at_every_built_pair(op, cases, d_at=3, dtype_at=4):
    """Each case once per block pair its kernels are built for at its dtype
    and head dim (``fa.built_blocks``; ``flash_decode``: each built
    block_k), the pair last."""
    return [(*case, pair) for case in cases for pair in (
        fa.built_decode_blocks(case[dtype_at], case[d_at]) if op == "flash_decode"
        else fa.built_blocks(op, case[dtype_at], case[d_at]))]


@pytest.mark.parametrize(
    "b,l,h,d,dtype,causal,mask_kind,blocks",
    _at_every_built_pair("flash_fwd", [
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
        (2, 200, 4, 64, torch.bfloat16, True, "ragged"),
        (2, 130, 3, 128, torch.bfloat16, True, "ragged"),
    ]),
)
def test_kernel_matches_plain_version(cuda, b, l, h, d, dtype, causal, mask_kind,
                                      blocks):
    q, k, v, mask = _inputs(b, l, h, d, dtype, cuda, seed=l + d, mask_kind=mask_kind)
    pair = {"block_q": blocks[0], "block_k": blocks[1]}
    before = fa.launches
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal, kv_mask=mask,
                                          **pair)
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
    assert torch.equal(fa.flash_attention_forward(
        q, k, v, causal=causal, kv_mask=mask, **pair)[0], out)
    if l > 1:  # the mask shifted by one key must fail both checks
        wrong_out, wrong_lse = fa.flash_attention_forward(
            q, k, v, causal=causal, kv_mask=torch.roll(mask, 1, dims=1), **pair)
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
    "b,l,h,d,dtype,causal,mask_kind,strided,blocks",
    _at_every_built_pair("flash_bwd", [
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
        (2, 200, 4, 64, torch.bfloat16, True, "ragged", False),
        (2, 130, 3, 128, torch.bfloat16, True, "ragged", False),
    ]),
)
def test_backward_kernels_match_plain_versions(
    cuda, b, l, h, d, dtype, causal, mask_kind, strided, blocks
):
    q, k, v, dout, mask = _bwd_inputs(b, l, h, d, dtype, cuda, l + d, mask_kind,
                                      strided)
    pair = {"block_q": blocks[0], "block_k": blocks[1]}
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal, kv_mask=mask)
    before = (fa.dvec_launches, fa.dq_launches, fa.dkv_launches)
    dvec = fa.flash_bwd_dvec(out, dout)
    args = (q, k, v, dout, lse, dvec)
    dq = fa.flash_bwd_dq(*args, causal=causal, kv_mask=mask, **pair)
    dk, dv = fa.flash_bwd_dkv(*args, causal=causal, kv_mask=mask, **pair)
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
    assert torch.equal(fa.flash_bwd_dq(*args, causal=causal, kv_mask=mask,
                                       **pair), dq)
    assert all(torch.equal(a, b) for a, b in zip(fa.flash_bwd_dkv(
        *args, causal=causal, kv_mask=mask, **pair), (dk, dv)))
    if mask is not None:  # the mask shifted by one key must fail the bound
        shifted = torch.roll(mask, 1, dims=1)
        wrong = (fa.flash_bwd_dq(*args, causal=causal, kv_mask=shifted, **pair),
                 *fa.flash_bwd_dkv(*args, causal=causal, kv_mask=shifted, **pair))
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
        # A kernel of no interest first: the session's first device event
        # can go unrecorded (seen on the card with only the dq kernel
        # before dk/dv).
        torch.zeros(1, device=cuda).add_(1)
        torch.cuda.synchronize()
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
    "b,l,h,d,dtype,bias_kind,arena,block_k",
    _at_every_built_pair("flash_decode", [
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
        (4, 2048, 8, 128, torch.float16, "per_row", False),
    ]),
)
def test_decode_kernel_matches_plain_version(cuda, b, l, h, d, dtype,
                                             bias_kind, arena, block_k):
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
    out = fa.flash_decode_attention(q, k, v, kv_mask=mask, bias=bias,
                                    block_k=block_k)
    torch.cuda.synchronize()
    assert fa.decode_launches == before + 1
    ref = fa.flash_decode_attention_reference(q, k, v, kv_mask=mask, bias=bias)
    assert out.dtype == dtype and out.shape == (b, 1, h, d)
    assert _within(out, ref, OUT_TOL[dtype])
    assert out[-1].abs().max().item() == 0.0
    # A bool mask is the same mask; no mask attends to every key.
    assert torch.equal(fa.flash_decode_attention(q, k, v, kv_mask=mask > 0,
                                                 bias=bias, block_k=block_k), out)
    full = fa.flash_decode_attention(q, k, v, bias=bias, block_k=block_k)
    assert _within(full, fa.flash_decode_attention_reference(q, k, v, bias=bias),
                   OUT_TOL[dtype])
    # Two launches agree bit for bit (the splits merge in rank order).
    assert torch.equal(fa.flash_decode_attention(q, k, v, kv_mask=mask,
                                                 bias=bias, block_k=block_k), out)


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
    with pytest.raises(ValueError, match="block_k"):   # none built <= 16
        fa.flash_decode_attention(q, k, v, block_k=16)
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


# ---- the serving fleet's captured steps (serving/aot.py, the engine)

# A tiny BERT with the forward kernel's head_dim 64, bf16 compute.
TINY_SERVE = {"vocab_size": 128, "d_model": 128, "n_layers": 2, "n_heads": 2,
              "d_ff": 256, "max_len": 64, "dropout_rate": 0.0,
              "num_classes": 3, "attn_impl": "flash"}


def test_each_configurations_resources_and_the_table_blocks_on_the_card(
        cuda, tmp_path, monkeypatch):
    from tpu_pipelines_torch.ops import _build, autotune

    for bq, bk in fa.FLASH_BLOCKS:
        for d in fa.BLOCK_HEAD_DIMS:
            info = fa.fwd_kernel_info(torch.bfloat16, d, 128, bq, bk)
            assert info["shared_bytes"] == fa.smem_bytes("fwd", bq, bk, d) + 16
            for kernel in ("dq", "dkv"):
                info = fa.bwd_kernel_info(kernel, torch.bfloat16, d, 128, bq, bk)
                assert info["shared_bytes"] == fa.smem_bytes(kernel, bq, bk, d) + (
                    16 if kernel == "dq" else 0)
    for block_k in fa.DECODE_BLOCKS:
        assert fa.decode_kernel_info(torch.bfloat16, 64, 8, block_k)[
            "max_active_clusters"] >= 1
    # A library refuses any pair but its own, and f32 outside 64 x 64.
    lib = _build.load("flash_attention", fa._PROTOTYPES, {"TPP_BQ": 128, "TPP_BK": 64})
    info = (fa.ctypes.c_int * 3)()
    assert lib.tpp_flash_fwd_kernel_info(2, 64, 128, 64, 64, info) != 0
    assert lib.tpp_flash_fwd_kernel_info(0, 64, 128, 128, 64, info) != 0
    assert lib.tpp_flash_fwd_kernel_info(2, 32, 128, 128, 64, info) != 0
    # A table entry's blocks launch on the card.
    monkeypatch.setenv("TPP_AUTOTUNE_CACHE", str(tmp_path))
    autotune.clear_memo()
    kind = autotune.current_device_kind(cuda)
    q, k, v, mask = _inputs(2, 200, 4, 64, torch.bfloat16, cuda, seed=9)
    for op, blocks in (("flash_fwd", (128, 32)), ("flash_bwd", (64, 128))):
        autotune.record_entry(autotune.make_key(op, 2, 4, 200, 64, torch.bfloat16,
                                                False, kind), *blocks, ms=1.0)
    seen = []
    real = _build.load
    monkeypatch.setattr(_build, "load", lambda name, protos, defines=(): (
        seen.append((name, dict(defines))), real(name, protos, defines))[1])
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention(*leaves, kv_mask=mask).float().sum().backward()
    assert ("flash_attention", {"TPP_BQ": 128, "TPP_BK": 32}) in seen
    assert ("flash_attention_bwd", {"TPP_BQ": 64, "TPP_BK": 128}) in seen
    autotune.clear_memo()


def _served_bert(tmp_path, cuda):
    import os

    from tpu_pipelines_torch.examples import bert_module
    from tpu_pipelines_torch.models.bert import build_bert_model, init_bert_weights
    from tpu_pipelines_torch.trainer.export import export_model, load_exported_model

    model = init_bert_weights(build_bert_model(TINY_SERVE),
                              torch.Generator().manual_seed(0))
    export_model(serving_model_dir=str(tmp_path / "1"),
                 params=model.state_dict(),
                 module_file=os.path.abspath(bert_module.__file__),
                 hyperparameters=TINY_SERVE)
    return load_exported_model(str(tmp_path / "1"), device=cuda)


def _bert_rows(n, seed, l=48):
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = np.zeros((n, l), np.int64)
    for i in range(n):
        k = int(rng.integers(4, l + 1))
        ids[i, :k] = rng.integers(1, TINY_SERVE["vocab_size"], size=k)
    return {"input_ids": ids, "attention_mask": (ids > 0).astype(np.int64)}


def _eager(loaded, batch):
    from tpu_pipelines_torch.trainer.export import on_device

    return loaded.device_step(loaded.params, on_device(batch, loaded.device)) \
        .float().cpu().numpy()


def test_predict_bucket_graph_replay_equals_eager_bit_for_bit(cuda, tmp_path):
    import numpy as np

    from tpu_pipelines_torch.serving import aot

    loaded = _served_bert(tmp_path, cuda)
    stats = aot.warm_loaded(loaded, _bert_rows(1, 0), 8)
    assert stats["buckets"] == [1, 2, 4, 8] and stats["compiled"] == 4
    assert stats["fallback_warm"] is False and stats["cache_hits"] == 0
    for b in stats["buckets"]:
        batch = _bert_rows(b, seed=b)
        assert loaded.aot.lookup("raw", batch) is not None
        assert np.array_equal(loaded.predict(batch), _eager(loaded, batch))
        assert np.array_equal(loaded.predict_transformed(batch),
                              _eager(loaded, batch))
    assert loaded.aot.compiles_after_warm == 0
    # A shape no bucket holds runs eagerly and counts once per signature.
    odd = _bert_rows(3, seed=9, l=40)
    for _ in range(2):
        assert np.array_equal(loaded.predict(odd), _eager(loaded, odd))
    assert loaded.aot.compiles_after_warm == 1 and loaded.aot.fallbacks == 2


def test_an_int8_payloads_resident_bytes_and_bucket_graphs(cuda, tmp_path):
    """An int8 payload stays int8 on the card: every quantized weight is an
    int8 tensor plus its scales there, no float copy of it is resident (the
    allocation the load adds is the payload's bytes, within 1 MiB of
    allocator rounding), and each padded bucket's graph, which holds the
    dequantization, replays the eager step bit for bit."""
    import gc
    import os

    import numpy as np

    from tpu_pipelines_torch.examples import bert_module
    from tpu_pipelines_torch.models.bert import build_bert_model, init_bert_weights
    from tpu_pipelines_torch.serving import aot
    from tpu_pipelines_torch.trainer import quantize as qz
    from tpu_pipelines_torch.trainer.export import export_model, load_exported_model

    model = init_bert_weights(build_bert_model(TINY_SERVE),
                              torch.Generator().manual_seed(0))
    state, _ = qz.quantize_params(model.state_dict(), qz.channel_layouts(model))
    export_model(serving_model_dir=str(tmp_path / "1"), params=state,
                 module_file=os.path.abspath(bert_module.__file__),
                 hyperparameters=TINY_SERVE, serving_dtype="aqt_int8")
    gc.collect()
    before = torch.cuda.memory_allocated(cuda)
    loaded = load_exported_model(str(tmp_path / "1"), device=cuda)
    added = torch.cuda.memory_allocated(cuda) - before
    names = qz.quantized_names(state)
    assert all(loaded.params[n + qz.QVALUE].dtype == torch.int8
               and loaded.params[n + qz.QVALUE].is_cuda for n in names)
    assert not set(names) & set(loaded.params)
    assert loaded.params_bytes == qz.params_nbytes(state)
    assert abs(added - loaded.params_bytes) <= 1 << 20
    stats = aot.warm_loaded(loaded, _bert_rows(1, 0), 8)
    assert stats["buckets"] == [1, 2, 4, 8] and stats["fallback_warm"] is False
    for b in stats["buckets"]:
        batch = _bert_rows(b, seed=b)
        assert np.array_equal(loaded.predict(batch), _eager(loaded, batch))


def test_a_counted_step_on_the_card_counts_the_cpus_flops(cuda):
    """``count_step_flops`` of the same tiny BERT step (flash attention,
    bf16) gives the same figure on the card, where the kernels cannot be
    seen by ``FlopCounterMode``, as on the CPU, where the plain version's
    products are kept out of it."""
    import numpy as np

    from tpu_pipelines_torch.examples import bert_module
    from tpu_pipelines_torch.models.bert import build_bert_model, init_bert_weights
    from tpu_pipelines_torch.trainer.train_loop import count_step_flops

    rows = _bert_rows(4, seed=3)
    rows["label"] = np.arange(4) % TINY_SERVE["num_classes"]
    counts = {}
    for device in ("cpu", cuda):
        model = init_bert_weights(build_bert_model(TINY_SERVE),
                                  torch.Generator().manual_seed(0)).to(device)
        batch = {k: torch.as_tensor(v, device=device) for k, v in rows.items()}
        before = fa.launches
        counts[str(device)] = count_step_flops(model, bert_module.loss_fn, batch)
        if str(device) != "cpu":
            assert fa.launches - before == TINY_SERVE["n_layers"]
    assert counts["cpu"] == counts["cuda"] > 0


def test_a_resnet_payloads_bucket_graphs_serve_the_running_averages(
        cuda, tmp_path):
    """A ResNet payload (BatchNorm buffers in its state dict) loads onto the
    card, each padded bucket's graph replays the eval-mode step bit for bit,
    and no replay moves the running statistics."""
    import os

    import numpy as np

    from tpu_pipelines_torch.examples import resnet_module
    from tpu_pipelines_torch.serving import aot
    from tpu_pipelines_torch.trainer.export import export_model, load_exported_model

    hp = {"depth": 18, "width": 16, "num_classes": 10, "image_size": 32}
    model = resnet_module.build_model(hp).train()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        model(torch.randn(16, 32, 32, 3, generator=gen))
    export_model(serving_model_dir=str(tmp_path / "1"), params=model.state_dict(),
                 module_file=os.path.abspath(resnet_module.__file__),
                 hyperparameters=hp)
    loaded = load_exported_model(str(tmp_path / "1"), device=cuda)
    buffers = {k: v.clone() for k, v in loaded.params.items() if "running" in k}
    assert buffers and all(v.device.type == "cuda" for v in buffers.values())
    rows = lambda n: {"image": torch.randn(n, 32 * 32 * 3,  # noqa: E731
                                           generator=gen).numpy()}
    stats = aot.warm_loaded(loaded, rows(1), 8)
    assert stats["compiled"] == 4 and not stats["fallback_warm"]
    for b in stats["buckets"]:
        batch = rows(b)
        assert loaded.aot.lookup("raw", batch) is not None
        assert np.array_equal(loaded.predict(batch), _eager(loaded, batch))
    assert not loaded.model.training and loaded.aot.compiles_after_warm == 0
    for k, v in buffers.items():
        assert torch.equal(loaded.params[k], v), k


def test_the_fleets_boot_version_serves_from_graphs_captured_on_its_first_batch(
        cuda, tmp_path):
    import numpy as np

    from tpu_pipelines_torch.serving.fleet import ServingFleet

    _served_bert(tmp_path, cuda)
    fleet = ServingFleet("bert", str(tmp_path), replicas=2, max_versions=2,
                         max_batch_size=8, device=cuda)
    try:
        fleet.reload()
        loaded = fleet.active_loaded()
        assert loaded.aot.entries == {} and fleet.last_warm is None
        rows = _bert_rows(4, seed=7)
        got = fleet.submit(rows, 4)
        assert fleet.last_warm["compiled"] == len(fleet.last_warm["buckets"])
        assert fleet.last_warm["fallback_warm"] is False
        assert np.array_equal(got, _eager(loaded, rows))
        for b in (1, 2, 5):
            batch = _bert_rows(b, seed=20 + b)
            fleet.submit(batch, b)
        assert loaded.aot.compiles_after_warm == 0
    finally:
        fleet.close()


def test_two_replica_threads_replaying_at_once_equal_sequential_eager(
        cuda, tmp_path):
    import threading

    import numpy as np

    from tpu_pipelines_torch.serving import aot

    loaded = _served_bert(tmp_path, cuda)
    aot.warm_loaded(loaded, _bert_rows(1, 0), 8)
    batches = [_bert_rows([1, 2, 4, 8][i % 4], seed=100 + i) for i in range(32)]
    want = [_eager(loaded, b) for b in batches]
    got = [None] * len(batches)

    def replica(offset):
        stream = torch.cuda.Stream(cuda)
        with torch.cuda.stream(stream):
            for i in range(offset, len(batches), 2):
                got[i] = loaded.predict(batches[i])

    threads = [threading.Thread(target=replica, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert loaded.aot.compiles_after_warm == 0


def test_capture_records_the_flash_launches_and_a_replay_credits_them(
        cuda, tmp_path):
    from tpu_pipelines_torch.serving import aot

    loaded = _served_bert(tmp_path, cuda)
    aot.warm_loaded(loaded, _bert_rows(1, 0), 4)
    steps = [loaded.aot.lookup("raw", _bert_rows(b, 0)) for b in (1, 2, 4)]
    assert all(s.tally["launches"] == TINY_SERVE["n_layers"] for s in steps)
    before = fa.launches
    for b in (1, 2, 4, 4, 2):
        loaded.predict(_bert_rows(b, seed=b))
    assert fa.launches - before == 5 * TINY_SERVE["n_layers"]


def test_engine_graph_tokens_equal_the_eager_engine(cuda, monkeypatch):
    """The engine's captured (batch, kv) steps emit the streams the same
    engine emits stepping eagerly, on one schedule (every sequence queued
    before the worker's first round), and credit the decode kernel per
    replay."""
    import threading

    import numpy as np

    from tpu_pipelines_torch.models import t5 as pt5
    from tpu_pipelines_torch.serving.generative import GenerativeEngine

    model = pt5.T5(vocab_size=64, d_model=32, n_layers=2, n_heads=2,
                   head_dim=16, d_ff=64, dropout_rate=0.0, dtype=torch.float32,
                   attn_impl="flash")
    pt5.init_t5_weights(model, torch.Generator().manual_seed(0))
    model = model.to(cuda).eval()
    params = dict(model.state_dict())
    fns = pt5.make_continuous_decode_fns(model, max_decode_len=24, eos_id=1,
                                         max_input_len=12)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, 64, size=int(rng.integers(3, 13)))
               for _ in range(6)]
    budgets = [int(m) for m in rng.integers(4, 24, size=6)]

    def run(eager):
        gate = threading.Event()
        engine = GenerativeEngine(fns, params, device=cuda, max_batch_size=4,
                                  page_size=8, fault_hook=lambda: gate.wait(30))
        if eager:
            monkeypatch.setattr(engine, "_capture", lambda *a: None)
        try:
            engine.warm()
            assert len(engine._target.graphs) == (0 if eager else 3 * 3)
            before = fa.decode_launches
            handles = [engine.submit_nowait(p, max_new_tokens=m)
                       for p, m in zip(prompts, budgets)]
            gate.set()
            streams = [h.wait(60).tolist() for h in handles]
            launches = fa.decode_launches - before
            return (streams, launches, engine.steps_run, engine.prefills_run,
                    engine.compiles_after_warm)
        finally:
            engine.close()

    graph, eager = run(False), run(True)
    assert graph[0] == eager[0]
    _, launches, steps, prefills, compiles = graph
    assert compiles == 0 and prefills == 6
    assert launches == 2 * (steps + prefills)


def _spec_engine(cuda, eager, monkeypatch, gate):
    """A tiny f32 T5 engine speculating 3 tokens with a perturbed draft (so
    rounds reject proposals), captured or (``eager``) stepping eagerly."""
    import numpy as np

    from tpu_pipelines_torch.models import t5 as pt5
    from tpu_pipelines_torch.serving.generative import GenerativeEngine

    model = pt5.T5(vocab_size=64, d_model=32, n_layers=2, n_heads=2,
                   head_dim=16, d_ff=64, dropout_rate=0.0, dtype=torch.float32,
                   attn_impl="flash")
    pt5.init_t5_weights(model, torch.Generator().manual_seed(0))
    model = model.to(cuda).eval()
    params = dict(model.state_dict())
    g = torch.Generator().manual_seed(1)
    draft = {n: t + 0.3 * torch.randn(t.shape, generator=g).to(cuda)
             if t.is_floating_point() else t for n, t in params.items()}
    fns = pt5.make_continuous_decode_fns(model, max_decode_len=24, eos_id=1,
                                         max_input_len=12)
    engine = GenerativeEngine(fns, params, device=cuda, max_batch_size=4,
                              page_size=8, spec_tokens=3, draft_params=draft,
                              fault_hook=lambda: gate.wait(30))
    if eager:
        monkeypatch.setattr(engine, "_capture", lambda *a: None)
        monkeypatch.setattr(engine, "_capture_verify", lambda *a: None)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, 64, size=int(rng.integers(3, 13)))
               for _ in range(6)]
    budgets = [int(m) for m in rng.integers(6, 24, size=6)]
    return engine, prompts, budgets


def _spec_run(cuda, eager, monkeypatch):
    import threading

    gate = threading.Event()
    engine, prompts, budgets = _spec_engine(cuda, eager, monkeypatch, gate)
    try:
        engine.warm()
        before = fa.decode_launches
        handles = [engine.submit_nowait(p, max_new_tokens=m)
                   for p, m in zip(prompts, budgets)]
        gate.set()
        streams = [h.wait(60).tolist() for h in handles]
        launches = fa.decode_launches - before
    finally:
        engine.close()
    return engine, streams, launches


def test_a_speculative_engines_graphs_replay_as_its_eager_steps(cuda,
                                                                monkeypatch):
    """Every (batch, kv) bucket's draft step and verify window is a CUDA
    graph; on one schedule the captured engine emits the eager engine's
    streams and acceptances, and one draft-step and one verify-window
    replay each equal the same program run eagerly on the arena's state
    bit for bit."""
    graph, streams, launches = _spec_run(cuda, False, monkeypatch)
    eager, e_streams, e_launches = _spec_run(cuda, True, monkeypatch)
    assert streams == e_streams and launches == e_launches
    assert (graph.spec_proposed, graph.spec_accepted) == (
        eager.spec_proposed, eager.spec_accepted)
    assert graph.spec_accepted < graph.spec_proposed  # the draft is wrong
    assert graph.compiles_after_warm == 0
    assert (len(graph._target.graphs), len(graph._draft.graphs),
            len(graph._verify_graphs)) == (9, 9, 9)
    runs = graph.program_runs
    assert graph.replay_launches == {"target": 2 * runs["target"],
                                     "draft": 2 * runs["draft"], "verify": 0}
    assert launches == 2 * (2 * graph.prefills_run + runs["target"]
                            + runs["draft"])

    def state(lane):
        cache, *rest = lane.arena
        return ({n: a.clone() for n, a in cache.items()},
                *(a.clone() for a in rest))

    def restore(lane, saved):
        cache, *rest = lane.arena
        for n, a in cache.items():
            a.copy_(saved[0][n])
        for a, b in zip(rest, saved[1:]):
            a.copy_(b)

    def same(a, b):
        return all(torch.equal(a[0][n], b[0][n]) for n in a[0]) and all(
            torch.equal(x, y) for x, y in zip(a[1:], b[1:]))

    with torch.inference_mode():
        for lane, key in ((graph._draft, (4, 16)), (graph._target, (2, 8))):
            saved = state(lane)
            lane.graphs[key][0].replay()
            torch.cuda.synchronize(cuda)
            replayed, nxt = state(lane), lane.graphs[key][1].clone()
            restore(lane, saved)
            want, _ = graph._run_step(lane.arena, *key, lane)
            assert torch.equal(nxt, want) and same(replayed, state(lane))
        graph._toks.copy_(torch.randint(2, 64, graph._toks.shape,
                                        generator=torch.Generator().manual_seed(2))
                          .to(cuda))
        saved = state(graph._target)
        graph._verify_graphs[(4, 24)][0].replay()
        torch.cuda.synchronize(cuda)
        replayed, g = state(graph._target), graph._verify_graphs[(4, 24)][1].clone()
        restore(graph._target, saved)
        want = graph._run_verify(graph._target.arena, graph._toks, 4, 24)
        assert torch.equal(g, want) and same(replayed, state(graph._target))


def test_the_rejected_kv_scrub_leaves_the_arena_as_eager_does(cuda,
                                                              monkeypatch):
    """With a draft the target rejects, the captured engine's arenas (the
    target's and the draft lane's, after every accept's scrub) end equal to
    the eager engine's bit for bit, and every self-attention position at or
    past a live row's position is zero."""
    graph, streams, _ = _spec_run(cuda, False, monkeypatch)
    eager, e_streams, _ = _spec_run(cuda, True, monkeypatch)
    assert streams == e_streams and graph.spec_accepted < graph.spec_proposed
    for lane, e_lane in ((graph._target, eager._target),
                         (graph._draft, eager._draft)):
        for a, b in zip(lane.arena[1:], e_lane.arena[1:]):
            assert torch.equal(a, b)
        for name, a in lane.arena[0].items():
            assert torch.equal(a, e_lane.arena[0][name]), (lane.name, name)
    # A fresh accept on the captured engine scrubs past each new position.
    import numpy as np

    with torch.inference_mode():
        new_pos = np.array([5, 0, 11, 24], np.int64)
        graph._sync_lane(graph._draft, np.zeros(4, np.int64), new_pos)
        for name, a in graph._draft.arena[0].items():
            if "cached_enc" in name:
                continue
            for row, p in enumerate(new_pos):
                assert not a[row, p:].any(), (name, row)


def test_the_torch_export_artifact_launches_flash_fwd(cuda, tmp_path):
    """A BERT payload's device step exported with a symbolic batch and
    loaded again: on CUDA tensors it launches the forward kernel once per
    layer per call and equals the payload's ``predict_transformed`` bit
    for bit at two batch sizes."""
    import numpy as np

    from tpu_pipelines_torch.models.bert import build_bert_model, init_bert_weights
    from tpu_pipelines_torch.serving.saved_model import (
        export_saved_model,
        load_saved_model,
    )
    from tpu_pipelines_torch.trainer.export import (
        export_model,
        load_exported_model,
    )

    import os

    module = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                          "tpu_pipelines_torch", "examples", "bert_module.py")
    hp = {**TINY_TRAIN, "dropout_rate": 0.0}
    model = init_bert_weights(build_bert_model(hp),
                              torch.Generator().manual_seed(0))
    payload = export_model(serving_model_dir=str(tmp_path / "1"),
                           params=model.state_dict(), module_file=module,
                           hyperparameters=hp)

    def batch(n, seed):
        rng = np.random.default_rng(seed)
        ids = np.zeros((n, 64), np.int64)
        for i in range(n):
            k = int(rng.integers(4, 65))
            ids[i, :k] = rng.integers(1, hp["vocab_size"], size=k)
        return {"input_ids": ids, "attention_mask": (ids > 0).astype(np.int32)}

    out = export_saved_model(payload, str(tmp_path / "artifact"), batch(4, 0),
                             device=cuda)
    run = load_saved_model(out)
    loaded = load_exported_model(payload, device=cuda)
    for n in (3, 8):
        b = batch(n, n)
        before = fa.launches
        got = run(b)
        torch.cuda.synchronize(cuda)
        assert fa.launches - before == hp["n_layers"]
        assert got.device.type == "cuda"
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      loaded.predict_transformed(b))


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


def _graph_train(batches, loss_fn=None, seed=3, window=4, **loop_kwargs):
    import functools

    from tpu_pipelines_torch.examples import bert_module
    from tpu_pipelines_torch.trainer import TrainLoopConfig, train_loop

    losses = []
    model, result = train_loop(
        loss_fn=loss_fn or bert_module.loss_fn,
        init_params_fn=loop_kwargs.pop("init_params_fn", functools.partial(
            bert_module.init_params_fn, hyperparameters=TINY_TRAIN)),
        optimizer=bert_module.adamw(1e-3),
        train_iter=iter(batches),
        config=TrainLoopConfig(train_steps=len(batches), batch_size=8,
                               log_every=1, window_steps=window, seed=seed,
                               checkpoint_every=loop_kwargs.pop(
                                   "checkpoint_every", 0)),
        metrics_cb=lambda s, m: losses.append(m["loss"]),
        device="cuda",
        **loop_kwargs,
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


TINY_MOE = {**TINY_TRAIN, "moe_experts": 4}


def _moe_loss_fn(model, batch, generator):
    """The reference's MoE objective (tests/test_moe.py): cross-entropy
    plus 0.01 x the load-balancing loss."""
    import torch.nn.functional as F

    from tpu_pipelines_torch.models.transformer import apply_with_moe_aux

    features = {k: v for k, v in batch.items() if k != "label"}
    logits, aux = apply_with_moe_aux(model, features, generator=generator)
    loss = F.cross_entropy(logits.float(), batch["label"].long()) + 0.01 * aux
    return loss, {"moe_aux": aux}


def test_an_moe_graph_train_loop_equals_eager_steps(cuda):
    """BERT with experts on its odd layers: the routing (argmax, cumsum,
    one-hots against arange) reads nothing on the host, so the step is
    captured once and replayed, and the replays equal the same steps run
    eagerly bit for bit (losses and parameters, experts included)."""
    import functools

    from tpu_pipelines_torch.examples import bert_module
    from tpu_pipelines_torch.trainer.train_loop import step_generator

    batches = _train_batches(8)
    init = functools.partial(bert_module.init_params_fn, hyperparameters=TINY_MOE)
    model, result, losses = _graph_train(batches, loss_fn=_moe_loss_fn,
                                         init_params_fn=init)
    assert result.step_capture == "cuda_graph" and result.compiles_after_warm == 0
    eager = init(torch.Generator().manual_seed(3), batches[0]).to(cuda).train()
    opt = bert_module.adamw(1e-3)(eager.parameters())
    eager_losses = []
    for s, b in enumerate(batches):
        loss, _ = _moe_loss_fn(
            eager, {k: torch.as_tensor(v, device=cuda) for k, v in b.items()},
            step_generator(3, s, cuda))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        eager_losses.append(loss.item())
    assert losses == eager_losses
    for (name, p), q in zip(model.named_parameters(), eager.parameters()):
        assert torch.equal(p, q), name
    assert "encoder.layers.1.moe.wi" in dict(model.named_parameters())


def test_an_moe_payloads_bucket_graphs_replay_as_eager(cuda, tmp_path):
    """An MoE BERT payload's bucket graphs (batch 1..8) give its eager
    step's logits bit for bit, with no compile after warm-up."""
    import os

    import numpy as np

    from tpu_pipelines_torch.examples import bert_module
    from tpu_pipelines_torch.models.bert import build_bert_model, init_bert_weights
    from tpu_pipelines_torch.serving import aot
    from tpu_pipelines_torch.trainer.export import export_model, load_exported_model

    hp = {**TINY_SERVE, "moe_experts": 4}
    model = init_bert_weights(build_bert_model(hp), torch.Generator().manual_seed(0))
    export_model(serving_model_dir=str(tmp_path / "1"), params=model.state_dict(),
                 module_file=os.path.abspath(bert_module.__file__),
                 hyperparameters=hp)
    loaded = load_exported_model(str(tmp_path / "1"), device=cuda)
    stats = aot.warm_loaded(loaded, _bert_rows(1, 0), 8)
    assert stats["buckets"] == [1, 2, 4, 8] and stats["compiled"] == 4
    for b in stats["buckets"]:
        batch = _bert_rows(b, seed=b)
        assert loaded.aot.lookup("raw", batch) is not None
        assert np.array_equal(loaded.predict(batch), _eager(loaded, batch))
    assert loaded.aot.compiles_after_warm == 0


def test_a_graph_train_loop_captures_while_another_thread_works_the_card(cuda):
    """A serving fleet in the same process keeps launching and syncing on
    its own streams while the train loop captures its step (the continuous
    controller's window Trainer beside the fleet): the capture succeeds,
    and the graph run's losses equal those of the same run with the card
    otherwise idle, bit for bit."""
    import threading

    batches = _train_batches(6, seed=7)
    _, quiet, quiet_losses = _graph_train(batches, window=2)
    stop, errors, rounds = threading.Event(), [], [0]

    def busy():
        stream = torch.cuda.Stream(cuda)
        x = torch.zeros(1024, device=cuda)
        try:
            while not stop.is_set():
                with torch.cuda.stream(stream):
                    x.add_(1.0)
                stream.synchronize()
                rounds[0] += 1
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    worker = threading.Thread(target=busy)
    worker.start()
    try:
        _, result, losses = _graph_train(batches, window=2)
    finally:
        stop.set()
        worker.join()
    assert errors == [] and rounds[0] > 0
    assert result.compiles_after_warm == quiet.compiles_after_warm == 0
    assert losses == quiet_losses


def test_two_graph_train_loops_at_once_hold_their_own_side_streams(
        cuda, monkeypatch):
    """Two train loops on two threads at once (a deadline-released Trainer
    beside its successor): each takes a side stream of its own, so neither
    loop's eager first step lands in the graph the other captures, and
    each run's losses equal the same run alone, bit for bit.  A run after
    them takes one of their streams back."""
    import importlib
    import threading

    tl = importlib.import_module("tpu_pipelines_torch.trainer.train_loop")

    runs = {"a": _train_batches(6, seed=11), "b": _train_batches(6, seed=12)}
    alone = {k: _graph_train(b, window=2)[2] for k, b in runs.items()}
    both = threading.Barrier(2, timeout=120)
    taken, real_take = [], tl._take_side_stream

    def take(device):
        stream = real_take(device)
        taken.append(stream)
        if len(taken) <= 2:
            both.wait()      # both loops hold their streams before either steps
        return stream

    monkeypatch.setattr(tl, "_take_side_stream", take)
    got, errors = {}, []

    def run(key):
        try:
            got[key] = _graph_train(runs[key], window=2)[2]
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(k,)) for k in runs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert taken[0] is not taken[1]
    assert got == alone
    _graph_train(runs["a"], window=2)
    assert any(taken[2] is s for s in taken[:2])


def test_async_checkpoints_equal_the_eager_state_at_their_step_under_replay(
        cuda, tmp_path):
    import threading

    from tpu_pipelines_torch.examples import bert_module
    from tpu_pipelines_torch.trainer.train_loop import step_generator

    batches = _train_batches(12)
    _graph_train(batches, checkpoint_dir=str(tmp_path), checkpoint_every=4)
    assert not [t for t in threading.enumerate()
                if t.name == "tpp-async-ckpt"]
    eager = bert_module.init_params_fn(torch.Generator().manual_seed(3),
                                       batches[0], TINY_TRAIN).to(cuda).train()
    opt = bert_module.adamw(1e-3)(eager.parameters())
    for s, b in enumerate(batches):
        loss, _ = bert_module.loss_fn(
            eager, {k: torch.as_tensor(v, device=cuda) for k, v in b.items()},
            step_generator(3, s, cuda))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if (s + 1) % 4:
            continue
        saved = torch.load(tmp_path / f"ckpt_{s + 1}.pt", map_location=cuda,
                           weights_only=True)
        assert saved["step"] == s + 1
        for name, value in eager.state_dict().items():
            assert torch.equal(saved["model"][name], value), (s + 1, name)
        want = opt.state_dict()["state"]
        assert sorted(saved["optimizer"]["state"]) == sorted(want)
        for i, state in want.items():
            for key, value in state.items():
                assert torch.equal(saved["optimizer"]["state"][i][key].to(
                    value.device), value), (s + 1, i, key)


def test_crossover_measurement_records_both_for_the_card(cuda, tmp_path,
                                                         monkeypatch):
    import chip_smoke

    from tpu_pipelines_torch.ops import autotune

    monkeypatch.setenv("TPP_AUTOTUNE_CACHE", str(tmp_path))
    autotune.clear_memo()
    measured = chip_smoke.crossover_phase(torch.Generator().manual_seed(0),
                                          "test")
    kind = torch.cuda.get_device_name(0)
    rec = measured["crossover"][kind]
    drec = measured["decode_crossover"][kind]
    assert autotune.lookup_crossover(kind) == rec["crossover_seq_len"]
    assert autotune.lookup_decode_crossover(kind) == drec["crossover_kv_len"]
    assert sorted(map(int, rec["geometry"]["per_len"])) == list(
        chip_smoke.CROSS_TRAIN_LENS)
    assert sorted(map(int, drec["geometry"]["per_kv_len"])) == list(
        chip_smoke.CROSS_DECODE_LENS)
    # 8192 keys: dense does not fit, so flash runs and the crossover exists.
    assert rec["crossover_seq_len"] is not None
    autotune.clear_memo()


def test_auto_launches_the_kernels_at_or_above_a_crossover_and_not_below(
        cuda, tmp_path, monkeypatch):
    from tpu_pipelines_torch.ops import autotune

    monkeypatch.setenv("TPP_AUTOTUNE_CACHE", str(tmp_path))
    autotune.clear_memo()
    kind = autotune.current_device_kind(cuda)
    autotune.record_crossover(kind, 128, source="test")
    autotune.record_decode_crossover(kind, 128, source="test")
    torch.manual_seed(0)
    layer = MultiHeadAttention(64, 2, 32, attn_impl="auto").to(cuda).eval()
    saved = {name: getattr(fa, name) for name in fa.COUNTERS}
    try:
        for l, want in ((64, 0), (127, 0), (128, 1), (256, 1)):
            fa.launches = 0
            with torch.inference_mode():
                layer(torch.randn(2, l, 64, device=cuda))
            assert fa.launches == want, l
        for kv, want in ((64, 0), (128, 1), (512, 1)):
            fa.decode_launches = 0
            cache = {}
            with torch.inference_mode():
                layer(torch.randn(2, 1, 64, device=cuda), decode_pos=0,
                      max_decode_len=kv, cache=cache, cache_prefix="l0")
            assert fa.decode_launches == want, kv
    finally:
        for name, value in saved.items():
            setattr(fa, name, value)
        autotune.clear_memo()


def test_a_pipeline_payloads_buckets_capture_with_its_transform(cuda, tmp_path):
    """A payload exported with a transform graph (the BERT twin's
    tokenizer and its device-side mask and label cast) captures every
    bucket, its graph's constants made before the capture, and each
    replay of raw text equals the eager step bit for bit."""
    import os

    import numpy as np

    from tpu_pipelines_torch.data.schema import Feature, FeatureType, Schema
    from tpu_pipelines_torch.examples import bert_module, bert_preprocessing
    from tpu_pipelines_torch.models.bert import build_bert_model, init_bert_weights
    from tpu_pipelines_torch.serving import aot
    from tpu_pipelines_torch.trainer.export import export_model, load_exported_model
    from tpu_pipelines_torch.transform.graph import TransformGraph

    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(60)]
    texts = np.asarray([" ".join(rng.choice(words, int(rng.integers(3, 30))))
                        for _ in range(64)], dtype=object)
    data = {"text": texts, "label": rng.integers(0, 2, 64)}
    graph = TransformGraph.build(bert_preprocessing.preprocessing_fn, Schema({
        "text": Feature("text", FeatureType.BYTES),
        "label": Feature("label", FeatureType.INT)}))
    graph.analyze_chunks(lambda: iter([data]), device="cpu")
    graph.save(str(tmp_path / "graph"))
    hp = {**TINY_SERVE, "num_classes": 2}
    model = init_bert_weights(build_bert_model(hp),
                              torch.Generator().manual_seed(0))
    export_model(serving_model_dir=str(tmp_path / "1"),
                 params=model.state_dict(),
                 module_file=os.path.abspath(bert_module.__file__),
                 hyperparameters=hp, transform_graph_uri=str(tmp_path / "graph"))
    loaded = load_exported_model(str(tmp_path / "1"), device=cuda)

    def rows(b, seed):
        pick = np.random.default_rng(seed).integers(0, 64, b)
        return {"text": texts[pick], "label": data["label"][pick]}

    stats = aot.warm_loaded(loaded, rows(1, 0), 8)
    assert stats["compiled"] == len(stats["buckets"]) and not stats["fallback_warm"]
    for b in stats["buckets"]:
        raw = rows(b, seed=b)
        assert np.array_equal(loaded.predict(raw),
                              _eager(loaded, loaded.host_preprocess(raw)))
    assert loaded.aot.compiles_after_warm == 0


def test_a_rollback_replays_the_resident_versions_graphs(cuda, tmp_path):
    """The SLO rollback re-activates the prior resident version: its
    graphs captured at boot replay, nothing is captured anew, and each
    bucket's replay equals the eager step bit for bit."""
    import shutil

    import numpy as np

    from tpu_pipelines_torch.serving.fleet import ServingFleet

    _served_bert(tmp_path, cuda)
    fleet = ServingFleet("bert", str(tmp_path), replicas=2, max_versions=2,
                         max_batch_size=8, swap_probation_s=300.0, device=cuda)
    captures = [0]
    real = torch.cuda.CUDAGraph.capture_begin

    def counted(self, *args, **kwargs):
        captures[0] += 1
        return real(self, *args, **kwargs)

    try:
        fleet.reload()
        fleet.submit(_bert_rows(2, seed=1), 2)          # version 1 captures
        v1 = fleet.active_loaded()
        shutil.copytree(str(tmp_path / "1"), str(tmp_path / "2"))
        fleet.reload()                                  # canary + capture
        assert fleet.active_version == "2"
        torch.cuda.CUDAGraph.capture_begin = counted
        assert fleet.on_slo_breach({"slo": "errors_5xx"}) is True
        assert fleet.active_version == "1" and fleet.active_loaded() is v1
        for b in (1, 2, 3, 8):
            batch = _bert_rows(b, seed=30 + b)
            assert np.array_equal(fleet.submit(batch, b), _eager(v1, batch))
        for b in fleet.last_warm["buckets"]:
            batch = _bert_rows(b, seed=40 + b)
            assert np.array_equal(v1.predict(batch), _eager(v1, batch))
        assert captures[0] == 0 and v1.aot.compiles_after_warm == 0
    finally:
        torch.cuda.CUDAGraph.capture_begin = real
        fleet.close()


def test_a_warm_started_trainers_captured_steps_equal_its_eager_steps(
        cuda, tmp_path):
    """warm_start_init's restored weights are what the first (eager) step
    and every captured step start from: the graph run's losses and final
    weights equal the same steps run eagerly from the base payload."""
    import functools
    import os

    from tpu_pipelines_torch.examples import bert_module
    from tpu_pipelines_torch.models.bert import build_bert_model, init_bert_weights
    from tpu_pipelines_torch.trainer.export import export_model, warm_start_init
    from tpu_pipelines_torch.trainer.fn_args import FnArgs
    from tpu_pipelines_torch.trainer.train_loop import step_generator

    base = init_bert_weights(build_bert_model(TINY_TRAIN),
                             torch.Generator().manual_seed(11))
    uri = export_model(serving_model_dir=str(tmp_path / "base"),
                       params=base.state_dict(),
                       module_file=os.path.abspath(bert_module.__file__),
                       hyperparameters=TINY_TRAIN)
    init = warm_start_init(FnArgs(custom_config={"base_model_uri": uri}),
                           functools.partial(bert_module.init_params_fn,
                                             hyperparameters=TINY_TRAIN))
    batches = _train_batches(6, seed=5)
    model, result, losses = _graph_train(batches, init_params_fn=init,
                                         window=2)
    assert result.compiles_after_warm == 0
    eager = init(torch.Generator().manual_seed(3), batches[0]).to(cuda).train()
    for k, v in base.state_dict().items():
        assert torch.equal(eager.state_dict()[k].cpu(), v), k
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


def test_a_continuous_controller_tick_launches_the_kernels_in_its_window_trainer(
        cuda, tmp_path):
    """Two spans land; one controller tick on the card runs both span
    pipelines and the window pipeline (RollingWindowResolver -> SpanWindow
    / WindowStatisticsMerger -> SchemaGen -> Transform -> Trainer with
    flash attention at tiny widths): every kernel of the training step
    launches inside the window Trainer, layers x steps each backward
    kernel, and a second tick with nothing new runs nothing."""
    import os

    import numpy as np

    from tpu_pipelines_torch.components import (
        CsvExampleGen,
        RollingWindowResolver,
        SchemaGen,
        StatisticsGen,
        Trainer,
        Transform,
    )
    from tpu_pipelines_torch.continuous import (
        ContinuousConfig,
        ContinuousController,
        SpanWindow,
        WindowStatisticsMerger,
    )
    from tpu_pipelines_torch.dsl.pipeline import Pipeline
    from tpu_pipelines_torch.examples import bert_pipeline
    from tpu_pipelines_torch.observability.metrics import MetricsRegistry

    steps, layers = 4, 2
    hp = {"d_model": 64, "n_layers": layers, "n_heads": 2, "d_ff": 128,
          "max_len": 64, "dropout_rate": 0.0, "num_classes": 2,
          "batch_size": 8, "learning_rate": 1e-3, "attn_impl": "flash"}
    pattern = str(tmp_path / "data" / "span-{SPAN}" / "v-{VERSION}")
    md = str(tmp_path / "md.sqlite")
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(40)]
    for span in (1, 2):
        d = tmp_path / "data" / f"span-{span}" / "v-1"
        d.mkdir(parents=True)
        rows = ["text,label"] + [
            f'"{" ".join(rng.choice(words, int(rng.integers(3, 20))))}",'
            f"{int(rng.integers(0, 2))}" for _ in range(96)]
        (d / "data.csv").write_text("\n".join(rows) + "\n")

    def span_pipeline(span, version):
        gen = CsvExampleGen(input_path=pattern, span=span, version=version)
        stats = StatisticsGen(examples=gen.outputs["examples"],
                              save_accumulators=True)
        return Pipeline("gpu-spans", [gen, stats],
                        pipeline_root=str(tmp_path / "spans"),
                        metadata_path=md, node_timeout_s=600)

    def window_pipeline():
        win = RollingWindowResolver(
            window_spans=2, source_pipeline="gpu-spans",
            examples_producer="CsvExampleGen",
            statistics_producer="StatisticsGen")
        window = SpanWindow(examples=win.outputs["examples"])
        merged = WindowStatisticsMerger(statistics=win.outputs["statistics"])
        schema = SchemaGen(statistics=merged.outputs["statistics"])
        transform = Transform(
            examples=window.outputs["window"], schema=schema.outputs["schema"],
            module_file=os.path.join(bert_pipeline.HERE,
                                     "bert_preprocessing.py"))
        trainer = Trainer(
            examples=transform.outputs["transformed_examples"],
            transform_graph=transform.outputs["transform_graph"],
            module_file=os.path.join(bert_pipeline.HERE, "bert_module.py"),
            train_steps=steps, hyperparameters=hp)
        return Pipeline("gpu-window",
                        [win, window, merged, schema, transform, trainer],
                        pipeline_root=str(tmp_path / "window"),
                        metadata_path=md, node_timeout_s=600)

    controller = ContinuousController(ContinuousConfig(
        input_pattern=pattern, make_span_pipeline=span_pipeline,
        make_window_pipeline=window_pipeline, registry=MetricsRegistry(),
        state_dir=str(tmp_path / "state"), device=cuda))
    saved = {name: getattr(fa, name) for name in fa.COUNTERS}
    try:
        for name in fa.COUNTERS:
            setattr(fa, name, 0)
        tick = controller.run_once()
        assert tick["spans_processed"] == 2 and tick["work_saved_ratio"] == 0.0
        assert tick["nodes_executed"] == 4 + 6
        assert (fa.dvec_launches, fa.dq_launches, fa.dkv_launches) == (
            layers * steps,) * 3
        assert fa.launches >= layers * steps and fa.decode_launches == 0
        launched = {name: getattr(fa, name) for name in fa.COUNTERS}
        idle = controller.run_once()
        assert idle["nodes_executed"] == idle["nodes_cached"] == 0
        assert {name: getattr(fa, name) for name in fa.COUNTERS} == launched
    finally:
        for name, value in saved.items():
            setattr(fa, name, value)


def test_the_fork_shard_pool_after_a_kernel_launch_gives_the_thread_bytes(
        cuda, tmp_path, monkeypatch):
    """A process that holds a CUDA context and has launched a kernel forks
    StatisticsGen's shard pool: the children (numpy only) write the same
    stats.json bytes as the thread pool, from pids other than this one,
    and a killed worker is replaced with the same bytes again."""
    import os

    import numpy as np

    from tpu_pipelines_torch.components import CsvExampleGen, StatisticsGen
    from tpu_pipelines_torch.dsl.pipeline import Pipeline
    from tpu_pipelines_torch.observability.export import read_events
    from tpu_pipelines_torch.observability.trace import events_path
    from tpu_pipelines_torch.orchestration import LocalDagRunner
    from tpu_pipelines_torch.testing import faults

    q = torch.randn(2, 64, 2, 64, device=cuda, dtype=torch.bfloat16)
    mask = torch.ones(2, 64, dtype=torch.bool, device=cuda)
    before = fa.launches
    fa.flash_attention(q, q, q, kv_mask=mask)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    rng = np.random.default_rng(0)
    csv = tmp_path / "d.csv"
    csv.write_text("a,b,c\n" + "\n".join(
        f"{rng.normal():.6f},{int(rng.integers(0, 50))},w{int(rng.integers(0, 9))}"
        for _ in range(4000)) + "\n")
    monkeypatch.setenv("TPP_DATA_SHARDS", "4")
    monkeypatch.setenv("TPP_NODE_TIMEOUT_S", "120")
    got = {}
    for tag, pool, plan in (
            ("thread", "thread", None), ("process", "process", None),
            ("killed", "process", faults.FaultPlan({
                faults.SHARD_KEY: faults.NodeFault(
                    faults.KILL_SHARD_WORKER, shard=1)}))):
        monkeypatch.setenv("TPP_DATA_POOL", pool)
        gen = CsvExampleGen(input_path=str(csv))
        stats = StatisticsGen(examples=gen.outputs["examples"])
        root = str(tmp_path / tag / "root")
        pipe = Pipeline("gpu-fork", [gen, stats], pipeline_root=root,
                        metadata_path=str(tmp_path / tag / "md.sqlite"))
        if plan is None:
            result = LocalDagRunner(device=cuda).run(pipe)
        else:
            with plan.activate():
                result = LocalDagRunner(device=cuda).run(pipe)
        uri = result.nodes["StatisticsGen"].outputs["statistics"][0].uri
        events = read_events(events_path(root, result.run_id))
        pids = {e["pid"] for e in events if e.get("name") == "shard"}
        got[tag] = (open(os.path.join(uri, "stats.json"), "rb").read(), pids)
    assert got["process"][0] == got["thread"][0] == got["killed"][0]
    assert got["thread"][1] == {os.getpid()}
    assert got["process"][1] and os.getpid() not in got["process"][1]


def test_a_resnet_graph_train_loop_equals_eager_with_its_running_statistics(
        cuda):
    """A ResNet-18 (width 16, bf16, BatchNorm) through
    ``train_loop(has_model_state=True)`` with the ResNet twin's SGD: the
    captured steps equal the same steps run eagerly bit for bit, in the
    losses, the parameters, the momentum buffers and every running mean and
    variance, which moved off their init (cuDNN held to its deterministic
    algorithms on both sides)."""
    from tpu_pipelines_torch.examples import resnet_module
    from tpu_pipelines_torch.models.resnet import ResNet, init_resnet_weights
    from tpu_pipelines_torch.trainer import TrainLoopConfig, train_loop

    gen = torch.Generator().manual_seed(0)
    batches = [{"image": torch.randn(16, 32, 32, 3, generator=gen).numpy(),
                "label": torch.randint(0, 10, (16,), generator=gen).numpy()}
               for _ in range(6)]

    def init(generator, sample):
        return init_resnet_weights(ResNet(10, 18, 16), generator)

    optimizers, losses = [], []

    def optimizer(params):
        optimizers.append(resnet_module.sgd(0.1)(params))
        return optimizers[-1]

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        model, result = train_loop(
            loss_fn=resnet_module.loss_fn, init_params_fn=init,
            optimizer=optimizer, train_iter=iter(batches),
            config=TrainLoopConfig(train_steps=6, batch_size=16, log_every=1,
                                   window_steps=3),
            metrics_cb=lambda s, m: losses.append(m["loss"]),
            has_model_state=True, device="cuda")
        eager = init(torch.Generator().manual_seed(0), None).to(cuda).train()
        opt = resnet_module.sgd(0.1)(eager.parameters())
        eager_losses = []
        for b in batches:
            loss, _ = resnet_module.loss_fn(
                eager, {k: torch.as_tensor(v, device=cuda) for k, v in b.items()},
                None)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            eager_losses.append(loss.item())
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert result.compiles_after_warm == 0 and losses == eager_losses
    for (name, t), e in zip(model.state_dict().items(),
                            eager.state_dict().values()):
        assert torch.equal(t, e), name
    for p, q in zip(model.parameters(), eager.parameters()):
        assert torch.equal(optimizers[0].state[p]["momentum_buffer"],
                           opt.state[q]["momentum_buffer"])
    fresh = init(torch.Generator().manual_seed(0), None).state_dict()
    for name, t in model.state_dict().items():
        if "running" in name:
            assert not torch.equal(t.cpu(), fresh[name]), name


def test_a_world_of_one_over_nccl_captures_the_psum_step_with_its_collective(
        cuda, tmp_path):
    """Data parallelism (A5) at a world of one over NCCL: the tiny BERT's
    psum_bucketed step is captured with its bucketed all-reduces inside the
    graph (issued while the stream captures), and the replays equal the
    same steps run eagerly through the mode's step, bit for bit."""
    import datetime
    import functools
    import os
    from unittest import mock

    import torch.distributed as dist

    from tpu_pipelines_torch.examples import bert_module
    from tpu_pipelines_torch.parallel.mesh import make_mesh
    from tpu_pipelines_torch.trainer import TrainLoopConfig, train_loop
    from tpu_pipelines_torch.trainer.data_parallel import DataParallel
    from tpu_pipelines_torch.trainer.train_loop import _step_seed

    batches = _train_batches(6)
    init = functools.partial(bert_module.init_params_fn,
                             hyperparameters=TINY_TRAIN)
    config = TrainLoopConfig(train_steps=len(batches), batch_size=8,
                             log_every=1, window_steps=2, seed=3,
                             dp_collective="psum_bucketed")
    captured, losses = [], []
    real = dist.all_reduce

    def counting(*args, **kwargs):
        captured.append(torch.cuda.is_current_stream_capturing())
        return real(*args, **kwargs)

    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp_path, "store"), 1),
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=120),
        device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        with mock.patch.object(dist, "all_reduce", counting):
            model, result = train_loop(
                loss_fn=bert_module.loss_fn, init_params_fn=init,
                optimizer=bert_module.adamw(1e-3), train_iter=iter(batches),
                config=config, metrics_cb=lambda s, m: losses.append(m["loss"]),
                device="cuda")
        eager = init(torch.Generator().manual_seed(3), batches[0]).to(cuda).train()
        dp = DataParallel.build(config, make_mesh(device="cuda"), eager,
                                "psum_bucketed", False)
        opt = bert_module.adamw(1e-3)(dp.parameters(eager))
        dp.attach(eager)
        gens = [torch.Generator(device=cuda) for _ in range(dp.generator_count())]
        eager_losses = []
        for s, b in enumerate(batches):
            dp.seed_generators(gens, _step_seed(3, s))
            loss, _ = dp.step(eager, bert_module.loss_fn,
                              {k: torch.as_tensor(v, device=cuda)
                               for k, v in b.items()}, gens, opt, None)
            eager_losses.append(loss.item())
        dp.detach()
    finally:
        dist.destroy_process_group()
    assert result.step_capture == "cuda_graph"
    assert result.dp_collective == "psum_bucketed"
    assert result.compiles_after_warm == 0
    # The eager first step's 2 buckets and loss row, then the capture's.
    assert captured[:3] == [False] * 3 and captured[3:] == [True] * 3
    assert losses == eager_losses
    for (name, p), q in zip(model.named_parameters(), eager.parameters()):
        assert torch.equal(p, q), name


def test_two_ranks_on_one_card_share_collectives_over_gloo_not_nccl(
        cuda, tmp_path):
    """What the two-rank part of chip_smoke's dp_train phase rests on: two
    processes on the one card over gloo carry every collective of a
    data-parallel step on CUDA tensors, with the right values; NCCL
    refuses a second rank on the same device (NCCL 2.28.9 with torch
    2.11.0+cu128).  Should NCCL ever carry them, this fails, and the phase
    can move its two ranks to NCCL and capture them."""
    import torch_dp_worker as w

    gloo = w.probe("gloo", str(tmp_path / "gloo"))
    assert gloo == [{name: "ok" for name in w.PROBE_OPS}] * 2, gloo
    nccl = w.probe("nccl", str(tmp_path / "nccl"))
    assert all("error" in rank for rank in nccl), nccl


def test_two_ranks_on_one_card_carry_the_sequence_and_expert_exchanges(
        cuda, tmp_path):
    """What chip_smoke's seq_expert_two_ranks phase rests on: two gloo
    processes on the one card carry ``all_to_all_single`` with uneven
    splits (zero-sized ones included) on CUDA tensors, with the right
    values; ``batch_isend_irecv`` they do not (gloo's point-to-point sends
    read a device pointer on the host: "Bad address", torch 2.11.0+cu128).
    ``parallel/collectives.py`` builds its ring hop and its all-to-all on
    ``all_to_all_single``, which NCCL runs as grouped sends and receives.
    Each exchange runs in processes of its own (a refused send can take
    its process down)."""
    import torch_dp_worker as w

    found = {op: w.probe("gloo", str(tmp_path / op), ops=(op,))
             for op in w.EXCHANGE_OPS}
    print("gloo exchanges on CUDA tensors:", found)
    for op in ("all_to_all_single_uneven", "all_to_all_single_ring"):
        assert found[op] == [{op: "ok"}] * 2, found
    assert all(rank.get("batch_isend_irecv") != "ok"
               for rank in found["batch_isend_irecv"]), found


def test_two_ranks_on_one_card_split_bert_heads_over_model(cuda, tmp_path):
    """Tensor parallelism (A6b) on two gloo ranks of the card: BERT-base's
    width at two layers over model = 2, one forward and backward; each
    rank's attention holds 6 of the 12 heads and launches the forward,
    Dvec, dq and dkv kernels once a layer on them; both ranks hold the
    same logits, within LOGIT_TOL 4e-2 of one process's (bf16: the
    ranks' partial sums round apart from one GEMM's)."""
    import torch_dp_worker as w

    got = [r["tp"] for r in w.spawn(2, [("tp", "torch_tp_worker:tp_card_step", {})],
                                     str(tmp_path))]
    for rank in got:
        assert rank["heads"] == 6
        assert rank["launches"] == {"launches": 2, "dvec_launches": 2,
                                    "dq_launches": 2, "dkv_launches": 2,
                                    "decode_launches": 0}, rank["launches"]
    assert torch.equal(got[0]["logits"], got[1]["logits"])
    assert float((got[0]["logits"] - got[0]["one_process"]).abs().max()) <= 4e-2


def test_decode_kernel_at_a_tensor_parallel_ranks_shape(cuda):
    """T5-small decoding over model = 2 (A6c): a rank's 4 of the 8 heads
    against a 2048-key cache, batch 8, with its rows of the relative-
    position bias [1, 4, 1, L] and the greedy step's expanded bool mask:
    the kernel within one bf16 ulp of its plain version, and one launch."""
    b, l, h, d = 8, 2048, 4, 64
    q, k, v, gen = _decode_inputs(b, l, h, d, torch.bfloat16, cuda, seed=21)
    mask = (torch.arange(l) <= 1023)[None, :].to(cuda).expand(b, l)
    bias = torch.randn(1, h, 1, l, generator=gen).to(cuda)
    before = fa.decode_launches
    out = fa.flash_decode_attention(q, k, v, kv_mask=mask, bias=bias)
    torch.cuda.synchronize()
    assert fa.decode_launches == before + 1
    ref = fa.flash_decode_attention_reference(q, k, v, kv_mask=mask, bias=bias)
    assert out.shape == (b, 1, h, d)
    assert _within(out, ref, OUT_TOL[torch.bfloat16])


def test_a_whole_shape_dropout_draw_replays_as_the_eager_draw(cuda, monkeypatch):
    """A rank's dropout on its block of a split activation draws the whole
    shape's mask from the registered generator and keeps its block: inside
    a captured graph, re-seeded before each replay, that equals an eager
    whole-shape draw of the same seed, sliced (here rank 1 of 2 on the
    last dim, the hidden site's split over model; the group is a stand-in
    the collectives' size and rank read)."""
    from tpu_pipelines_torch.models.transformer import Dropout
    from tpu_pipelines_torch.parallel import collectives

    group = object()
    monkeypatch.setattr(collectives, "axis_world", lambda g: 2 if g is group else 1)
    monkeypatch.setattr(collectives, "axis_rank", lambda g: 1 if g is group else 0)
    dropout = Dropout(0.25, columns=(192, group)).train()
    x = torch.randn(4, 16, 96, device=cuda)
    generator = torch.Generator(device=cuda)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    generator.manual_seed(0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dropout(x, generator)                                # warm-up
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        out = dropout(x, generator)
    for seed in (5, 6):
        generator.manual_seed(seed)
        graph.replay()
        torch.cuda.synchronize()
        eager = torch.Generator(device=cuda).manual_seed(seed)
        u = torch.rand((4, 16, 192), generator=eager, device=cuda)[..., 96:]
        want = torch.where(u < 0.75, x / 0.75, torch.zeros_like(x))
        assert torch.equal(out, want), seed


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


def test_the_host_cores_build_on_the_cards_host_and_the_c_crc_agrees(cuda):
    """The record and tokenizer cores build with the card host's g++; the C
    crc32c equals the table version on seeded bytes and the check value."""
    import numpy as np

    from tpu_pipelines_torch.data import native_record, record_io
    from tpu_pipelines_torch.transform import native_tokenizer

    native_record.build_seconds()
    native_tokenizer.build_seconds()
    data = np.random.default_rng(0).integers(0, 256, 1 << 16,
                                             dtype=np.uint8).tobytes()
    for off in range(4):
        assert record_io._crc32c(data[off:]) == record_io._crc32c_py(data[off:])
    assert native_record.crc32c(b"123456789") == 0xE3069283
    ids = native_tokenizer.NativeTokenizer(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "cat"], True).encode_ascii_rows(
            [b"Cat dog"], 4)
    assert ids.tolist() == [[2, 4, 1, 3]]


def test_two_gloo_ranks_on_the_card_run_one_spmd_node_through_run_node(
        cuda, tmp_path):
    """``run_node`` under spmd_sync on the card (A10): two gloo ranks of the
    one card run one node through ``run_node.main`` on cuda, write into
    one output dir under process 0's execution id, and process 0
    publishes one execution."""
    import torch_dp_worker as w

    got = [r["node"] for r in w.spawn(
        2, [("node", "torch_spmd_worker:card_run_node",
             {"home": str(tmp_path / "home")})], str(tmp_path / "out"),
        timeout_s=120.0)]
    assert [g["code"] for g in got] == [0, 0]
    assert got[0]["dirs"] == got[1]["dirs"]
    assert list(got[0]["dirs"].values()) == [
        ["device_0", "device_1", "seen_0", "seen_1"]]
    assert got[0]["executions"] == ["COMPLETE"]
    assert got[0]["device"] == "cuda 2.0"

