"""The port's flash-decode attention on the CPU against the JAX package.

``tpu_pipelines_torch.ops.flash_attention.flash_decode_attention`` on CPU
tensors runs its plain version (f32 math, the kernel's masking); the JAX
side runs the Pallas ``_decode_kernel`` in interpret mode with an explicit
``block_k``, as ``tests/test_generative.py`` does.  Same numpy inputs on
both sides.

Tolerances: f32 inputs (rtol, atol) = (2e-5, 2e-5), the JAX test's (two f32
softmaxes, blockwise against whole-row, differ in the order of f32 sums);
bf16 inputs one bf16 ulp, |got - want| <= 2^-7 |want| + 1e-5 (both sides
compute in f32 from the same bf16 values and round once to bf16, so they
part by at most one rounding step).  A row whose keys are all masked is 0
on both sides, exactly.

The CUDA kernel splits each row's keys across the CTAs of a cluster
(``fa.decode_splits``, ``fa.decode_split_ranges``) and merges the splits'
partial (m, l, acc) in rank order; ``_split_merge`` below emulates that in
f32 torch, and is held to the same f32 tolerance against the plain version
and the Pallas kernel at split boundaries.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tpu_pipelines.ops.flash_attention import (
    flash_decode_attention as jax_flash_decode,
)
from tpu_pipelines_torch.ops import flash_attention as fa

F32_TOL = dict(rtol=2e-5, atol=2e-5)
# SMs of the card the split rule plans for: an H100 SXM's 132 unless a case
# names another (an H100 PCIe has 114).
SMS = 132
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-5)


def _inputs(b, l, h, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, d)).astype(dtype)
    k = rng.standard_normal((b, l, h, d)).astype(dtype)
    v = rng.standard_normal((b, l, h, d)).astype(dtype)
    return q, k, v, rng


def _jax(q, k, v, mask, bias, block_k=32):
    out = jax_flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_mask=None if mask is None else jnp.asarray(mask),
        bias=None if bias is None else jnp.asarray(bias),
        block_k=block_k, interpret=True,
    )
    return np.asarray(out.astype(jnp.float32))


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _port(q, k, v, mask, bias, **kw):
    out = fa.flash_decode_attention(
        _torch(q), _torch(k), _torch(v),
        kv_mask=None if mask is None else torch.from_numpy(mask),
        bias=None if bias is None else torch.from_numpy(bias), **kw,
    )
    return out.float().numpy()


@pytest.mark.parametrize("bias_kind", ["none", "broadcast", "per_row"])
def test_decode_matches_jax_kernel_with_ragged_validity(bias_kind):
    b, l, h, d = 3, 128, 2, 16
    q, k, v, rng = _inputs(b, l, h, d, seed=0)
    pos = np.array([5, 63, 127])
    mask = (np.arange(l)[None, :] <= pos[:, None]).astype(np.int32)
    bias = {
        "none": None,
        "broadcast": rng.standard_normal((1, h, 1, l)).astype(np.float32),
        "per_row": rng.standard_normal((b, h, 1, l)).astype(np.float32),
    }[bias_kind]
    want = _jax(q, k, v, mask, bias)
    got = _port(q, k, v, mask, bias)
    assert got.shape == (b, 1, h, d)
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_all_masked_row_is_exact_zero_on_both_sides():
    b, l, h, d = 3, 64, 2, 32
    q, k, v, rng = _inputs(b, l, h, d, seed=1)
    mask = np.ones((b, l), np.int32)
    mask[1] = 0
    bias = rng.standard_normal((b, h, 1, l)).astype(np.float32)
    want = _jax(q, k, v, mask, bias)
    got = _port(q, k, v, mask, bias)
    assert np.all(want[1] == 0.0) and np.all(got[1] == 0.0)
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_bool_mask_equals_int32_mask_and_no_mask_means_all_keys():
    b, l, h, d = 2, 64, 2, 16
    q, k, v, _ = _inputs(b, l, h, d, seed=2)
    mask = np.ones((b, l), np.int32)
    with_int = _port(q, k, v, mask, None)
    with_bool = _port(q, k, v, mask.astype(bool), None)
    without = _port(q, k, v, None, None)
    np.testing.assert_array_equal(with_int, with_bool)
    np.testing.assert_array_equal(with_int, without)
    np.testing.assert_allclose(without, _jax(q, k, v, None, None), **F32_TOL)


def test_strided_cache_views_match_contiguous_jax_inputs():
    """The engine hands the kernel ``arena[:b, :kv]`` views and a bias
    whose batch stride is 0; the port reads them where they lie."""
    b, l, h, d = 2, 64, 4, 16
    rng = np.random.default_rng(3)
    arena = rng.standard_normal((4, 128, 2, h, d)).astype(np.float32)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    pos = np.array([10, 50])
    mask = (np.arange(l)[None, :] <= pos[:, None]).astype(np.int32)
    bias = rng.standard_normal((1, h, 1, l)).astype(np.float32)
    t_arena = torch.from_numpy(arena)
    k_view, v_view = t_arena[:b, :l, 0], t_arena[:b, :l, 1]
    assert not k_view.is_contiguous()
    got = fa.flash_decode_attention(
        torch.from_numpy(q), k_view, v_view, kv_mask=torch.from_numpy(mask),
        bias=torch.from_numpy(bias).expand(b, h, 1, l),
    ).numpy()
    want = _jax(q, np.ascontiguousarray(arena[:b, :l, 0]),
                np.ascontiguousarray(arena[:b, :l, 1]), mask, bias)
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_bf16_inputs_within_one_output_ulp():
    b, l, h, d = 4, 128, 2, 64
    q, k, v, rng = _inputs(b, l, h, d, seed=4, dtype=ml_dtypes.bfloat16)
    pos = np.array([0, 31, 64, 127])
    mask = (np.arange(l)[None, :] <= pos[:, None]).astype(np.int32)
    bias = rng.standard_normal((1, h, 1, l)).astype(np.float32)
    want = _jax(q, k, v, mask, bias, block_k=64)
    got_t = fa.flash_decode_attention(
        _torch(q), _torch(k), _torch(v), kv_mask=torch.from_numpy(mask),
        bias=torch.from_numpy(bias), block_k=fa.DECODE_BLOCK_K,
    )
    assert got_t.dtype == torch.bfloat16
    np.testing.assert_allclose(got_t.float().numpy(), want, **BF16_TOL)


def test_plain_version_is_what_a_cpu_tensor_runs():
    b, l, h, d = 2, 40, 2, 32
    q, k, v, _ = _inputs(b, l, h, d, seed=5)
    mask = np.ones((b, l), np.int32)
    mask[0, 30:] = 0
    before = fa.decode_launches
    got = _port(q, k, v, mask, None)
    want = fa.flash_decode_attention_reference(
        _torch(q), _torch(k), _torch(v), kv_mask=torch.from_numpy(mask)
    ).numpy()
    np.testing.assert_array_equal(got, want)
    assert fa.decode_launches == before          # plain versions never count


@pytest.mark.parametrize(
    "case, error",
    [
        ("head_dim", ValueError),
        ("q_len", ValueError),
        ("kv_shape", ValueError),
        ("dtype_mix", TypeError),
        ("float64", TypeError),
        ("mask_shape", ValueError),
        ("mask_dtype", TypeError),
        ("bias_shape", ValueError),
        ("bias_dtype", TypeError),
        ("block_k", ValueError),
        ("device", ValueError),
        ("empty", ValueError),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(case, error):
    b, l, h, d = 2, 16, 2, 16
    q = torch.zeros(b, 1, h, d)
    k = torch.zeros(b, l, h, d)
    v = torch.zeros(b, l, h, d)
    kw = {}
    if case == "head_dim":
        q, k, v = (torch.zeros(t.shape[:-1] + (24,)) for t in (q, k, v))
    elif case == "q_len":
        q = torch.zeros(b, 2, h, d)
    elif case == "kv_shape":
        v = torch.zeros(b, l + 1, h, d)
    elif case == "dtype_mix":
        q = q.to(torch.bfloat16)
    elif case == "float64":
        q, k, v = (t.double() for t in (q, k, v))
    elif case == "mask_shape":
        kw["kv_mask"] = torch.ones(b, l + 1, dtype=torch.int32)
    elif case == "mask_dtype":
        kw["kv_mask"] = torch.ones(b, l, dtype=torch.float32)
    elif case == "bias_shape":
        kw["bias"] = torch.zeros(1, h, 2, l)
    elif case == "bias_dtype":
        kw["bias"] = torch.zeros(1, h, 1, l, dtype=torch.bfloat16)
    elif case == "block_k":
        kw["block_k"] = 32
    elif case == "device":
        q, k, v = (t.to("meta") for t in (q, k, v))
    elif case == "empty":
        k = torch.zeros(b, 0, h, d)
        v = torch.zeros(b, 0, h, d)
    with pytest.raises(error):
        fa.flash_decode_attention(q, k, v, **kw)


# ------------------------------------------------------------ split-KV rule

@pytest.mark.parametrize(
    "b, h, l, sms, want",
    [
        (32, 8, 4096, SMS, 2),    # long cache: 512 CTAs
        (4, 8, 4096, SMS, 8),     # one-row beam request: capped at 8
        (8, 8, 2048, SMS, 5),     # engine's long bucket
        (8, 8, 512, SMS, 4),      # 8 blocks: at least 2 a split
        (1, 1, 320, SMS, 2),      # 5 blocks
        (16, 8, 128, SMS, 1),     # served beam step: 2 blocks, not split
        (8, 8, 256, SMS, 1),      # 4 blocks, not split
        (64, 8, 4096, SMS, 1),    # B*H alone fills the card
        (1, 1, 64, SMS, 1),       # one block
        (4, 8, 1, SMS, 1),        # L = 1
        (1, 1, 100000, SMS, 8),
        (8, 8, 2048, 114, 4),     # fewer SMs, fewer splits
        (32, 8, 4096, 114, 1),    # 256 CTAs fill 114 SMs twice
    ],
)
def test_decode_splits_rule(b, h, l, sms, want):
    s = fa.decode_splits(b, h, l, sms)
    assert s == want
    blocks = -(-l // fa.DECODE_BLOCK_K)
    assert 1 <= s <= fa.DECODE_MAX_SPLITS
    if blocks <= fa.DECODE_UNSPLIT_BLOCKS:
        assert s == 1
    else:
        assert s <= blocks // fa.DECODE_SPLIT_BLOCKS
        # Enough CTAs to fill the card unless a cap binds.
        if s < min(fa.DECODE_MAX_SPLITS, blocks // fa.DECODE_SPLIT_BLOCKS):
            assert s * b * h >= fa.DECODE_CTAS_PER_SM * sms


@pytest.mark.parametrize("l", [1, 63, 64, 65, 128, 1000, 1088, 2048, 4096])
def test_decode_splits_take_whole_blocks(l):
    for b, h in [(1, 1), (4, 8), (32, 8), (300, 8)]:
        s = fa.decode_splits(b, h, l, SMS)
        if l <= fa.DECODE_BLOCK_K:
            assert s == 1
        ranges = fa.decode_split_ranges(l, s)
        assert len(ranges) == s and ranges[0][0] == 0 and ranges[-1][1] == l
        for (lo, hi), (nxt, _) in zip(ranges, ranges[1:] + [(l, l)]):
            assert lo % fa.DECODE_BLOCK_K == 0 and hi == nxt
            assert hi == l or hi % fa.DECODE_BLOCK_K == 0
            # At least DECODE_SPLIT_BLOCKS whole blocks (the last may be cut
            # at l) when split.
            if s > 1:
                assert hi - lo > (fa.DECODE_SPLIT_BLOCKS - 1) * fa.DECODE_BLOCK_K


def _split_merge(q, k, v, mask, bias):
    """f32 emulation of the kernel's split-and-merge: each split's partial
    (m, l, acc) over its own keys, then the partials merged in rank order
    by the max/denominator rule; out = acc / max(l, 1e-30).  Returns (out,
    the partials)."""
    b, l, h, d = k.shape
    qs = q[:, 0].float() * d ** -0.5                        # [b, h, d]
    allowed_all = (mask > 0) if mask is not None else torch.ones(b, l, dtype=torch.bool)
    partials = []
    for lo, hi in fa.decode_split_ranges(l, fa.decode_splits(b, h, l, SMS)):
        s = torch.einsum("bhd,bkhd->bhk", qs, k[:, lo:hi].float())
        if bias is not None:
            s = s + bias[:, :, 0, lo:hi].float()
        allowed = allowed_all[:, None, lo:hi].expand_as(s)
        m = torch.where(allowed, s, fa.NEG_INF).amax(dim=-1)    # [b, h]
        p = torch.where(allowed, torch.exp(s - m[..., None]), 0.0)
        acc = torch.einsum("bhk,bkhd->bhd", p, v[:, lo:hi].float())
        partials.append((m, p.sum(dim=-1), acc))
    gm = torch.full_like(partials[0][0], fa.NEG_INF)
    for m, _, _ in partials:
        gm = torch.maximum(gm, m)
    den = torch.zeros_like(gm)
    out = torch.zeros_like(partials[0][2])
    for m, l_r, acc in partials:
        c = torch.exp(m - gm)
        den = den + l_r * c
        out = out + acc * c[..., None]
    out = out / den.clamp_min(1e-30)[..., None]
    return out[:, None].to(q.dtype), partials


@pytest.mark.parametrize("l, block_k", [(1088, 64), (1000, 1000)])
def test_split_merge_matches_plain_version_and_jax_at_split_boundaries(l, block_k):
    b, h, d = 4, 2, 16
    q, k, v, rng = _inputs(b, l, h, d, seed=6)
    s = fa.decode_splits(b, h, l, SMS)
    ranges = fa.decode_split_ranges(l, s)
    assert s == 8
    # Rows that end just before, at and just after a split boundary, and
    # one that runs to the end.
    edge = ranges[3][0]
    pos = np.array([edge - 1, edge, edge + 1, l - 1])
    mask = (np.arange(l)[None, :] <= pos[:, None]).astype(np.int32)
    bias = rng.standard_normal((b, h, 1, l)).astype(np.float32)
    got, _ = _split_merge(_torch(q), _torch(k), _torch(v), torch.from_numpy(mask),
                          torch.from_numpy(bias))
    want = _port(q, k, v, mask, bias)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    np.testing.assert_allclose(got.numpy(), _jax(q, k, v, mask, bias, block_k),
                               **F32_TOL)


def test_empty_splits_add_nothing_and_an_all_masked_row_is_exact_zero():
    b, h, d, l = 3, 2, 32, 2048
    q, k, v, rng = _inputs(b, l, h, d, seed=7)
    pos = np.array([l // 8 - 1, 10, 0])
    mask = (np.arange(l)[None, :] <= pos[:, None]).astype(np.int32)
    mask[2] = 0                                   # an all-masked row
    bias = rng.standard_normal((1, h, 1, l)).astype(np.float32)
    got, partials = _split_merge(_torch(q), _torch(k), _torch(v),
                                 torch.from_numpy(mask), torch.from_numpy(bias))
    assert len(partials) == 8
    for m, l_r, acc in partials[1:]:              # splits past L/8: no key
        assert torch.all(m == fa.NEG_INF)
        assert torch.all(l_r == 0) and torch.all(acc == 0)
    assert torch.all(got[2] == 0.0)
    want = _port(q, k, v, mask, bias)
    assert np.all(want[2] == 0.0)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    np.testing.assert_allclose(got.numpy(), _jax(q, k, v, mask, bias, 64),
                               **F32_TOL)


def test_bool_stride0_mask_equals_its_int32_copy():
    """The scalar-position decode step hands the kernel an expanded bool
    mask (batch stride 0); it is read in place and means what its int32
    copy means."""
    b, l, h, d = 4, 200, 2, 16
    q, k, v, rng = _inputs(b, l, h, d, seed=8)
    row = torch.arange(l) <= 150
    expanded = row[None, :].expand(b, l)
    assert expanded.stride() == (0, 1) and expanded.dtype == torch.bool
    bias = torch.from_numpy(rng.standard_normal((1, h, 1, l)).astype(np.float32))
    got = fa.flash_decode_attention(_torch(q), _torch(k), _torch(v),
                                    kv_mask=expanded, bias=bias)
    want = fa.flash_decode_attention(_torch(q), _torch(k), _torch(v),
                                     kv_mask=expanded.to(torch.int32).contiguous(),
                                     bias=bias)
    assert torch.equal(got, want)
    split, _ = _split_merge(_torch(q), _torch(k), _torch(v), expanded, bias)
    np.testing.assert_allclose(split.numpy(), want.numpy(), **F32_TOL)
