"""Transformer building blocks, the port of
``tpu_pipelines/models/transformer.py`` (BERT's encoder, T5's encoder and
decoder).

The numbers follow the flax modules:

  - projections keep f32 parameters and cast both the input and the
    parameters to the compute ``dtype`` on every call (flax
    ``Dense``/``DenseGeneral`` with ``dtype=``);
  - ``LayerNorm`` and ``RMSNorm`` use eps 1e-6 and compute in f32 whatever
    the compute dtype, returning that dtype;
  - ``gelu`` is the tanh approximation (flax ``nn.gelu``);
  - dropout follows ``nn.Module.train()`` / ``eval()`` where flax takes
    ``deterministic``, and draws its masks from the ``torch.Generator``
    handed down the forward where flax takes ``rngs={"dropout": rng}``
    (:class:`Dropout`).

``MultiHeadAttention`` runs self- or cross-attention, ``dense`` or
``flash`` (both differentiable); ``auto`` means dense wherever its score
temporaries fit in device memory (:func:`choose_attn_impl`).  With a
``decode_pos`` it runs one incremental decode step against a KV cache: a
plain dict of tensors keyed like the flax ``"cache"`` collection
(``decoder.layer_0.attn.cached_key``, ``...cross.cached_enc_key``), which
the step fills on its first call and then writes into IN PLACE at the
step's position (no copy of the whole cache per layer per step; a write
through a slice of a larger arena lands in the arena).  Its self-attention
takes ``flash`` (the flash-decode kernel) or ``dense``; ``auto`` in the
decode regime means dense until a crossover is measured on the card
(:func:`choose_decode_impl`).  The measured training crossover waits for
the autotune port; the speculative-verify window, ring/Ulysses attention
and the mixture-of-experts MLP wait for their slices.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpu_pipelines_torch.ops.flash_attention import (
    flash_attention,
    flash_decode_attention,
)
from tpu_pipelines_torch.parallel.ring_attention import dense_attention

# Dense attention's O(L^2) temporaries, estimated as
#   DENSE_ATTN_TEMP_FACTOR * B * H * Lq * Lkv * itemsize
# (scores, probabilities and their gradient live together at the backward
# peak), must stay under this fraction of device memory for "auto" to pick
# dense.  Same constants as the reference.
DENSE_ATTN_TEMP_FACTOR = 3.0
DENSE_ATTN_HBM_FRACTION = 0.4
# Memory assumed for a device that reports none (the CPU), as the reference
# assumes when its backend reports nothing.
FALLBACK_DEVICE_MEMORY_BYTES = 16 * 1024**3


def _device_memory_bytes(device: Optional[torch.device]) -> int:
    if device is not None and torch.device(device).type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1])
    return FALLBACK_DEVICE_MEMORY_BYTES


def dense_attn_expected_temp_bytes(
    batch: int, heads: int, seq_q: int, seq_kv: int, itemsize: int = 2
) -> int:
    """Estimate of dense attention's O(L^2) temporaries in bytes."""
    return int(
        DENSE_ATTN_TEMP_FACTOR * batch * heads * seq_q * seq_kv * itemsize
    )


def dense_attn_fits(
    batch: int,
    heads: int,
    seq_q: int,
    seq_kv: int,
    itemsize: int = 2,
    device: Optional[torch.device] = None,
) -> bool:
    """True when dense attention's temporaries fit comfortably on
    ``device`` (its total memory from ``torch.cuda.mem_get_info``)."""
    temp = dense_attn_expected_temp_bytes(batch, heads, seq_q, seq_kv, itemsize)
    return temp <= DENSE_ATTN_HBM_FRACTION * _device_memory_bytes(device)


def choose_attn_impl(
    batch: int,
    heads: int,
    seq_q: int,
    seq_kv: int,
    itemsize: int = 2,
    device: Optional[torch.device] = None,
) -> str:
    """The "auto" rule: "flash" when dense attention's temporaries do not
    fit, else "dense".  (The reference also consults a measured crossover
    from its autotune table; the port has none yet.)"""
    if not dense_attn_fits(batch, heads, seq_q, seq_kv, itemsize, device):
        return "flash"
    return "dense"


def choose_decode_impl(
    batch: int, heads: int, kv_len: int, head_dim: int
) -> str:
    """The "auto" rule for the single-query decode regime.  The reference
    picks flash at or above a crossover cache length measured on its device
    and dense without one; no crossover has been measured on the card yet,
    so this is "dense" (the kernel must earn the hot path)."""
    del batch, heads, kv_len, head_dim
    return "dense"


def _dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` applied in ``dtype`` (input and parameters cast per call)."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class LayerNorm(nn.LayerNorm):
    """flax ``LayerNorm``: eps 1e-6, statistics and affine in f32, output in
    the compute ``dtype``."""

    def __init__(self, d_model: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__(d_model, eps=1e-6)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(),
            self.bias.float(), self.eps,
        ).to(self.dtype)


class RMSNorm(nn.Module):
    """flax ``RMSNorm``: eps 1e-6, scale only, the mean square and the
    scaling in f32, output in the compute ``dtype``."""

    def __init__(self, d_model: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d_model))
        self.eps = 1e-6
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mul = torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + self.eps)
        return (x * (mul * self.weight.float())).to(self.dtype)


class Dropout(nn.Module):
    """flax ``nn.Dropout`` with its rng made explicit.

    Active only in ``train()`` mode, where the keep-mask is drawn from
    ``generator`` (on the input's device) and kept values are scaled by
    ``1 / (1 - rate)`` in the input dtype.  A training forward with
    ``rate > 0`` and no generator raises: there is no hidden global
    stream, so a step's masks follow from the seed its caller derived.
    Inside a CUDA graph the draw reads the generator's seed and offset at
    replay, so a generator registered with the graph
    (``CUDAGraph.register_generator_state``) and re-seeded before each
    replay draws what an eager step with a generator of that seed draws
    (the train loop does this)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError(
                f"dropout rate {self.rate} in train() mode needs a "
                "torch.Generator: call model(batch, generator=g), or eval()"
            )
        keep = 1.0 - self.rate
        if keep <= 0.0:
            return torch.zeros_like(x)
        u = torch.rand(x.shape, generator=generator, device=x.device)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


class MlpBlock(nn.Module):
    """``wi`` -> tanh-gelu -> ``wo``, dropout at ``dropout_site``: "output"
    (BERT's d_model-wide projection) or "hidden" (T5's DenseReluDense drops
    the d_ff-wide activation)."""

    def __init__(
        self,
        d_model: int,
        d_ff: int,
        *,
        dropout_rate: float = 0.0,
        dtype: torch.dtype = torch.bfloat16,
        dropout_site: str = "output",
    ):
        super().__init__()
        if dropout_site not in ("output", "hidden"):
            raise ValueError(f"dropout_site {dropout_site!r}: output or hidden")
        self.dtype = dtype
        self.dropout_site = dropout_site
        self.wi = nn.Linear(d_model, d_ff)
        self.wo = nn.Linear(d_ff, d_model)
        self.dropout = Dropout(dropout_rate)

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        h = F.gelu(_dense(x, self.wi, self.dtype), approximate="tanh")
        if self.dropout_site == "hidden":
            h = self.dropout(h, generator)
        out = _dense(h, self.wo, self.dtype)
        if self.dropout_site == "output":
            out = self.dropout(out, generator)
        return out


class MultiHeadAttention(nn.Module):
    """Self- or cross-attention with ``attn_impl`` "dense", "flash" or
    "auto".

    ``query``/``key``/``value`` hold the flax ``DenseGeneral`` kernels
    ``[d_model, H, Dh]`` as ``Linear(d_model, H*Dh)``; ``out`` holds
    ``[H, Dh, d_model]`` as ``Linear(H*Dh, d_model)``.  Flash runs
    unbiased self-attention only: cross-attention and biased attention
    (T5's relative positions) take the dense path, except in a decode step,
    whose self-attention runs the flash-decode kernel with the bias."""

    def __init__(
        self,
        d_model: int,
        n_heads: int,
        head_dim: int,
        *,
        dropout_rate: float = 0.0,
        dtype: torch.dtype = torch.bfloat16,
        attn_impl: str = "dense",
        causal: bool = False,
    ):
        super().__init__()
        if attn_impl not in ("dense", "flash", "auto"):
            raise NotImplementedError(
                f"attn_impl {attn_impl!r}: the port has dense, flash and auto; "
                "ring and ulysses wait for the parallel slice"
            )
        self.n_heads = n_heads
        self.head_dim = head_dim
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.causal = causal
        inner = n_heads * head_dim
        self.query = nn.Linear(d_model, inner)
        self.key = nn.Linear(d_model, inner)
        self.value = nn.Linear(d_model, inner)
        self.out = nn.Linear(inner, d_model)
        self.dropout = Dropout(dropout_rate)

    def _heads(self, x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
        b, l, _ = x.shape
        return _dense(x, layer, self.dtype).view(b, l, self.n_heads, self.head_dim)

    def _project_out(self, out: torch.Tensor) -> torch.Tensor:
        b, l = out.shape[:2]
        return _dense(out.reshape(b, l, -1), self.out, self.dtype)

    def forward(
        self,
        x: torch.Tensor,
        kv_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        *,
        x_kv: Optional[torch.Tensor] = None,
        bias: Optional[torch.Tensor] = None,
        decode_pos=None,
        max_decode_len: Optional[int] = None,
        cache: Optional[Dict[str, torch.Tensor]] = None,
        cache_prefix: str = "",
    ) -> torch.Tensor:
        """``x`` [b, lq, d_model] attends to itself, or to ``x_kv`` (cross
        attention); ``kv_mask`` [b, lkv] is key validity and ``bias`` an
        additive [*, H, lq, lkv] score term.  With ``decode_pos`` (a scalar
        position, or a [b] vector of per-row positions) this is one decode
        step against ``cache`` (see the module docstring)."""
        is_self = x_kv is None
        q = self._heads(x, self.query)
        if decode_pos is not None:
            if cache is None:
                raise ValueError("decode_pos needs a cache dict")
            if not is_self:
                return self._decode_cross(q, x_kv, kv_mask, cache, cache_prefix)
            return self._decode_self(
                q, x, bias, decode_pos, max_decode_len, cache, cache_prefix
            )
        src = x if is_self else x_kv
        k = self._heads(src, self.key)
        v = self._heads(src, self.value)
        impl = self.attn_impl
        if impl == "auto":
            impl = choose_attn_impl(
                q.shape[0], self.n_heads, q.shape[1], k.shape[1],
                q.element_size(), device=x.device,
            )
        if impl == "flash" and is_self and bias is None:
            out = flash_attention(q, k, v, causal=self.causal, kv_mask=kv_mask)
        else:
            out = dense_attention(q, k, v, causal=self.causal, kv_mask=kv_mask,
                                  bias=bias)
        return self.dropout(self._project_out(out), generator)

    def _decode_cross(self, q, x_kv, enc_mask, cache, prefix):
        """Cross-attention in a decode step: the encoder output is the same
        at every step, so its K/V are projected once, on the step that
        creates the cache, and read from it afterwards."""
        ek, ev = f"{prefix}.cached_enc_key", f"{prefix}.cached_enc_value"
        if ek not in cache:
            cache[ek] = self._heads(x_kv, self.key)
            cache[ev] = self._heads(x_kv, self.value)
        out = dense_attention(q, cache[ek], cache[ev], kv_mask=enc_mask)
        return self._project_out(out)

    def _decode_self(self, q, x, bias, decode_pos, max_decode_len, cache,
                     prefix):
        """Self-attention of one decode step: this step's K/V are written
        into the cache in place at ``decode_pos``, then the query attends
        over the positions <= its own (per row for a vector position)."""
        if q.shape[1] != 1:
            raise NotImplementedError(
                "a multi-token decode step (the speculative-verify window) "
                "waits for ROADMAP A8"
            )
        if max_decode_len is None:
            raise ValueError("decode_pos requires max_decode_len")
        b = q.shape[0]
        ck_name, cv_name = f"{prefix}.cached_key", f"{prefix}.cached_value"
        k = self._heads(x, self.key)
        v = self._heads(x, self.value)
        if ck_name not in cache:
            shape = (b, max_decode_len, self.n_heads, self.head_dim)
            cache[ck_name] = k.new_zeros(shape)
            cache[cv_name] = v.new_zeros(shape)
        ck, cv = cache[ck_name], cache[cv_name]
        kv_len = ck.shape[1]
        positions = torch.arange(kv_len, device=q.device)
        if isinstance(decode_pos, torch.Tensor) and decode_pos.dim() == 1:
            rows = torch.arange(b, device=q.device)
            ck[rows, decode_pos] = k[:, 0]
            cv[rows, decode_pos] = v[:, 0]
            valid = positions[None, :] <= decode_pos[:, None]
        else:
            pos = int(decode_pos)
            ck[:, pos] = k[:, 0]
            cv[:, pos] = v[:, 0]
            valid = (positions <= pos)[None, :].expand(b, kv_len)
        impl = self.attn_impl
        if impl == "auto":
            impl = choose_decode_impl(b, self.n_heads, kv_len, self.head_dim)
        if impl == "flash":
            out = flash_decode_attention(q, ck, cv, kv_mask=valid, bias=bias)
        else:
            out = dense_attention(q, ck, cv, kv_mask=valid, bias=bias)
        return self._project_out(out)


class TransformerBlock(nn.Module):
    """Pre- or post-norm block: self-attention [+ cross-attention] + MLP,
    with LayerNorm (BERT) or RMSNorm (T5)."""

    def __init__(
        self,
        d_model: int,
        n_heads: int,
        head_dim: int,
        d_ff: int,
        *,
        dropout_rate: float = 0.0,
        dtype: torch.dtype = torch.bfloat16,
        attn_impl: str = "dense",
        causal: bool = False,
        prenorm: bool = True,
        use_cross: bool = False,
        norm: str = "layernorm",
        mlp_dropout_site: str = "output",
    ):
        super().__init__()
        if norm not in ("layernorm", "rmsnorm"):
            raise ValueError(f"norm {norm!r}: layernorm or rmsnorm")
        norm_cls = RMSNorm if norm == "rmsnorm" else LayerNorm
        self.prenorm = prenorm
        self.use_cross = use_cross
        self.attn = MultiHeadAttention(
            d_model, n_heads, head_dim, dropout_rate=dropout_rate,
            dtype=dtype, attn_impl=attn_impl, causal=causal,
        )
        self.attn_norm = norm_cls(d_model, dtype)
        if use_cross:
            self.cross = MultiHeadAttention(
                d_model, n_heads, head_dim, dropout_rate=dropout_rate,
                dtype=dtype, attn_impl=attn_impl, causal=False,
            )
            self.cross_norm = norm_cls(d_model, dtype)
        self.mlp = MlpBlock(
            d_model, d_ff, dropout_rate=dropout_rate, dtype=dtype,
            dropout_site=mlp_dropout_site,
        )
        self.mlp_norm = norm_cls(d_model, dtype)

    def _sub(self, x, norm, fn):
        if self.prenorm:
            return x + fn(norm(x))
        return norm(x + fn(x))

    def forward(
        self,
        x: torch.Tensor,
        kv_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        *,
        encoded: Optional[torch.Tensor] = None,
        enc_mask: Optional[torch.Tensor] = None,
        self_bias: Optional[torch.Tensor] = None,
        decode_pos=None,
        max_decode_len: Optional[int] = None,
        cache: Optional[Dict[str, torch.Tensor]] = None,
        cache_prefix: str = "",
    ) -> torch.Tensor:
        step = dict(decode_pos=decode_pos, cache=cache)
        x = self._sub(x, self.attn_norm, lambda h: self.attn(
            h, kv_mask, generator, bias=self_bias,
            max_decode_len=max_decode_len, cache_prefix=f"{cache_prefix}.attn",
            **step,
        ))
        if self.use_cross:
            if encoded is None:
                raise ValueError("a block with cross-attention needs encoded")
            x = self._sub(x, self.cross_norm, lambda h: self.cross(
                h, enc_mask, generator, x_kv=encoded,
                cache_prefix=f"{cache_prefix}.cross", **step,
            ))
        return self._sub(x, self.mlp_norm, lambda h: self.mlp(h, generator))
