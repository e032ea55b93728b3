"""Transformer building blocks, the port of
``tpu_pipelines/models/transformer.py`` for self-attention encoders.

The numbers follow the flax modules:

  - projections keep f32 parameters and cast both the input and the
    parameters to the compute ``dtype`` on every call (flax
    ``Dense``/``DenseGeneral`` with ``dtype=``);
  - ``LayerNorm`` uses eps 1e-6 and computes in f32 whatever the compute
    dtype, returning that dtype;
  - ``gelu`` is the tanh approximation (flax ``nn.gelu``);
  - dropout follows ``nn.Module.train()`` / ``eval()`` where flax takes
    ``deterministic``, and draws its masks from the ``torch.Generator``
    handed down the forward where flax takes ``rngs={"dropout": rng}``
    (:class:`Dropout`).

``MultiHeadAttention`` runs ``dense`` or ``flash`` attention (both
differentiable); ``auto``
means dense wherever its score temporaries fit in device memory
(:func:`choose_attn_impl`).  The measured flash-vs-dense crossover waits for
the autotune port; decode-cache attention, cross-attention, ring/Ulysses
attention and the mixture-of-experts MLP wait for their slices.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpu_pipelines_torch.ops.flash_attention import flash_attention
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


class Dropout(nn.Module):
    """flax ``nn.Dropout`` with its rng made explicit.

    Active only in ``train()`` mode, where the keep-mask is drawn from
    ``generator`` (on the input's device) and kept values are scaled by
    ``1 / (1 - rate)`` in the input dtype.  A training forward with
    ``rate > 0`` and no generator raises: there is no hidden global
    stream, so a step's masks follow from the seed its caller derived."""

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
    """``wi`` -> tanh-gelu -> ``wo``, dropout on the output (BERT's site;
    T5's hidden-site dropout waits for the T5 slice)."""

    def __init__(
        self,
        d_model: int,
        d_ff: int,
        *,
        dropout_rate: float = 0.0,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.dtype = dtype
        self.wi = nn.Linear(d_model, d_ff)
        self.wo = nn.Linear(d_ff, d_model)
        self.dropout = Dropout(dropout_rate)

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        h = F.gelu(_dense(x, self.wi, self.dtype), approximate="tanh")
        return self.dropout(_dense(h, self.wo, self.dtype), generator)


class MultiHeadAttention(nn.Module):
    """Self-attention with ``attn_impl`` "dense", "flash" or "auto".

    ``query``/``key``/``value`` hold the flax ``DenseGeneral`` kernels
    ``[d_model, H, Dh]`` as ``Linear(d_model, H*Dh)``; ``out`` holds
    ``[H, Dh, d_model]`` as ``Linear(H*Dh, d_model)``."""

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

    def forward(
        self,
        x: torch.Tensor,
        kv_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        b, l, _ = x.shape
        heads = (b, l, self.n_heads, self.head_dim)
        q = _dense(x, self.query, self.dtype).view(heads)
        k = _dense(x, self.key, self.dtype).view(heads)
        v = _dense(x, self.value, self.dtype).view(heads)
        impl = self.attn_impl
        if impl == "auto":
            impl = choose_attn_impl(
                b, self.n_heads, l, l, q.element_size(), device=x.device
            )
        if impl == "flash":
            out = flash_attention(q, k, v, causal=self.causal, kv_mask=kv_mask)
        else:
            out = dense_attention(q, k, v, causal=self.causal, kv_mask=kv_mask)
        out = _dense(out.reshape(b, l, -1), self.out, self.dtype)
        return self.dropout(out, generator)


class TransformerBlock(nn.Module):
    """Pre- or post-LN encoder block (self-attention + MLP) with LayerNorm
    (RMSNorm and cross-attention wait for the T5 slice)."""

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
    ):
        super().__init__()
        self.prenorm = prenorm
        self.attn = MultiHeadAttention(
            d_model, n_heads, head_dim, dropout_rate=dropout_rate,
            dtype=dtype, attn_impl=attn_impl, causal=causal,
        )
        self.attn_norm = LayerNorm(d_model, dtype)
        self.mlp = MlpBlock(
            d_model, d_ff, dropout_rate=dropout_rate, dtype=dtype
        )
        self.mlp_norm = LayerNorm(d_model, dtype)

    def forward(
        self,
        x: torch.Tensor,
        kv_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        if self.prenorm:
            x = x + self.attn(self.attn_norm(x), kv_mask, generator)
            return x + self.mlp(self.mlp_norm(x), generator)
        x = self.attn_norm(x + self.attn(x, kv_mask, generator))
        return self.mlp_norm(x + self.mlp(x, generator))
