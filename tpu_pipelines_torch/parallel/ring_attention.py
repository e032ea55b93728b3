"""Plain attention, the port of ``tpu_pipelines/parallel/ring_attention.py``
(``NEG_INF``, ``_scores`` and ``dense_attention``).

The ring and Ulysses sequence-parallel variants wait for the parallel
slice of the port.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # finite mask value: exp underflows to 0, no NaN plumbing


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain attention. q,k,v: [batch, len, heads, head_dim].

    ``kv_mask``: [batch, kv_len] 1/0 validity (padding) mask.
    ``bias``: additive [*, heads, q_len, kv_len] score term (e.g. T5
    relative positions).
    Scores and softmax are f32; the probabilities are cast to ``v``'s dtype
    for the second product, as the reference does.
    """
    s = _scores(q, k, causal=causal, kv_mask=kv_mask, bias=bias,
                q_offset=0, kv_offset=0)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype)


def _scores(q, k, *, causal, kv_mask, bias, q_offset, kv_offset):
    """Masked f32 score tensor [b, h, lq, lk], scaled after the product;
    offsets give global positions for causal masking when q/k are blocks of
    a longer sequence."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = kv_offset + torch.arange(k.shape[1], device=q.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :] > 0, s, NEG_INF)
    return s
