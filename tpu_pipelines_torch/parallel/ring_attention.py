"""Sequence parallelism over the mesh ``seq`` axis, the port of
``tpu_pipelines/parallel/ring_attention.py``: plain attention, ring and
Ulysses attention, and ``long_context_batch_partition``.

The reference's functions take global arrays and ``shard_map`` them; the
port has no global arrays, so :func:`ring_attention` and
:func:`ulysses_attention` take what the reference's per-device function
takes: this rank's block of the sequence (``q, k, v`` ``[b, L/n, h, d]``,
``kv_mask`` ``[b, L/n]``), block ``i`` of the ``seq`` axis on axis rank
``i``, and return this rank's block of the output.

  - :func:`ring_attention` keeps its Q block and streams the K/V (and
    mask) blocks around the ring with :func:`~tpu_pipelines_torch.parallel.
    collectives.ppermute`, accumulating the softmax online (running max,
    denominator and output in f32); the last hop is skipped (it would only
    restore the start); a row with no valid key gives zero.
  - :func:`ulysses_attention` re-shards ``[b, L/n, h, d]`` to ``[b, L,
    h/n, d]`` with one all-to-all each for q, k and v, gathers the mask,
    runs :func:`dense_attention` on the full sequence for its head slice,
    and re-shards the output back.

Under autograd each ring hop's block update (and Ulysses' local dense
attention) is recomputed in the backward rather than its score
temporaries saved: a rank then holds O(L/n) per layer, not O((L/n)^2).

The block products are plain torch, as the reference's are outside any
Pallas kernel.  Gradients flow through the exchanges' transposes
(``parallel/collectives.py``).  A ``seq`` axis of 1 is
:func:`dense_attention`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from tpu_pipelines_torch.parallel import collectives

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


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: Any,
    axis: str = "seq",
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sequence-parallel attention over mesh axis ``axis`` on this rank's
    blocks (see the module docstring).  Equals :func:`dense_attention` on
    the gathered arrays, up to rows whose whole causal-and-valid key set is
    empty (dense softmax leaves them uniform, the ring zero)."""
    n = mesh.axis_size(axis)
    if n == 1:
        return dense_attention(q, k, v, causal=causal, kv_mask=kv_mask)
    group = mesh.axis_group(axis)
    idx = mesh.axis_rank(axis)
    blk_len = q.shape[1]
    perm = collectives.ring_perm(n)
    b, lq, h, d = q.shape
    o = torch.zeros((b, lq, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, lq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, lq), dtype=torch.float32, device=q.device)
    kmask = kv_mask
    for step in range(n):
        kv_blk = (idx - step) % n
        o, m, l = _recomputed(_ring_block, q, k, v, kmask, o, m, l,
                              causal, idx * blk_len, kv_blk * blk_len)
        if step < n - 1:
            k = collectives.ppermute(k, perm, group)
            v = collectives.ppermute(v, perm, group)
            if kmask is not None:
                kmask = collectives.ppermute(kmask, perm, group)
    denom = l.transpose(1, 2)[..., None]               # [b, lq, h, 1]
    return (o / torch.clamp(denom, min=1e-30)).to(q.dtype)


def _ring_block(q, k, v, kmask, o, m, l, causal, q_offset, kv_offset):
    """One hop of the online softmax: the running output, max and
    denominator after the K/V block at ``kv_offset``."""
    s = _scores(q, k, causal=causal, kv_mask=kmask, bias=None,
                q_offset=q_offset, kv_offset=kv_offset)   # [b, h, lq, lk] f32
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(m - m_new)                        # 0 on the first real block
    p = torch.exp(s - m_new[..., None])
    # Zero masked entries even where the whole block is masked (there
    # s == m_new == NEG_INF and the exp above gives 1).
    p = torch.where(s > NEG_INF * 0.5, p, torch.zeros_like(p))
    l_new = l * corr + p.sum(dim=-1)
    # p rounded to v's dtype, the product accumulated in f32 (the
    # reference's preferred_element_type).
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o * corr.transpose(1, 2)[..., None] + pv, m_new, l_new


def _recomputed(fn, *args):
    """``fn(*args)``, its [lq, lk] score temporaries recomputed in the
    backward instead of saved (one block's at a time, whatever the
    length), when gradients are on."""
    if not torch.is_grad_enabled():
        return fn(*args)
    from torch.utils.checkpoint import checkpoint

    return checkpoint(fn, *args, use_reentrant=False)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: Any,
    axis: str = "seq",
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """All-to-all (DeepSpeed-Ulysses) sequence parallelism on this rank's
    blocks (see the module docstring).  Requires the local head count to
    divide by the ``seq`` axis size."""
    n = mesh.axis_size(axis)
    if n == 1:
        return dense_attention(q, k, v, causal=causal, kv_mask=kv_mask)
    if q.shape[2] % n:
        raise ValueError(
            f"local head count {q.shape[2]} not divisible by mesh axis "
            f"{axis}={n} (ulysses re-shards heads across the seq axis; "
            "use ring attention for head counts below the axis size)"
        )
    group = mesh.axis_group(axis)
    qf = collectives.all_to_all(q, 2, 1, group)        # [b, L, h/n, d]
    kf = collectives.all_to_all(k, 2, 1, group)
    vf = collectives.all_to_all(v, 2, 1, group)
    mask_f = (None if kv_mask is None
              else collectives.all_gather(kv_mask, 1, group))
    out = _recomputed(_dense_local, qf, kf, vf, causal, mask_f)
    return collectives.all_to_all(out, 1, 2, group)     # [b, L/n, h, d]


def _dense_local(q, k, v, causal, kv_mask):
    return dense_attention(q, k, v, causal=causal, kv_mask=kv_mask)


def check_divisible(length: int, mesh: Any, axis: str = "seq") -> None:
    """The reference's error for a sequence the axis does not divide."""
    n = mesh.axis_size(axis)
    if length % n:
        raise ValueError(f"seq len {length} not divisible by mesh axis {axis}={n}")


def long_context_batch_partition(sample_batch: Dict[str, Any], mesh: Any, *,
                                 axis: str = "seq",
                                 batch_axis: str = "data") -> Dict[str, tuple]:
    """``TrainLoopConfig.batch_partition`` for a long-context run: every
    token-shaped feature ``[batch, seq, ...]`` (a second dim divisible by
    the ``seq`` axis) split over ``(batch_axis, axis)``, so each rank
    receives its block of the sequence; per-example features keep the
    data-parallel layout and are left out.  ``{}`` on a mesh whose ``seq``
    axis is 1."""
    n = int(mesh.shape[axis])
    if n <= 1:
        return {}
    out = {}
    for key, v in sample_batch.items():
        shape = tuple(getattr(v, "shape", ()) or ())
        if len(shape) >= 2 and shape[1] >= n and shape[1] % n == 0:
            out[key] = (batch_axis, axis)
    return out
