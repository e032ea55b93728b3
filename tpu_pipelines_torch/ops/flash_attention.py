"""Flash attention forward: a CUDA kernel for Hopper and its plain version.

The counterpart of ``tpu_pipelines/ops/flash_attention.py`` (forward
only).  :func:`flash_attention_forward` computes blockwise online-softmax
self-attention over ``[batch, len, heads, head_dim]`` tensors and returns
the output with the per-row log-sum-exp the backward kernels will read:

  - on a CUDA tensor it launches the kernel in ``csrc/flash_attention.cu``
    (built at first use by ``ops/_build.py``); a build or launch failure
    raises;
  - on a CPU tensor it runs :func:`flash_attention_reference`, the plain
    version of the same function (f32 math, the kernel's masking, scale
    placement, zeros for rows with no allowed key, and LSE);
  - any other device raises.

Semantics kept from the TPU kernel: q is scaled by ``head_dim ** -0.5`` in
f32 before the product, masked scores are ``NEG_INF`` (-1e30), a row whose
allowed key set is empty outputs 0 (dense attention would spread it
uniformly) with ``lse = -1e30``, ``out`` has the input dtype and ``lse`` is
f32 laid out ``[batch * heads, len]``.  The kernel's blocks are fixed
(``BLOCK_Q`` x ``BLOCK_K``) and ragged lengths are masked inside it, so
there is no divisibility rule.

``launches`` counts kernel launches (never plain-version calls), so a run
can show that its attention went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
BLOCK_Q = 64
BLOCK_K = 64
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# tpp_flash_fwd(q, k, v, mask, out, lse, dtype, b, l, h, d, 9 strides,
#               causal, scale, stream) -> cudaError_t
_PROTOTYPES = {
    "tpp_flash_fwd": (
        ctypes.c_int,
        [ctypes.c_void_p] * 6
        + [ctypes.c_int] * 5
        + [ctypes.c_int64] * 9
        + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
    ),
}

# Kernel launches since the process started (or since a caller reset it).
launches = 0
_launch_lock = threading.Lock()


def _check(q, k, v, kv_mask, block_q, block_k) -> None:
    if q.dim() != 4:
        raise ValueError(
            f"flash_attention: q must be [batch, len, heads, head_dim], got "
            f"shape {tuple(q.shape)}"
        )
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            "flash_attention: self-attention needs q, k, v of one shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(
            "flash_attention: q, k, v must share one of float32, float16, "
            f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError(
            f"flash_attention: q, k, v on {q.device}, {k.device}, {v.device}"
        )
    b, l, _, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention: head_dim {d} not supported (one of {HEAD_DIMS})"
        )
    if l == 0 or b == 0:
        raise ValueError(f"flash_attention: empty input {tuple(q.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: head_dim must be contiguous")
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (b, l):
            raise ValueError(
                f"flash_attention: kv_mask must be [{b}, {l}], got "
                f"{tuple(kv_mask.shape)}"
            )
        if kv_mask.device != q.device:
            raise ValueError(
                f"flash_attention: kv_mask on {kv_mask.device}, q on {q.device}"
            )
    for name, given, fixed in (
        ("block_q", block_q, BLOCK_Q), ("block_k", block_k, BLOCK_K)
    ):
        if given is not None and int(given) != fixed:
            raise ValueError(
                f"flash_attention: {name}={given}; the kernel's block is "
                f"fixed at {fixed}"
            )


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: ``(out, lse)`` in f32 math.

    Unblocked (one softmax over the whole row), which equals the kernel's
    online recurrence up to the order of f32 sums."""
    b, l, h, d = q.shape
    s = torch.einsum(
        "bqhd,bkhd->bhqk", q.float() * d ** -0.5, k.float()
    )
    allowed = torch.ones((b, 1, 1, l), dtype=torch.bool, device=q.device)
    if kv_mask is not None:
        allowed = kv_mask.reshape(b, 1, 1, l) > 0
    if causal:
        pos = torch.arange(l, device=q.device)
        allowed = allowed & (pos[:, None] >= pos[None, :])
    s = torch.where(allowed, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(allowed, torch.exp(s - m), 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)    # [b, h, q, 1]
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    out = out / denom.permute(0, 2, 1, 3)
    lse = (m + torch.log(denom)).reshape(b * h, l)
    return out.to(q.dtype), lse


def _launch(q, k, v, kv_mask, causal) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches
    from tpu_pipelines_torch.ops import _build

    fn = _build.load("flash_attention", _PROTOTYPES).tpp_flash_fwd
    b, l, h, d = q.shape
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, l), dtype=torch.float32, device=q.device)
    mask = None
    if kv_mask is not None:
        mask = kv_mask.to(torch.int32).contiguous()
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            _DTYPE_CODES[q.dtype], b, l, h, d,
            *strides, int(causal), d ** -0.5, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_attention: CUDA kernel launch failed with cudaError {err} "
            f"(shape {tuple(q.shape)}, {q.dtype}, {q.device})"
        )
    with _launch_lock:
        launches += 1
    return out, lse


def flash_attention_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Self-attention ``(out [b, l, h, d], lse [b*h, l] f32)``.

    ``kv_mask``: ``[batch, len]`` key validity (> 0 = attend).
    ``block_q`` / ``block_k`` may only name the kernel's fixed blocks."""
    _check(q, k, v, kv_mask, block_q, block_k)
    if q.device.type == "cuda":
        return _launch(q, k, v, kv_mask, causal)
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, causal=causal, kv_mask=kv_mask
        )
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Self-attention over ``[batch, len, heads, head_dim]``; see
    :func:`flash_attention_forward`."""
    return flash_attention_forward(
        q, k, v, causal=causal, kv_mask=kv_mask,
        block_q=block_q, block_k=block_k,
    )[0]
