"""Flash attention: CUDA kernels for Hopper and their plain versions.

The counterpart of ``tpu_pipelines/ops/flash_attention.py``.
:func:`flash_attention` is blockwise online-softmax self-attention over
``[batch, len, heads, head_dim]`` tensors, differentiable through
:class:`FlashAttentionFunction` (the reference's ``_flash`` custom_vjp):

  - the forward (:func:`flash_attention_forward`) returns the output and
    the per-row log-sum-exp, and the Function saves
    ``(q, k, v, mask, out, lse)``;
  - the backward (:func:`flash_attention_backward`) computes
    ``Dvec = rowsum(dO * O)`` (:func:`flash_bwd_dvec`) and from it ``dq``
    (:func:`flash_bwd_dq`) and ``dk``, ``dv`` (:func:`flash_bwd_dkv`),
    recomputing the probabilities from the saved LSE.

:func:`flash_decode_attention` is the decode regime: one query per
(batch, head) against a padded KV cache with key validity and an additive
bias, inference only (the reference's ``flash_decode_attention``).  Its
CUDA kernel splits each row's keys across the CTAs of a thread-block
cluster (:func:`decode_splits`, :func:`decode_split_ranges`) and merges
the splits in the same launch.

Each entry point dispatches on the device of its tensors:

  - on a CUDA tensor it launches the kernels in ``csrc/flash_attention.cu``,
    ``csrc/flash_attention_bwd.cu`` and ``csrc/flash_decode.cu`` (built at
    first use by ``ops/_build.py``); a build or launch failure raises;
  - on a CPU tensor it runs the plain version of the same function
    (:func:`flash_attention_reference`, :func:`_dvec`,
    :func:`flash_bwd_dq_reference`, :func:`flash_bwd_dkv_reference`,
    :func:`flash_decode_attention_reference`: f32 math, the kernels'
    masking, scale placement, zeros for rows with no allowed key, and LSE);
  - any other device raises.

Semantics kept from the TPU kernels: the forward scales q by
``head_dim ** -0.5`` in f32 before the product and the backward scales the
product, masked scores are ``NEG_INF`` (-1e30), a row whose allowed key set
is empty outputs 0 (dense attention would spread it uniformly) with
``lse = -1e30``, gets a zero ``dq`` and adds nothing to ``dk``/``dv``;
outputs and gradients have the input dtype and ``lse`` is f32 laid out
``[batch * heads, len]``.  Ragged lengths are masked inside the kernels, so
there is no divisibility rule.

Blocks.  The bf16 and fp16 kernels are built for every pair of
:data:`FLASH_BLOCKS` (``block_q`` in {64, 128}, ``block_k`` in {32, 64,
128}; the forward, dq and dk/dv take the same pairs) and the decode kernel
for every ``block_k`` of :data:`DECODE_BLOCKS`, at head dims 64 and 128,
where the fixed tiles fit the 227 KB of shared memory a block may opt into
(:func:`built_blocks`, :func:`built_decode_blocks`); each configuration is
a library of its own (``ops/_build.py``).  Head dims 16 and 32 and the f32
kernels keep the default 64 x 64 (decode 64).  :func:`flash_attention`
takes ``block_q``, ``block_k``, ``bwd_block_q`` and ``bwd_block_k`` with
the reference's precedence (:func:`resolve_blocks`): explicit blocks win;
else the autotune table's ``flash_fwd`` and ``flash_bwd`` entries for the
shape (``ops/autotune.py``, ``TPP_AUTOTUNE``); else 64 x 64, the backward
taking the forward's blocks.  :func:`flash_decode_attention` reads the
``flash_decode`` entry for ``block_k`` (:func:`resolve_decode_block`), and
its split rule counts in that block.  Every block is clamped to the
largest built one at or below the request (``autotune.clamp_block``),
which raises when there is none; on the CPU the blocks are validated by the
same rules and the unblocked plain versions ignore them.

The forward and backward kernels for bf16 and fp16 run their products on
the tensor cores and round ``p`` (and, in the backward, ``dS``) to the
input dtype before the second products (``O = p v``; ``dV = p^T dO``,
``dK = dS^T q``, ``dq = dS k``), as SDPA and dense bf16 attention do;
their plain versions keep both in f32.  :func:`fwd_rounding_terms` and
:func:`bwd_rounding_terms` give the per-element sums that bound the
difference (see ``UNIT_ROUNDOFF``).  f32 runs on FMA kernels with every
product in f32.

``launches``, ``dq_launches``, ``dkv_launches``, ``dvec_launches`` and
``decode_launches`` count kernel launches that ran (never plain-version
calls), so a run can show that its attention went through the kernels.  A
wrapper called while its stream captures a CUDA graph launches nothing: it
records into the open :func:`launch_tally` instead, and whoever replays
the graph adds that tally to the counters once per replay
(:func:`credit`).  A capture with no tally open raises.  Captures take
turns under :data:`capture_lock` (the serving warm-up's and the train
loop's alike), since the tally is module-wide.

FLOP accounting: ``FlopCounterMode`` cannot see a kernel launched
through ``ctypes``, and on the CPU it would see the plain version's own
products instead, so a naive count differs between the devices.  So
:class:`FlashAttentionFunction` reaches the wrappers through two
operators of their own, ``torch.ops.tpp_flash.fwd`` and ``bwd``, each
with a FLOP formula registered with ``torch.utils.flop_counter``
(forward ``4·B·H·Lq·Lk·D``, backward ``8·B·H·Lq·Lk·D``: the products of
dense attention, with no recompute of the scores).  A counting mode sees
the operator, counts it by formula and runs it below itself, so the
plain version's matmuls are never counted a second time; the mode is the
counting thread's own (autograd carries it into its backward thread), so
attention run meanwhile on another thread is not counted.  The operators
add nothing else: launches, captures and counters are as before.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import Dict, Iterator, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

NEG_INF = -1e30
# The default block pair, built for every dtype and head dim (the f32
# kernels and head dims 16 and 32 have no other).
BLOCK_Q = 64
BLOCK_K = 64
HEAD_DIMS = (16, 32, 64, 128)
# The (block_q, block_k) pairs the bf16 and fp16 forward, dq and dk/dv
# kernels are built for at BLOCK_HEAD_DIMS: each a translation unit and a
# library of its own (-DTPP_BQ, -DTPP_BK), built in parallel.
FLASH_BLOCKS = ((64, 32), (64, 64), (64, 128), (128, 32), (128, 64), (128, 128))
BLOCK_HEAD_DIMS = (64, 128)
# Dynamic shared memory a block may opt into on Hopper (227 KB): a pair
# whose fixed tiles exceed it at a head dim is not built there.
MAX_SMEM_BYTES = 232448
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# tpp_flash_fwd(q, k, v, mask, out, lse, dtype, b, l, h, d, 9 strides,
#               causal, scale, block_q, block_k, stream) -> cudaError_t
_PROTOTYPES = {
    "tpp_flash_fwd": (
        ctypes.c_int,
        [ctypes.c_void_p] * 6
        + [ctypes.c_int] * 5
        + [ctypes.c_int64] * 9
        + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p],
    ),
    # (dtype, d, l, block_q, block_k, int[3] out) -> cudaError_t
    "tpp_flash_fwd_kernel_info": (
        ctypes.c_int, [ctypes.c_int] * 5 + [ctypes.c_int * 3],
    ),
}
# tpp_flash_bwd_dq(q, k, v, dout, mask, lse, dvec, dq, dtype, b, l, h, d,
#                  strides[12], causal, scale, block_q, block_k, stream)
#                  -> cudaError_t;
# tpp_flash_bwd_dkv takes dk, dv in place of dq;
# tpp_flash_bwd_dvec(out, dout, dvec, dtype, b, l, h, d, strides[6], stream)
# (in the 64 x 64 library).
_STRIDES = ctypes.c_int64 * 12
_DVEC_STRIDES = ctypes.c_int64 * 6
_BWD_PROTOTYPES = {
    "tpp_flash_bwd_dq": (
        ctypes.c_int,
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
        + [_STRIDES, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p],
    ),
    "tpp_flash_bwd_dkv": (
        ctypes.c_int,
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
        + [_STRIDES, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p],
    ),
    "tpp_flash_bwd_dvec": (
        ctypes.c_int,
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
        + [_DVEC_STRIDES, ctypes.c_void_p],
    ),
    # (which, dtype, d, l, block_q, block_k, int[3] out) -> cudaError_t
    "tpp_flash_bwd_kernel_info": (
        ctypes.c_int, [ctypes.c_int] * 6 + [ctypes.c_int * 3],
    ),
}
# Unit roundoff of the dtype the 16-bit kernels round p (and dS) to before
# their second products: bf16 (8 significant bits) 2^-8, fp16 (11) 2^-11;
# the f32 kernels round neither.
UNIT_ROUNDOFF = {
    torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11, torch.float32: 0.0,
}

# tpp_flash_decode(q, k, v, mask, bias, out, dtype, mask_code, b, l, h, d,
#                  splits, block_k, strides[13], scale, stream) -> cudaError_t
_DECODE_STRIDES = ctypes.c_int64 * 13
_DECODE_PROTOTYPES = {
    "tpp_flash_decode": (
        ctypes.c_int,
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
        + [_DECODE_STRIDES, ctypes.c_float, ctypes.c_void_p],
    ),
    # (dtype, d, splits, block_k, int[5] out) -> cudaError_t
    "tpp_flash_decode_kernel_info": (
        ctypes.c_int, [ctypes.c_int] * 4 + [ctypes.c_int * 5],
    ),
}
# The decode kernel's mask codes: no mask, int32, bool.
_DECODE_MASK_CODES = {None: 0, torch.int32: 1, torch.bool: 2}
# Keys per block of the decode kernel's walk over the cache: the default
# (every dtype and head dim) and the blocks bf16 and fp16 are built for at
# BLOCK_HEAD_DIMS, each a library of its own (-DTPP_BLOCK_K); a split is a
# run of whole blocks.
DECODE_BLOCK_K = 64
DECODE_BLOCKS = (32, 64, 128)
# Split rule of the decode kernel: about DECODE_CTAS_PER_SM CTAs on each of
# the card's SMs, at most DECODE_MAX_SPLITS (the portable cluster size), at
# least DECODE_SPLIT_BLOCKS blocks per split, and no split of a cache of at
# most DECODE_UNSPLIT_BLOCKS blocks (there the cluster's merge costs more
# than the walk it shortens).
DECODE_CTAS_PER_SM = 2
DECODE_MAX_SPLITS = 8
DECODE_SPLIT_BLOCKS = 2
DECODE_UNSPLIT_BLOCKS = 4

# Kernel launches since the process started (or since a caller reset
# them): flash_fwd, flash_bwd_dq, flash_bwd_dkv, flash_bwd_dvec,
# flash_decode.
launches = 0
dq_launches = 0
dkv_launches = 0
dvec_launches = 0
decode_launches = 0
COUNTERS = ("launches", "dq_launches", "dkv_launches", "dvec_launches",
            "decode_launches")
_launch_lock = threading.Lock()
# The tally of the graph capture under way, if any (module-wide, not per
# thread: autograd runs a captured backward on its own device thread).
_capture_tally: Optional[Dict[str, int]] = None
# One capture at a time in the process: two would interleave their records
# in the module-wide tally.  Held around every CUDA-graph capture.
capture_lock = threading.Lock()


def _count(name: str, capturing: bool) -> None:
    """One launch of the kernel counted by ``name``: onto its counter, or,
    while the launching stream captures a graph, into the open tally."""
    with _launch_lock:
        if not capturing:
            globals()[name] += 1
        elif _capture_tally is None:
            raise RuntimeError(
                f"flash_attention: a kernel ({name}) was captured into a CUDA "
                "graph with no launch tally open; capture inside "
                "fa.launch_tally() and credit() the tally at each replay"
            )
        else:
            _capture_tally[name] += 1


@contextlib.contextmanager
def launch_tally() -> Iterator[Dict[str, int]]:
    """Open the tally that kernels captured into a CUDA graph record into
    (one per capture; counters keyed as :data:`COUNTERS`)."""
    global _capture_tally
    tally = dict.fromkeys(COUNTERS, 0)
    with _launch_lock:
        if _capture_tally is not None:
            raise RuntimeError("flash_attention: a launch tally is already open")
        _capture_tally = tally
    try:
        yield tally
    finally:
        with _launch_lock:
            _capture_tally = None


def credit(tally: Dict[str, int], replays: int = 1) -> None:
    """Add a captured graph's ``tally`` to the counters for ``replays``
    replays of it."""
    with _launch_lock:
        for name, n in tally.items():
            globals()[name] += n * replays


def smem_bytes(kernel: str, block_q: int, block_k: int, head_dim: int) -> int:
    """Fixed dynamic shared memory of the bf16/fp16 kernel ``kernel``
    ("fwd", "dq" or "dkv") at one block pair and head dim, as its source
    counts it (the forward's and dq's mask bit set, ``ceil(L / 32)`` words,
    comes on top at launch)."""
    tile = 2 * head_dim   # bytes of one 16-bit row
    if kernel == "fwd":    # Q, two stages of K and V
        return (block_q + 4 * block_k) * tile
    if kernel == "dq":     # Q, dO, two stages of K and V
        return (2 * block_q + 4 * block_k) * tile
    # dkv: K, V, two stages of Q, dO and of the f32 lse and Dvec rows
    return 2 * block_k * tile + 4 * block_q * tile + 4 * block_q * 4


def built_blocks(op: str, dtype: torch.dtype, head_dim: int):
    """The (block_q, block_k) pairs the kernels of ``op`` ("flash_fwd": the
    forward; "flash_bwd": dq and dk/dv) are built for at ``dtype`` and
    ``head_dim``: every pair of :data:`FLASH_BLOCKS` whose kernels' fixed
    tiles fit :data:`MAX_SMEM_BYTES` for bf16 and fp16 at
    :data:`BLOCK_HEAD_DIMS`, else the default pair alone."""
    if dtype not in (torch.bfloat16, torch.float16) or head_dim not in BLOCK_HEAD_DIMS:
        return [(BLOCK_Q, BLOCK_K)]
    kernels = ("fwd",) if op == "flash_fwd" else ("dq", "dkv")
    return [(bq, bk) for bq, bk in FLASH_BLOCKS
            if all(smem_bytes(kern, bq, bk, head_dim) <= MAX_SMEM_BYTES
                   for kern in kernels)]


def built_decode_blocks(dtype: torch.dtype, head_dim: int):
    """The ``block_k`` values the decode kernel is built for at ``dtype``
    and ``head_dim`` (its shared memory does not depend on the block)."""
    if dtype in (torch.bfloat16, torch.float16) and head_dim in BLOCK_HEAD_DIMS:
        return list(DECODE_BLOCKS)
    return [DECODE_BLOCK_K]


def _flash_defines(block_q: int, block_k: int) -> Dict[str, int]:
    return {"TPP_BQ": block_q, "TPP_BK": block_k}


def kernel_builds():
    """Every library the kernels are built into, as ``(source name,
    defines)``: the forward and the backward at each pair of
    :data:`FLASH_BLOCKS`, the decode kernel at each of
    :data:`DECODE_BLOCKS` (``ops/_build.py build``)."""
    return ([(name, _flash_defines(bq, bk))
             for name in ("flash_attention", "flash_attention_bwd")
             for bq, bk in FLASH_BLOCKS]
            + [("flash_decode", {"TPP_BLOCK_K": bk}) for bk in DECODE_BLOCKS])


def _blocks(op: str, q: torch.Tensor, block_q, block_k, names=("block_q", "block_k")):
    """``(block_q, block_k)`` for the kernels of ``op`` on ``q``: each given
    block (else the default) clamped to the largest built one at or below
    it (``autotune.clamp_block``: raises when there is none)."""
    from tpu_pipelines_torch.ops import autotune

    d = q.shape[-1]
    return (
        autotune.clamp_block(op, q.dtype, d, BLOCK_Q if block_q is None else block_q,
                             names[0]),
        autotune.clamp_block(op, q.dtype, d, BLOCK_K if block_k is None else block_k,
                             names[1]),
    )


def _check(q, k, v, kv_mask) -> None:
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


def _aligned16(t: torch.Tensor) -> bool:
    """Every [.., head_dim] row of ``t`` (read with 16-byte loads by the
    decode, Dvec and 16-bit forward and backward kernels) starts on a
    16-byte boundary."""
    item = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        (stride * item) % 16 == 0
        for size, stride in zip(t.shape[:3], t.stride()[:3]) if size > 1
    )


def _require_aligned16(op: str, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if not _aligned16(t):
            raise ValueError(
                f"{op}: {name}'s rows must start on 16-byte boundaries "
                f"(data_ptr {t.data_ptr()}, strides {t.stride()})"
            )


def _allowed(b: int, l: int, device, causal: bool,
             kv_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """[b, 1, l, l] or [b, 1, 1, l] bool: the (query, key) pairs a row may
    attend to."""
    allowed = torch.ones((b, 1, 1, l), dtype=torch.bool, device=device)
    if kv_mask is not None:
        allowed = kv_mask.reshape(b, 1, 1, l) > 0
    if causal:
        pos = torch.arange(l, device=device)
        allowed = allowed & (pos[:, None] >= pos[None, :])
    return allowed


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: ``(out, lse)`` in f32
    math.

    Unblocked (one softmax over the whole row), which equals the kernel's
    online recurrence up to the order of f32 sums (and, for bf16 and fp16,
    the kernel's rounding of p: :func:`fwd_rounding_terms`)."""
    b, l, h, _ = q.shape
    p, m, denom = _fwd_probs(q, k, causal, kv_mask)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    out = out / denom.permute(0, 2, 1, 3)
    lse = (m + torch.log(denom)).reshape(b * h, l)
    return out.to(q.dtype), lse


def _fwd_probs(q, k, causal, kv_mask):
    """The forward's unnormalised ``p`` (f32 ``[b, h, lq, lk]``, 0 at
    disallowed keys), the row max ``m`` and ``denom = max(sum p, 1e-30)``
    (``[b, h, lq, 1]``)."""
    b, l, _, d = q.shape
    s = torch.einsum(
        "bqhd,bkhd->bhqk", q.float() * d ** -0.5, k.float()
    )
    allowed = _allowed(b, l, q.device, causal, kv_mask)
    s = torch.where(allowed, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(allowed, torch.exp(s - m), 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)    # [b, h, q, 1]
    return p, m, denom


def fwd_rounding_terms(q, k, v, *, causal=False, kv_mask=None):
    """``sum_k (p_k / l) |v_k|``, f32 ``[b, l, h, d]``, from the plain
    version's f32 normalised probabilities (0 on a row with no allowed
    key).

    The 16-bit forward kernel rounds each ``p`` to the input dtype
    (relative error at most ``u = UNIT_ROUNDOFF[dtype]``) before
    ``O = p v`` and sums ``l`` from the unrounded ``p``, so each output
    element moves by at most ``u`` times its term from that rounding; the
    order of f32 sums and the output's own rounding come on top."""
    p, _, denom = _fwd_probs(q, k, causal, kv_mask)
    return torch.einsum("bhqk,bkhd->bqhd", p / denom, v.float().abs())


def _dvec(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the ``flash_bwd_dvec`` kernel:
    ``Dvec = rowsum(dO * O)`` in f32, laid out ``[b * h, l]`` like lse."""
    b, l, h, _ = out.shape
    dvec = (dout.float() * out.float()).sum(dim=-1)           # [b, l, h]
    return dvec.permute(0, 2, 1).reshape(b * h, l).contiguous()


def _probs(q, k, v, dout, lse, dvec, causal, kv_mask):
    """The backward's recomputed ``p`` and ``dS``, f32 ``[b, h, lq, lk]``,
    and the scale."""
    b, l, h, d = q.shape
    scale = d ** -0.5
    s = scale * torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    allowed = _allowed(b, l, q.device, causal, kv_mask)
    # A select, never a product: an all-masked row has lse = -1e30 and
    # exp(s - lse) overflows there.
    p = torch.where(allowed, torch.exp(s - lse.reshape(b, h, l, 1)), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    return p, p * (dp - dvec.reshape(b, h, l, 1)), scale


def bwd_rounding_terms(q, k, v, dout, lse, dvec, *, causal=False,
                       kv_mask=None):
    """``(scale |dS| |k|, scale |dS|^T |q|, |p|^T |dO|)``, f32
    ``[b, l, h, d]``, from the plain version's f32 ``p`` and ``dS``.

    The 16-bit backward kernels round each ``p`` and ``dS`` to the input
    dtype (relative error at most ``u = UNIT_ROUNDOFF[dtype]``) before
    ``dq = scale dS k``, ``dk = scale dS^T q`` and ``dv = p^T dO``, so each
    gradient element moves by at most ``u`` times its term from that
    rounding; the order of f32 sums and the output's own rounding come on
    top."""
    p, ds, scale = _probs(q, k, v, dout, lse, dvec, causal, kv_mask)
    ds = ds.abs()
    t_dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds, k.float().abs())
    t_dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds, q.float().abs())
    t_dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float().abs())
    return t_dq, t_dk, t_dv


def flash_bwd_dq_reference(q, k, v, dout, lse, dvec, *, causal=False,
                           kv_mask=None) -> torch.Tensor:
    """Plain PyTorch version of the ``flash_bwd_dq`` kernel:
    ``dq = scale * dS k`` with ``dS = p * (dO v^T - Dvec)`` and
    ``p = allowed ? exp(scale * q k^T - lse) : 0``, f32 math, q's dtype."""
    _, ds, scale = _probs(q, k, v, dout, lse, dvec, causal, kv_mask)
    return (scale * torch.einsum("bhqk,bkhd->bqhd", ds, k.float())).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, dout, lse, dvec, *, causal=False,
                            kv_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the ``flash_bwd_dkv`` kernel:
    ``dk = scale * dS^T q`` and ``dv = p^T dO``, f32 math, q's dtype."""
    p, ds, scale = _probs(q, k, v, dout, lse, dvec, causal, kv_mask)
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the whole backward: ``(dq, dk, dv)`` in the
    input dtype, f32 math, the reference's formula over whole rows
    (``_flash_backward``)."""
    dvec = _dvec(out, dout)
    dq = flash_bwd_dq_reference(q, k, v, dout, lse, dvec, causal=causal,
                                kv_mask=kv_mask)
    dk, dv = flash_bwd_dkv_reference(q, k, v, dout, lse, dvec, causal=causal,
                                     kv_mask=kv_mask)
    return dq, dk, dv


def _launch(q, k, v, kv_mask, causal, block_q, block_k
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    from tpu_pipelines_torch.ops import _build

    if q.dtype != torch.float32:  # the tensor-core kernel's cp.async copies
        _require_aligned16("flash_attention", q=q, k=k, v=v)
    fn = _build.load("flash_attention", _PROTOTYPES,
                     _flash_defines(block_q, block_k)).tpp_flash_fwd
    b, l, h, d = q.shape
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, l), dtype=torch.float32, device=q.device)
    mask = None
    if kv_mask is not None:
        mask = kv_mask.to(torch.int32).contiguous()
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        capturing = torch.cuda.is_current_stream_capturing()
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            _DTYPE_CODES[q.dtype], b, l, h, d,
            *strides, int(causal), d ** -0.5, block_q, block_k, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_attention: CUDA kernel launch failed with cudaError {err} "
            f"(shape {tuple(q.shape)}, {q.dtype}, blocks {block_q}x{block_k}, "
            f"{q.device})"
        )
    _count("launches", capturing)
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
    ``block_q`` / ``block_k``: the kernel's block pair (default 64 x 64, no
    table: :func:`flash_attention` resolves the tuned one), each clamped to
    the largest built block at or below it."""
    _check(q, k, v, kv_mask)
    block_q, block_k = _blocks("flash_fwd", q, block_q, block_k)
    if q.device.type == "cuda":
        return _launch(q, k, v, kv_mask, causal, block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, causal=causal, kv_mask=kv_mask
        )
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


def _launch_bwd(name, q, k, v, dout, lse, dvec, kv_mask, causal, n_out,
                block_q, block_k):
    """Launch ``tpp_flash_bwd_<name>`` into ``n_out`` new gradient tensors."""
    from tpu_pipelines_torch.ops import _build

    if q.dtype != torch.float32:  # the tensor-core kernels' cp.async copies
        _require_aligned16("flash_attention backward", q=q, k=k, v=v, dout=dout)
    fn = getattr(_build.load("flash_attention_bwd", _BWD_PROTOTYPES,
                             _flash_defines(block_q, block_k)),
                 f"tpp_flash_bwd_{name}")
    b, l, h, d = q.shape
    mask = None
    if kv_mask is not None:
        mask = kv_mask.to(torch.int32).contiguous()
    strides = _STRIDES(*(s for t in (q, k, v, dout) for s in t.stride()[:3]))
    grads = [torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
             for _ in range(n_out)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        capturing = torch.cuda.is_current_stream_capturing()
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            None if mask is None else mask.data_ptr(), lse.data_ptr(),
            dvec.data_ptr(), *(g.data_ptr() for g in grads),
            _DTYPE_CODES[q.dtype], b, l, h, d, strides, int(causal),
            d ** -0.5, block_q, block_k, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_attention: CUDA kernel flash_bwd_{name} launch failed "
            f"with cudaError {err} (shape {tuple(q.shape)}, {q.dtype}, "
            f"blocks {block_q}x{block_k}, {q.device})"
        )
    _count(f"{name}_launches", capturing)
    return grads


def _check_bwd(q, k, v, dout, lse, dvec, kv_mask) -> None:
    _check(q, k, v, kv_mask)
    b, l, h, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device:
        raise ValueError(
            f"flash_attention backward: dout {dout.dtype} "
            f"{tuple(dout.shape)} on {dout.device} must match q {q.dtype} "
            f"{tuple(q.shape)} on {q.device}"
        )
    if dout.stride(-1) != 1:
        raise ValueError("flash_attention backward: dout's head_dim must be "
                         "contiguous")
    for name, t in (("lse", lse), ("dvec", dvec)):
        if (tuple(t.shape) != (b * h, l) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(
                f"flash_attention backward: {name} must be a contiguous "
                f"float32 [{b * h}, {l}] tensor on {q.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
            )


def flash_bwd_dq(q, k, v, dout, lse, dvec, *, causal=False, kv_mask=None,
                 block_q=None, block_k=None) -> torch.Tensor:
    """``dq`` from the saved ``lse`` and ``dvec = rowsum(dO * O)``: the
    ``flash_bwd_dq`` kernel on CUDA tensors (at the block pair ``block_q``
    x ``block_k``, default 64 x 64, clamped as the forward's), its plain
    version on CPU tensors."""
    _check_bwd(q, k, v, dout, lse, dvec, kv_mask)
    blocks = _blocks("flash_bwd", q, block_q, block_k)
    if q.device.type == "cuda":
        return _launch_bwd("dq", q, k, v, dout, lse, dvec, kv_mask, causal, 1,
                           *blocks)[0]
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, dout, lse, dvec, causal=causal,
                                      kv_mask=kv_mask)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


def flash_bwd_dkv(q, k, v, dout, lse, dvec, *, causal=False, kv_mask=None,
                  block_q=None, block_k=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` from the saved ``lse`` and ``dvec``: the
    ``flash_bwd_dkv`` kernel on CUDA tensors (at the block pair, as
    :func:`flash_bwd_dq`), its plain version on CPU tensors."""
    _check_bwd(q, k, v, dout, lse, dvec, kv_mask)
    blocks = _blocks("flash_bwd", q, block_q, block_k)
    if q.device.type == "cuda":
        dk, dv = _launch_bwd("dkv", q, k, v, dout, lse, dvec, kv_mask, causal, 2,
                             *blocks)
        return dk, dv
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, dout, lse, dvec, causal=causal,
                                       kv_mask=kv_mask)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


def _launch_dvec(out, dout) -> torch.Tensor:
    from tpu_pipelines_torch.ops import _build

    _require_aligned16("flash_attention backward", out=out, dout=dout)
    fn = _build.load("flash_attention_bwd", _BWD_PROTOTYPES,
                     _flash_defines(BLOCK_Q, BLOCK_K)).tpp_flash_bwd_dvec
    b, l, h, d = out.shape
    dvec = torch.empty((b * h, l), dtype=torch.float32, device=out.device)
    strides = _DVEC_STRIDES(*out.stride()[:3], *dout.stride()[:3])
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        capturing = torch.cuda.is_current_stream_capturing()
        err = fn(out.data_ptr(), dout.data_ptr(), dvec.data_ptr(),
                 _DTYPE_CODES[out.dtype], b, l, h, d, strides, stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention: CUDA kernel flash_bwd_dvec launch failed with "
            f"cudaError {err} (shape {tuple(out.shape)}, {out.dtype}, "
            f"{out.device})"
        )
    _count("dvec_launches", capturing)
    return dvec


def fwd_kernel_info(dtype: torch.dtype, head_dim: int, length: int,
                    block_q: int = BLOCK_Q, block_k: int = BLOCK_K) -> dict:
    """Registers and local memory (spill) bytes a thread of the CUDA
    forward kernel takes for ``dtype``, ``head_dim`` and the block pair
    (the FMA kernel for f32, the tensor-core kernel for bf16 and fp16), and
    its dynamic shared memory at ``length``; builds the library if
    needed."""
    from tpu_pipelines_torch.ops import _build

    fn = _build.load("flash_attention", _PROTOTYPES,
                     _flash_defines(block_q, block_k)).tpp_flash_fwd_kernel_info
    info = (ctypes.c_int * 3)()
    err = fn(_DTYPE_CODES[dtype], head_dim, length, block_q, block_k, info)
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel info for flash_fwd failed "
                           f"with cudaError {err}")
    return {"registers": info[0], "local_bytes": info[1],  # tpp: disable=TPP214 (dict key)
            "shared_bytes": info[2]}  # tpp: disable=TPP214 (dict key)


def bwd_kernel_info(name: str, dtype: torch.dtype, head_dim: int,
                    length: int, block_q: int = BLOCK_Q,
                    block_k: int = BLOCK_K) -> dict:
    """Registers and local memory (spill) bytes a thread of the CUDA kernel
    ``flash_bwd_<name>`` (``"dq"`` or ``"dkv"``) takes for ``dtype``,
    ``head_dim`` and the block pair, and its dynamic shared memory at
    ``length``; builds the library if needed."""
    from tpu_pipelines_torch.ops import _build

    fn = _build.load("flash_attention_bwd", _BWD_PROTOTYPES,
                     _flash_defines(block_q, block_k)).tpp_flash_bwd_kernel_info
    info = (ctypes.c_int * 3)()
    err = fn({"dq": 0, "dkv": 1}[name], _DTYPE_CODES[dtype], head_dim, length,
             block_q, block_k, info)
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel info for flash_bwd_{name} "
                           f"failed with cudaError {err}")
    return {"registers": info[0], "local_bytes": info[1],  # tpp: disable=TPP214 (dict key)
            "shared_bytes": info[2]}  # tpp: disable=TPP214 (dict key)


def flash_bwd_dvec(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``Dvec = rowsum(dO * O)``, f32 ``[b * h, l]``: the ``flash_bwd_dvec``
    kernel on CUDA tensors, its plain version (:func:`_dvec`) on CPU
    tensors."""
    if (out.dim() != 4 or dout.shape != out.shape or dout.dtype != out.dtype
            or dout.device != out.device):
        raise ValueError(
            f"flash_attention backward: dout {dout.dtype} {tuple(dout.shape)} "
            f"on {dout.device} must match out {out.dtype} {tuple(out.shape)} "
            f"on {out.device}, [batch, len, heads, head_dim]"
        )
    if out.dtype not in _DTYPE_CODES or out.shape[-1] not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention backward: out {out.dtype} with head_dim "
            f"{out.shape[-1]} (one of {HEAD_DIMS}) not supported"
        )
    if out.stride(-1) != 1 or dout.stride(-1) != 1:
        raise ValueError("flash_attention backward: out's and dout's head_dim "
                         "must be contiguous")
    if out.device.type == "cuda":
        return _launch_dvec(out, dout)
    if out.device.type == "cpu":
        return _dvec(out, dout)
    raise ValueError(f"flash_attention: no kernel for device {out.device}")


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_attention_forward` for the output
    cotangent ``dout``, from the forward's ``out`` and ``lse``:
    :func:`flash_bwd_dvec`, then :func:`flash_bwd_dq` and
    :func:`flash_bwd_dkv` at the block pair ``block_q`` x ``block_k``.  A
    ``dout`` whose rows the kernels cannot read with 16-byte loads (a
    strided last dim, a misaligned view) is copied into a contiguous tensor
    first."""
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(
                f"flash_attention backward: {name} {tuple(t.shape)} on "
                f"{t.device} must match q {tuple(q.shape)} on {q.device}"
            )
    if dout.stride(-1) != 1 or (dout.device.type == "cuda"
                                and not _aligned16(dout)):
        dout = dout.clone(memory_format=torch.contiguous_format)
    dvec = flash_bwd_dvec(out, dout)
    dq = flash_bwd_dq(q, k, v, dout, lse, dvec, causal=causal, kv_mask=kv_mask,
                      block_q=block_q, block_k=block_k)
    dk, dv = flash_bwd_dkv(q, k, v, dout, lse, dvec, causal=causal,
                           kv_mask=kv_mask, block_q=block_q, block_k=block_k)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """The reference's ``_flash`` custom_vjp: the forward (at ``block_q`` x
    ``block_k``) saves ``(q, k, v, mask, out, lse)``; the backward (at
    ``bwd_block_q`` x ``bwd_block_k``) returns ``(dq, dk, dv)`` and no
    gradient for the mask, the causal flag or the blocks."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, block_q, block_k, bwd_block_q,
                bwd_block_k):
        out, lse = torch.ops.tpp_flash.fwd(q, k, v, kv_mask, causal, block_q,
                                           block_k)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.causal = causal
        ctx.bwd_blocks = (bwd_block_q, bwd_block_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = torch.ops.tpp_flash.bwd(
            q, k, v, kv_mask, ctx.causal, out, lse, dout, *ctx.bwd_blocks)
        return dq, dk, dv, None, None, None, None, None, None


# The operators FlashAttentionFunction runs (see the module docstring).
_ops = torch.library.Library("tpp_flash", "DEF")
_ops.define("fwd(Tensor q, Tensor k, Tensor v, Tensor? kv_mask, bool causal, "
            "int block_q=64, int block_k=64) -> (Tensor, Tensor)")
_ops.define("bwd(Tensor q, Tensor k, Tensor v, Tensor? kv_mask, bool causal, "
            "Tensor out, Tensor lse, Tensor dout, int block_q=64, "
            "int block_k=64) -> (Tensor, Tensor, Tensor)")
_ops.impl("fwd", lambda q, k, v, kv_mask, causal, block_q=BLOCK_Q,
          block_k=BLOCK_K: flash_attention_forward(
              q, k, v, causal=causal, kv_mask=kv_mask, block_q=block_q,
              block_k=block_k), "CompositeExplicitAutograd")
_ops.impl("bwd", lambda q, k, v, kv_mask, causal, out, lse, dout,
          block_q=BLOCK_Q, block_k=BLOCK_K:
          flash_attention_backward(q, k, v, out, lse, dout, causal=causal,
                                   kv_mask=kv_mask, block_q=block_q,
                                   block_k=block_k),
          "CompositeExplicitAutograd")


# Shapes for tracing with fake tensors (torch.export, serving/saved_model.py):
# the impls above launch through ctypes, which a fake tensor cannot run, so
# a traced program keeps the operator and runs it when it is called.  These
# also serve the meta device, which has no kernel: it is refused as before.
def _no_meta(q):
    if q.device.type == "meta":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")


@torch.library.register_fake("tpp_flash::fwd")
def _fwd_fake(q, k, v, kv_mask, causal, block_q=BLOCK_Q, block_k=BLOCK_K):
    _no_meta(q)
    b, l, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b * h, l), dtype=torch.float32)


@torch.library.register_fake("tpp_flash::bwd")
def _bwd_fake(q, k, v, kv_mask, causal, out, lse, dout, block_q=BLOCK_Q,
              block_k=BLOCK_K):
    _no_meta(q)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _products(q_shape, k_shape) -> int:
    """``2·B·H·Lq·Lk·D``: one of attention's products."""
    b, lq, h, d = q_shape
    return 2 * b * h * lq * k_shape[1] * d


@register_flop_formula(torch.ops.tpp_flash.fwd)
def _fwd_flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * _products(q_shape, k_shape)


@register_flop_formula(torch.ops.tpp_flash.bwd)
def _bwd_flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    return 4 * _products(q_shape, k_shape)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    bwd_block_q: Optional[int] = None,
    bwd_block_k: Optional[int] = None,
) -> torch.Tensor:
    """Differentiable self-attention over ``[batch, len, heads, head_dim]``;
    see :func:`flash_attention_forward` and
    :func:`flash_attention_backward`.  The forward's and the backward's
    blocks are chosen as the reference's are (:func:`resolve_blocks`)."""
    _check(q, k, v, kv_mask)
    blocks = resolve_blocks(q, causal, block_q, block_k, bwd_block_q,
                            bwd_block_k)
    return FlashAttentionFunction.apply(q, k, v, kv_mask, causal, *blocks)


def resolve_blocks(q, causal=False, block_q=None, block_k=None,
                   bwd_block_q=None, bwd_block_k=None):
    """``(block_q, block_k, bwd_block_q, bwd_block_k)`` for
    :func:`flash_attention` on ``q`` (``[b, l, h, d]``), by the reference's
    precedence: explicit forward blocks win, and then the backward takes
    its own explicit blocks or else the forward's; with none given, the
    autotune table's ``flash_fwd`` and ``flash_bwd`` entries for this shape
    (``autotune.get_block_config``: ``TPP_AUTOTUNE``'s modes, the user
    cache before the committed table, never a sweep while the stream
    captures a graph), else 64 x 64.  Each block is clamped to the largest
    built one at or below it."""
    from tpu_pipelines_torch.ops import autotune

    b, l, h, d = q.shape

    def tuned(op):
        return autotune.get_block_config(op, b, h, l, d, q.dtype, causal,
                                         device=q.device)

    explicit = block_q is not None or block_k is not None
    if not explicit:
        cfg = tuned("flash_fwd")
        if cfg is not None:
            block_q, block_k = cfg
    block_q = BLOCK_Q if block_q is None else block_q
    block_k = BLOCK_K if block_k is None else block_k
    if not explicit and bwd_block_q is None and bwd_block_k is None:
        cfg = tuned("flash_bwd")
        if cfg is not None:
            bwd_block_q, bwd_block_k = cfg
    bwd_block_q = block_q if bwd_block_q is None else bwd_block_q
    bwd_block_k = block_k if bwd_block_k is None else bwd_block_k
    return (*_blocks("flash_fwd", q, block_q, block_k),
            *_blocks("flash_bwd", q, bwd_block_q, bwd_block_k,
                     ("bwd_block_q", "bwd_block_k")))


# ------------------------------------------------------------------ decode

def _check_decode(q, k, v, kv_mask, bias) -> None:
    if k.dim() != 4 or q.dim() != 4:
        raise ValueError(
            "flash_decode_attention: q must be [batch, 1, heads, head_dim] and "
            f"k, v [batch, len, heads, head_dim]; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}"
        )
    b, l, h, d = k.shape
    if v.shape != k.shape or tuple(q.shape) != (b, 1, h, d):
        raise ValueError(
            "flash_decode_attention: q must be [batch, 1, heads, head_dim] "
            "against k, v of one [batch, len, heads, head_dim] shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(
            "flash_decode_attention: q, k, v must share one of float32, "
            f"float16, bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError(
            f"flash_decode_attention: q, k, v on {q.device}, {k.device}, "
            f"{v.device}"
        )
    if d not in HEAD_DIMS:
        raise ValueError(
            f"flash_decode_attention: head_dim {d} not supported (one of "
            f"{HEAD_DIMS})"
        )
    if l == 0 or b == 0:
        raise ValueError(f"flash_decode_attention: empty cache {tuple(k.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_decode_attention: head_dim must be contiguous")
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (b, l):
            raise ValueError(
                f"flash_decode_attention: kv_mask must be [{b}, {l}], got "
                f"{tuple(kv_mask.shape)}"
            )
        if kv_mask.dtype not in (torch.int32, torch.bool):
            raise TypeError(
                f"flash_decode_attention: kv_mask must be int32 or bool, got "
                f"{kv_mask.dtype}"
            )
        if kv_mask.device != q.device:
            raise ValueError(
                f"flash_decode_attention: kv_mask on {kv_mask.device}, q on "
                f"{q.device}"
            )
    if bias is not None:
        if tuple(bias.shape) not in ((1, h, 1, l), (b, h, 1, l)):
            raise ValueError(
                f"flash_decode_attention: bias must be [1|{b}, {h}, 1, {l}], "
                f"got {tuple(bias.shape)}"
            )
        if bias.dtype != torch.float32:
            raise TypeError(
                f"flash_decode_attention: bias must be float32, got {bias.dtype}"
            )
        if bias.device != q.device:
            raise ValueError(
                f"flash_decode_attention: bias on {bias.device}, q on {q.device}"
            )


def flash_decode_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the decode kernel, f32 math, q's dtype:
    ``s = (q * D^-0.5) k^T + bias``, masked keys ``NEG_INF``, ``p = allowed
    ? exp(s - m) : 0``, ``out = p v / max(sum p, 1e-30)`` (a row with no
    allowed key gives 0)."""
    b, l, h, d = k.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * d ** -0.5, k.float())
    if bias is not None:
        s = s + bias.float()
    allowed = torch.ones((b, 1, 1, l), dtype=torch.bool, device=q.device)
    if kv_mask is not None:
        allowed = kv_mask.reshape(b, 1, 1, l) > 0
    s = torch.where(allowed, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(allowed, torch.exp(s - m), 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)    # [b, h, 1, 1]
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return (out / denom.permute(0, 2, 1, 3)).to(q.dtype)


def decode_splits(b: int, h: int, l: int, sms: int,
                  block_k: int = DECODE_BLOCK_K) -> int:
    """Splits S of the decode kernel's KV range for a [b, l, h, d] cache on
    a card of ``sms`` SMs: enough CTAs (S * b * h) to fill the card, about
    ``DECODE_CTAS_PER_SM * sms``, at most ``DECODE_MAX_SPLITS``, at most one
    per ``DECODE_SPLIT_BLOCKS`` blocks of ``block_k`` keys, and 1 for a
    cache of at most ``DECODE_UNSPLIT_BLOCKS`` blocks.  The S CTAs of one
    (batch, head) form one cluster."""
    blocks = -(-l // block_k)
    if blocks <= DECODE_UNSPLIT_BLOCKS:
        return 1
    want = -(-DECODE_CTAS_PER_SM * sms // (b * h))
    return min(want, DECODE_MAX_SPLITS, blocks // DECODE_SPLIT_BLOCKS)


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """SMs of the CUDA card ``device`` (read once per card)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def decode_split_ranges(l: int, splits: int, block_k: int = DECODE_BLOCK_K):
    """The key range [begin, end) of each split, in rank order: split r
    takes whole blocks of ``block_k`` keys ``[r * nb // S, (r + 1) * nb //
    S)`` of the ``nb`` blocks (the last one cut at ``l``), as the kernel
    does."""
    nb = -(-l // block_k)
    return [(r * nb // splits * block_k, min(l, (r + 1) * nb // splits * block_k))
            for r in range(splits)]


def decode_kernel_info(dtype: torch.dtype, head_dim: int, splits: int,
                       block_k: int = DECODE_BLOCK_K) -> dict:
    """Registers and local memory (spill) bytes a thread of the CUDA decode
    kernel takes for ``dtype``, ``head_dim`` and ``block_k``, its static
    shared memory, the CTAs an SM holds and the clusters of ``splits`` CTAs
    the card runs at once (``cudaOccupancyMaxActiveClusters``); builds the
    library if needed."""
    from tpu_pipelines_torch.ops import _build

    fn = _build.load("flash_decode", _DECODE_PROTOTYPES,
                     {"TPP_BLOCK_K": block_k}).tpp_flash_decode_kernel_info
    info = (ctypes.c_int * 5)()
    err = fn(_DTYPE_CODES[dtype], head_dim, splits, block_k, info)
    if err != 0:
        raise RuntimeError(f"flash_decode_attention: kernel info failed with "
                           f"cudaError {err}")
    return {"registers": info[0], "local_bytes": info[1],  # tpp: disable=TPP214 (dict key)
            "shared_bytes": info[2], "ctas_per_sm": info[3],  # tpp: disable=TPP214 (dict key)
            "max_active_clusters": info[4]}


def _launch_decode(q, k, v, kv_mask, bias, block_k) -> torch.Tensor:
    from tpu_pipelines_torch.ops import _build

    _require_aligned16("flash_decode_attention", q=q, k=k, v=v)
    fn = _build.load("flash_decode", _DECODE_PROTOTYPES,
                     {"TPP_BLOCK_K": block_k}).tpp_flash_decode
    b, l, h, d = k.shape
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    # The mask is read in place, int32 or bool, through its strides (an
    # expanded [b, l] view has batch stride 0).
    mask_strides = (0, 0) if kv_mask is None else kv_mask.stride()
    bias_strides = (0, 0, 0)
    if bias is not None:
        # A leading dim of 1 broadcasts over the batch: batch stride 0.
        bias_strides = (bias.stride(0) if bias.shape[0] > 1 else 0,
                        bias.stride(1), bias.stride(3))
    strides = _DECODE_STRIDES(q.stride(0), q.stride(2), *k.stride()[:3],
                              *v.stride()[:3], *mask_strides, *bias_strides)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        capturing = torch.cuda.is_current_stream_capturing()
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_mask is None else kv_mask.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype],
            _DECODE_MASK_CODES[None if kv_mask is None else kv_mask.dtype],
            b, l, h, d, decode_splits(b, h, l, sm_count(q.device), block_k),
            block_k, strides, d ** -0.5, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_decode_attention: CUDA kernel launch failed with cudaError "
            f"{err} (cache {tuple(k.shape)}, {q.dtype}, block_k {block_k}, "
            f"{q.device})"
        )
    _count("decode_launches", capturing)
    return out


def flash_decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    kv_mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Single-query attention against a KV cache (the decode regime).

    ``q``: [batch, 1, heads, head_dim], this step's one token per row.
    ``k``/``v``: [batch, kv_len, heads, head_dim], the padded cache, read
    through its strides (a slice of a larger arena is read in place).
    ``kv_mask``: [batch, kv_len] validity, int32 or bool (> 0 = attend;
    None: every key).  ``bias``: additive f32 [1|batch, heads, 1, kv_len]
    score term (T5 relative positions), broadcast over the batch when its
    leading dim is 1.  Returns [batch, 1, heads, head_dim] in q's dtype.
    Inference only (no gradient).  ``block_k``: explicit, else the autotune
    table's ``flash_decode`` entry for the shape, else ``DECODE_BLOCK_K``
    (:func:`resolve_decode_block`)."""
    _check_decode(q, k, v, kv_mask, bias)
    b, l, h, d = k.shape
    block_k = resolve_decode_block(b, h, l, d, q.dtype, q.device, block_k)
    if q.device.type == "cuda":
        return _launch_decode(q, k, v, kv_mask, bias, block_k)
    if q.device.type == "cpu":
        return flash_decode_attention_reference(
            q, k, v, kv_mask=kv_mask, bias=bias
        )
    raise ValueError(f"flash_decode_attention: no kernel for device {q.device}")


def resolve_decode_block(b: int, h: int, l: int, d: int, dtype: torch.dtype,
                         device, block_k: Optional[int] = None) -> int:
    """The decode kernel's ``block_k`` for a ``[b, l, h, d]`` cache of
    ``dtype`` on ``device``, by the reference's precedence: explicit, else
    the autotune table's ``flash_decode`` entry for the shape, else
    ``DECODE_BLOCK_K``; clamped to the largest built block at or below
    it."""
    from tpu_pipelines_torch.ops import autotune

    if block_k is None:
        cfg = autotune.get_block_config("flash_decode", b, h, l, d, dtype,
                                        False, device=device)
        if cfg is not None:
            block_k = cfg[1]
    return autotune.clamp_block("flash_decode", dtype, d,
                                DECODE_BLOCK_K if block_k is None else block_k,
                                "block_k")
