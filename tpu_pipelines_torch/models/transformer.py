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
``flash`` (both differentiable); ``auto`` means flash where dense
attention's score temporaries do not fit in device memory or the length
reaches the crossover measured on this card (:func:`choose_attn_impl`),
dense otherwise.  With a
``decode_pos`` it runs one incremental decode step against a KV cache: a
plain dict of tensors keyed like the flax ``"cache"`` collection
(``decoder.layer_0.attn.cached_key``, ``...cross.cached_enc_key``), which
the step fills on its first call and then writes into IN PLACE at the
step's position (no copy of the whole cache per layer per step; a write
through a slice of a larger arena lands in the arena).  Its self-attention
takes ``flash`` (the flash-decode kernel) or ``dense``; ``auto`` in the
decode regime means flash at or above the decode crossover measured on
the card and dense otherwise (:func:`choose_decode_impl`).  Both rules
read ``ops/autotune.py``'s table, keyed by the device's kind, with no
device call, so they can sit inside a CUDA-graph capture.  A decode step
of ``q > 1`` tokens with a ``[b]`` position vector is the speculative-
verify window: row i's q keys are written at ``pos[i] + arange(q)`` and
query j sees the cache positions ``<= pos[i] + j`` through a ``[b, 1, q,
kv]`` additive bias.  It runs dense, as the reference's does (the
flash-decode kernel takes one query), and is built from device tensors
only, so it can be captured.

On a mesh whose ``seq`` axis is above 1, self-attention without a bias
takes "ring" or "ulysses" (``parallel/ring_attention.py``), and "auto"
picks the ring from ``RING_MIN_SEQ`` tokens on (:func:`choose_attn_impl`).
Which tokens a rank holds is the mesh's ``seq_split``:

  - set (a ``batch_partition`` over ``seq``, the long-context train
    loop): a rank holds its block of the sequence; ring and Ulysses run
    on the blocks, and "dense" or "flash" gather K, V and the key mask
    over ``seq`` and attend globally, as XLA does for the reference;
  - unset (the BERT Trainer module on a ``seq`` mesh): a rank holds
    whole rows; ring and Ulysses take the rank's block of them and
    gather the output over ``seq``, and "dense" or "flash" attend
    locally.

``MoEMlpBlock`` is the Switch mixture-of-experts MLP (top-1 routing with
a capacity, the aux loss returned through the forward); on an ``expert``
axis a rank holds its slice of the experts and the whole group's tokens,
and on a ``model`` axis its experts' slice of d_ff.

On a split sequence each dropout site draws the whole sequence's mask and
keeps the rank's block, and T5's hidden site the whole d_ff's on a
``model`` axis (:class:`Dropout`), so the ranks draw one process's masks.
Cross-attention on a split sequence gathers its keys over ``seq``, and a
biased self-attention (T5's relative positions, built for the whole
length) attends globally on the dense path.

On a mesh whose ``model`` axis is n > 1 (tensor parallelism, Megatron's
split) attention holds H/n heads (``query``/``key``/``value``
column-parallel, ``out`` row-parallel) and the MLP d_ff/n columns (``wi``
column-parallel, ``wo`` row-parallel); every attention path (dense, flash,
ring, Ulysses, decode) runs on the rank's heads.  A block's input enters
through ``collectives.enter_partial`` (the all-reduce of its gradient)
and each row-parallel product leaves through ``leave_partial`` (the
all-reduce of the partial sums) before its bias, which is added once.
The slices are marked with ``parallel.partition.hold_slices``: a whole
state dict loads into them, ``gather_slices`` makes the module whole (its
heads and group then follow), and at ``model`` = 1 every exchange is the
identity and launches nothing.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpu_pipelines_torch.ops import autotune
from tpu_pipelines_torch.ops.flash_attention import (
    flash_attention,
    flash_decode_attention,
)
from tpu_pipelines_torch.parallel import collectives
from tpu_pipelines_torch.parallel.partition import (
    draw_whole,
    hold_slices,
    slice_group,
)
from tpu_pipelines_torch.parallel.ring_attention import (
    NEG_INF,
    check_divisible,
    dense_attention,
    ring_attention,
    ulysses_attention,
)

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
# Long-context gate for "auto" on a mesh whose 'seq' axis is above 1:
# self-attention at or above this length rides ring attention.  Override
# per process with TPP_RING_MIN_SEQ.
RING_MIN_SEQ = 2048


def _device_memory_bytes(device: Optional[torch.device]) -> int:
    if device is not None and torch.device(device).type == "cuda":
        # The properties are read once and cached by torch: no device call,
        # so an "auto" choice can sit inside a captured CUDA graph.
        return int(torch.cuda.get_device_properties(device).total_memory)
    return FALLBACK_DEVICE_MEMORY_BYTES


def dense_attn_expected_temp_bytes(
    batch: int, heads: int, seq_q: int, seq_kv: int, itemsize: int = 2,
    mesh: Any = None,
) -> int:
    """Estimate of dense attention's O(L^2) temporaries in bytes (per rank
    when a ``mesh`` divides the batch over ``data`` and the heads over
    ``model``, as the reference's)."""
    if mesh is not None:
        batch = -(-batch // max(1, mesh.axis_size("data")))
        heads = -(-heads // max(1, mesh.axis_size("model")))
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
    ``device`` (its total memory from ``torch.cuda.get_device_properties``)."""
    temp = dense_attn_expected_temp_bytes(batch, heads, seq_q, seq_kv, itemsize)
    return temp <= DENSE_ATTN_HBM_FRACTION * _device_memory_bytes(device)


def choose_attn_impl(
    batch: int,
    heads: int,
    seq_q: int,
    seq_kv: int,
    itemsize: int = 2,
    device: Optional[torch.device] = None,
    mesh: Any = None,
) -> str:
    """The "auto" rule, the reference's: 0. "ring" on a ``mesh`` whose
    ``seq`` axis is above 1 for self-attention (``seq_q == seq_kv``, the
    global length) at or above ``TPP_RING_MIN_SEQ`` (default
    ``RING_MIN_SEQ``) or whose dense temporaries do not fit; 1. "flash"
    when dense attention's temporaries do not fit on ``device``; 2.
    "flash" at or above the crossover measured for the device's kind
    (``autotune.lookup_crossover``); 3. "dense" (never measured, or
    measured none: the kernel must earn the hot path).  ``batch`` is this
    rank's rows."""
    if (mesh is not None and mesh.axis_size("seq") > 1
            and seq_q == seq_kv):
        floor = int(os.environ.get("TPP_RING_MIN_SEQ", RING_MIN_SEQ))
        if seq_q >= floor or not dense_attn_fits(
                batch, heads, seq_q, seq_kv, itemsize, device):
            return "ring"
    if not dense_attn_fits(batch, heads, seq_q, seq_kv, itemsize, device):
        return "flash"
    crossover = autotune.lookup_crossover(autotune.current_device_kind(device))
    if crossover is not None and max(seq_q, seq_kv) >= crossover:
        return "flash"
    return "dense"


def choose_decode_impl(
    batch: int,
    heads: int,
    kv_len: int,
    head_dim: int,
    device: Optional[torch.device] = None,
) -> str:
    """The "auto" rule for the single-query decode regime: "flash" at or
    above the decode crossover measured for the device's kind
    (``autotune.lookup_decode_crossover``), "dense" below it or without
    one.  A decode step's scores are tiny, so there is no memory guard."""
    del batch, heads, head_dim  # keyed by device kind and cache length only
    crossover = autotune.lookup_decode_crossover(
        autotune.current_device_kind(device))
    if crossover is not None and kv_len >= crossover:
        return "flash"
    return "dense"


def _dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` applied in ``dtype`` (input and parameters cast per call)."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _row_parallel(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype,
                  group: Any) -> torch.Tensor:
    """``layer`` on this rank's slice of its input features: the partial
    products summed over ``group`` (``leave_partial``), then the bias,
    once; :func:`_dense` without a group."""
    if group is None:
        return _dense(x, layer, dtype)
    partial = F.linear(x.to(dtype), layer.weight.to(dtype))
    return collectives.leave_partial(partial, group) + layer.bias.to(dtype)


def vocab_parallel_lookup(ids: torch.Tensor, weight: torch.Tensor,
                          group: Any) -> torch.Tensor:
    """The rows of ``ids`` from an embedding table of which this rank
    holds the contiguous block ``weight`` of vocabulary rows over
    ``group`` (the whole table without one): each rank looks up the ids
    it holds, zeroes the others, and ``leave_partial`` sums the rows over
    the group, one process's lookup bit for bit."""
    if group is None:
        return F.embedding(ids, weight)
    rows = weight.shape[0]
    local = ids - collectives.axis_rank(group) * rows
    held = (local >= 0) & (local < rows)
    x = F.embedding(torch.where(held, local, 0), weight)
    return collectives.leave_partial(x.masked_fill(~held[..., None], 0.0), group)


def _model_split(mesh: Any, count: int, what: str):
    """(the ``model`` axis's size, its group or None) for ``count`` items
    split over it."""
    n = mesh.axis_size("model") if mesh is not None else 1
    if count % n:
        raise ValueError(f"{count} {what} not divisible by mesh axis model={n}")
    return n, (mesh.axis_group("model") if n > 1 else None)


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
    (the train loop does this).

    A rank that holds a block of the activation draws the mask of the
    whole activation and keeps its block, so the ranks together draw one
    process's mask and their generators advance alike.  Both blocks are
    fixed when the layer is built: its block of the sequence (dim 1) on a
    ``mesh`` whose ``seq_split`` is set, and, given ``columns = (width,
    group)`` (T5's hidden site, d_ff split over ``model``), its block of
    the last dim while that dim is narrower than ``width`` (a module made
    whole by ``gather_slices`` draws the whole width).  Those sites draw n
    times the numbers."""

    def __init__(self, rate: float = 0.0, mesh: Any = None,
                 columns: Optional[Tuple[int, Any]] = None):
        super().__init__()
        self.rate = float(rate)
        self.mesh = mesh
        self.columns = columns if columns is not None and columns[1] is not None else None

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
        blocks = []
        if self.columns is not None and x.shape[-1] != self.columns[0]:
            blocks.append((x.dim() - 1, self.columns[1]))
        if _seq_split(self.mesh):
            blocks.append((1, self.mesh.axis_group("seq")))
        shape = list(x.shape)
        for dim, group in blocks:
            shape[dim] *= collectives.axis_world(group)
        u = torch.rand(shape, generator=generator, device=x.device)
        for dim, group in blocks:
            k = x.shape[dim]
            u = u.narrow(dim, collectives.axis_rank(group) * k, k)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


def _seq_split(mesh: Any) -> bool:
    """Whether a rank's token tensors hold its block of the sequence."""
    return mesh is not None and mesh.seq_split and mesh.axis_size("seq") > 1


def batch_groups(mesh: Any) -> List[Tuple[Any, int]]:
    """(group, size) of each axis a batch's tokens are dealt over, for a
    statistic of the whole batch: ``data`` where the mesh's
    ``whole_batch`` is set (the train loop's implicit mode, whose loss is
    the reference's over the global batch) and ``seq`` on a split
    sequence.  The loop averages a rank's loss and gradients over each,
    so a rank's share of the whole batch's loss is n times its own terms
    over the whole batch's count (``t5_module.loss_fn``,
    ``MoEMlpBlock``'s aux loss)."""
    out = []
    if mesh is not None and mesh.whole_batch and mesh.size > 1:
        out.append((mesh.group, mesh.size))
    if _seq_split(mesh):
        out.append((mesh.axis_group("seq"), mesh.axis_size("seq")))
    return out


class MlpBlock(nn.Module):
    """``wi`` -> tanh-gelu -> ``wo``, dropout at ``dropout_site``: "output"
    (BERT's d_model-wide projection) or "hidden" (T5's DenseReluDense drops
    the d_ff-wide activation).  On a ``mesh`` whose ``model`` axis is n > 1
    it holds d_ff/n columns (see the module docstring)."""

    def __init__(
        self,
        d_model: int,
        d_ff: int,
        *,
        dropout_rate: float = 0.0,
        dtype: torch.dtype = torch.bfloat16,
        dropout_site: str = "output",
        mesh: Any = None,
    ):
        super().__init__()
        if dropout_site not in ("output", "hidden"):
            raise ValueError(f"dropout_site {dropout_site!r}: output or hidden")
        n, group = _model_split(mesh, d_ff, "MLP columns")
        self.dtype = dtype
        self.dropout_site = dropout_site
        self.wi = nn.Linear(d_model, d_ff // n)
        self.wo = nn.Linear(d_ff // n, d_model)
        hold_slices(self.wi, {"weight": (0, group), "bias": (0, group)})
        hold_slices(self.wo, {"weight": (1, group)})
        self.dropout = Dropout(dropout_rate, mesh, columns=(
            (d_ff, group) if dropout_site == "hidden" else None))

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        group = slice_group(self.wo, "weight")
        h = F.gelu(_dense(collectives.enter_partial(x, group), self.wi, self.dtype),
                   approximate="tanh")
        if self.dropout_site == "hidden":
            h = self.dropout(h, generator)
        out = _row_parallel(h, self.wo, self.dtype, group)
        if self.dropout_site == "output":
            out = self.dropout(out, generator)
        return out


# The Switch experts' init: flax variance_scaling(1.0, "fan_in",
# "truncated_normal") per expert slice; the truncated normal's std is
# divided by the std of a unit normal truncated to [-2, 2].
TRUNCATED_NORMAL_STD = 0.87962566103423978


class MoEMlpBlock(nn.Module):
    """Switch-Transformer mixture-of-experts MLP, the reference's
    ``MoEMlpBlock``: top-1 routing with a fixed per-expert capacity, as
    dense dispatch and combine einsums over a ``[G, g, e, c]`` one-hot.

    The router runs in f32 with a bias; the expert is the argmax of its
    softmax (the first on ties); ``capacity = max(1, ceil(cf * g / e))``
    for groups of ``g = group_size`` tokens (0: the sequence length); a
    token's place in its expert's queue is a cumsum over the group, and
    tokens past the capacity are dropped (output zero; the residual
    outside carries them).  The load-balancing loss ``e * sum_e
    (fraction of tokens * mean router probability)`` (1 at perfect
    balance) is appended to ``losses`` when one is handed down.

    ``wi`` ``[E, d_model, d_ff]`` and ``wo`` ``[E, d_ff, d_model]`` keep
    the flax layout and init (fan-in per expert, :meth:`reset_parameters`);
    on a ``mesh`` whose ``expert`` axis is e > 1 they hold this rank's
    E/e experts (``hold_slices`` over ``expert``, :meth:`held_experts`),
    and on one whose ``model`` axis is m > 1 their d_ff/m columns (``wi``
    column-parallel, ``wo`` row-parallel, as the dense MLP's): a rank
    holds ``wi [E/e, d, ff/m]`` and ``wo [E/e, ff/m, d]``, and a state
    dict of the whole experts loads into the rank's slice.  The router
    replicates.  The tokens and the gates enter through ``enter_partial``
    over both axes, and the combined output, a partial sum over the
    rank's experts and columns, leaves through ``leave_partial`` over
    ``model`` and then ``expert``."""

    def __init__(
        self,
        d_model: int,
        num_experts: int,
        d_ff: int,
        *,
        capacity_factor: float = 1.25,
        dropout_rate: float = 0.0,
        dtype: torch.dtype = torch.bfloat16,
        group_size: int = 0,
        mesh: Any = None,
    ):
        super().__init__()
        self.num_experts = num_experts
        self.capacity_factor = float(capacity_factor)
        self.group_size = int(group_size)
        self.dtype = dtype
        n = mesh.axis_size("expert") if mesh is not None else 1
        if num_experts % n:
            raise ValueError(f"{num_experts} experts not divisible by mesh axis "
                             f"expert={n}")
        group = mesh.axis_group("expert") if n > 1 else None
        m, model_group = _model_split(mesh, d_ff, "MoE expert columns")
        self.mesh = mesh
        self.router = nn.Linear(d_model, num_experts)
        self.wi = nn.Parameter(torch.empty(num_experts // n, d_model, d_ff // m))
        self.wo = nn.Parameter(torch.empty(num_experts // n, d_ff // m, d_model))
        hold_slices(self, {"wi": (0, group), "wo": (0, group)}, axis="expert")
        hold_slices(self, {"wi": (2, model_group), "wo": (1, model_group)})
        self.dropout = Dropout(dropout_rate, mesh)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The experts' fan-in truncated-normal init, all E drawn from
        ``generator`` (so every expert rank draws the same) and this
        rank's slice kept."""
        for leaf in ("wi", "wo"):
            def draw(w):
                std = (1.0 / w.shape[1]) ** 0.5 / TRUNCATED_NORMAL_STD
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)

            draw_whole(self, leaf, draw)

    def held_experts(self) -> range:
        """The experts this rank holds (all E once the block is whole)."""
        group = slice_group(self, "wi", "expert")
        k = self.wi.shape[0]
        first = torch.distributed.get_rank(group) * k if group is not None else 0
        return range(first, first + k)

    def forward(
        self,
        x: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        losses: Optional[List[torch.Tensor]] = None,
    ) -> torch.Tensor:
        b, l, d = x.shape
        n, e = b * l, self.num_experts
        g_size = self.group_size or l
        if n % g_size:
            raise ValueError(f"{n} tokens not divisible by MoE group_size {g_size}")
        t = x.reshape(n // g_size, g_size, d)
        probs, sel, pos_in_expert, capacity = self._route(t)
        expert_gate = (probs * sel).sum(dim=-1)                # the top-1 prob
        keep = (pos_in_expert >= 0) & (pos_in_expert < capacity)
        slot = torch.where(keep, pos_in_expert, capacity)
        slots = (slot[..., None] == torch.arange(capacity, device=x.device))
        dispatch = sel.to(self.dtype)[..., None] * slots.to(self.dtype)[:, :, None, :]
        held = self.held_experts()
        dispatch = dispatch[:, :, held.start:held.stop]        # [G, g, e_local, c]
        groups = (slice_group(self, "wi", "expert"), slice_group(self, "wi"))
        tokens, gate_in = t.to(self.dtype), expert_gate
        for group in groups:
            tokens = collectives.enter_partial(tokens, group)
            gate_in = collectives.enter_partial(gate_in, group)
        expert_in = torch.einsum("gnec,gnd->gecd", dispatch, tokens)
        h = F.gelu(torch.einsum("gecd,edf->gecf", expert_in, self.wi.to(self.dtype)),
                   approximate="tanh")
        expert_out = torch.einsum("gecf,efd->gecd", h, self.wo.to(self.dtype))
        combine = dispatch * gate_in.to(self.dtype)[..., None, None]
        out = torch.einsum("gnec,gecd->gnd", combine, expert_out)
        for group in reversed(groups):
            out = collectives.leave_partial(out, group)
        if losses is not None:
            frac_tokens = sel.float().mean(dim=(0, 1))         # [e]
            frac_probs = probs.mean(dim=(0, 1))                # [e]
            # The whole batch's means (the ranks hold equal token counts);
            # frac_probs keeps its own gradient, n times its share, as the
            # loop averages a rank's gradients over the group.
            for group, n in batch_groups(self.mesh):
                frac_tokens = collectives.leave_partial(frac_tokens, group) / n
                whole = collectives.leave_partial(frac_probs.detach(), group) / n
                frac_probs = frac_probs + (whole - frac_probs.detach())
            losses.append(e * torch.sum(frac_tokens * frac_probs))
        return self.dropout(out.reshape(b, l, d), generator)

    def _route(self, t: torch.Tensor):
        """Router probabilities ``[G, g, e]`` (f32), the top-1 one-hot
        ``sel`` (int32), each token's 0-based place in its expert's queue
        and the capacity."""
        g_size, e = t.shape[1], self.num_experts
        probs = torch.softmax(_dense(t, self.router, torch.float32), dim=-1)
        expert = probs.argmax(dim=-1)                          # [G, g]
        sel = (expert[..., None] == torch.arange(e, device=t.device)).to(torch.int32)
        pos = torch.cumsum(sel, dim=1) * sel                   # 1-based where sel
        capacity = max(1, math.ceil(self.capacity_factor * g_size / e))
        return probs, sel, pos.sum(dim=-1) - 1, capacity

    @torch.no_grad()
    def routing(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """For reports: the tokens of ``x`` routed to each expert (before
        the capacity) and the share the capacity keeps."""
        b, l, d = x.shape
        g_size = self.group_size or l
        _, sel, pos, capacity = self._route(x.reshape(b * l // g_size, g_size, d))
        return {"tokens_per_expert": sel.sum(dim=(0, 1)),
                "kept_share": (pos < capacity).float().mean()}


def apply_with_moe_aux(model: nn.Module, *args, **kwargs):
    """``model(*args, **kwargs)`` and the sum of every MoE layer's
    load-balancing loss (0.0 when the model has none): the reference's
    ``apply_with_moe_aux``.  A loss function adds ``aux_weight * aux``:

        logits, aux = apply_with_moe_aux(model, batch, generator=g)
        loss = task_loss(logits) + 0.01 * aux
    """
    losses: List[torch.Tensor] = []
    out = model(*args, losses=losses, **kwargs)
    if losses:
        return out, torch.stack(losses).sum()
    return out, torch.zeros((), dtype=torch.float32, device=out.device)


ATTN_IMPLS = ("dense", "flash", "ring", "ulysses", "auto")


class MultiHeadAttention(nn.Module):
    """Self- or cross-attention with ``attn_impl`` "dense", "flash",
    "ring", "ulysses" or "auto" (ring and Ulysses on a ``mesh`` whose
    ``seq`` axis is above 1; see the module docstring).

    ``query``/``key``/``value`` hold the flax ``DenseGeneral`` kernels
    ``[d_model, H, Dh]`` as ``Linear(d_model, H*Dh)``; ``out`` holds
    ``[H, Dh, d_model]`` as ``Linear(H*Dh, d_model)``.  Flash runs
    unbiased self-attention only: cross-attention and biased attention
    (T5's relative positions) take the dense path, except in a decode step,
    whose self-attention runs the flash-decode kernel with the bias.  On a
    ``mesh`` whose ``model`` axis is n > 1 it holds H/n heads
    (``n_heads`` is the count held; see the module docstring)."""

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
        mesh: Any = None,
    ):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r}: one of {ATTN_IMPLS}")
        n, group = _model_split(mesh, n_heads, "heads")
        self.mesh = mesh
        self.head_dim = head_dim
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.causal = causal
        inner = n_heads // n * head_dim
        self.query = nn.Linear(d_model, inner)
        self.key = nn.Linear(d_model, inner)
        self.value = nn.Linear(d_model, inner)
        self.out = nn.Linear(inner, d_model)
        for layer in (self.query, self.key, self.value):
            hold_slices(layer, {"weight": (0, group), "bias": (0, group)})
        hold_slices(self.out, {"weight": (1, group)})
        self.dropout = Dropout(dropout_rate, mesh)

    @property
    def n_heads(self) -> int:
        """The heads this module holds (all of them off a ``model`` axis)."""
        return self.query.weight.shape[0] // self.head_dim

    def _heads(self, x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
        b, l, _ = x.shape
        return _dense(x, layer, self.dtype).view(b, l, self.n_heads, self.head_dim)

    def _project_out(self, out: torch.Tensor) -> torch.Tensor:
        b, l = out.shape[:2]
        return _row_parallel(out.reshape(b, l, -1), self.out, self.dtype,
                             slice_group(self.out, "weight"))

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
        group = slice_group(self.out, "weight")
        x = collectives.enter_partial(x, group)
        if not is_self:
            x_kv = collectives.enter_partial(x_kv, group)
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
        n_seq = self.mesh.axis_size("seq") if self.mesh is not None else 1
        split = _seq_split(self.mesh)
        if split and not is_self:
            # Cross-attention on a split sequence: this rank's block of
            # queries attends to the whole source, gathered over seq.
            group = self.mesh.axis_group("seq")
            k, v = (collectives.all_gather(t, 1, group) for t in (k, v))
            if kv_mask is not None:
                kv_mask = collectives.all_gather(kv_mask, 1, group)
            split = False
        impl = self.attn_impl
        if impl == "auto":
            length = q.shape[1] * (n_seq if split else 1)
            impl = choose_attn_impl(
                q.shape[0], self.n_heads, length,
                k.shape[1] * (n_seq if split else 1),
                q.element_size(), device=x.device, mesh=self.mesh,
            )
        if impl in ("ring", "ulysses") and is_self and bias is None and n_seq > 1:
            out = self._sequence_parallel(impl, q, k, v, kv_mask, split)
        elif split:
            out = self._split_global(impl, q, k, v, kv_mask, bias)
        elif impl == "flash" and is_self and bias is None:
            out = flash_attention(q, k, v, causal=self.causal, kv_mask=kv_mask)
        else:
            out = dense_attention(q, k, v, causal=self.causal, kv_mask=kv_mask,
                                  bias=bias)
        return self.dropout(self._project_out(out), generator)

    def _sequence_parallel(self, impl, q, k, v, kv_mask, split):
        """Ring or Ulysses over ``seq``: on this rank's blocks when the
        sequence is split, else on the rank's block of whole rows, the
        output gathered over ``seq``."""
        attend = ring_attention if impl == "ring" else ulysses_attention
        mesh = self.mesh
        if split:
            return attend(q, k, v, mesh=mesh, causal=self.causal, kv_mask=kv_mask)
        check_divisible(q.shape[1], mesh)
        n, r = mesh.axis_size("seq"), mesh.axis_rank("seq")
        blk = q.shape[1] // n

        def block(t):
            return None if t is None else t.narrow(1, r * blk, blk)

        out = attend(block(q), block(k), block(v), mesh=mesh, causal=self.causal,
                     kv_mask=block(kv_mask))
        return collectives.all_gather(out, 1, mesh.axis_group("seq"))

    def _split_global(self, impl, q, k, v, kv_mask, bias):
        """"dense" or "flash" on a split sequence: q, k, v and the key mask
        gathered over ``seq``, attention over the whole sequence, and this
        rank's block of the output (the flash kernels take one length for
        queries and keys).  A ``bias`` (T5's relative positions, built for
        the whole length) takes the dense path, as the reference's."""
        group = self.mesh.axis_group("seq")
        blk, r = q.shape[1], self.mesh.axis_rank("seq")
        q, k, v = (collectives.all_gather(t, 1, group) for t in (q, k, v))
        if kv_mask is not None:
            kv_mask = collectives.all_gather(kv_mask, 1, group)
        if impl == "flash" and bias is None:
            out = flash_attention(q, k, v, causal=self.causal, kv_mask=kv_mask)
        else:
            out = dense_attention(q, k, v, causal=self.causal, kv_mask=kv_mask,
                                  bias=bias)
        return out.narrow(1, r * blk, blk)

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
        over the positions <= its own (per row for a vector position).  A
        ``q > 1`` window with a vector position is the speculative verify
        (see the module docstring)."""
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
        qlen = q.shape[1]
        verify_window = False
        if isinstance(decode_pos, torch.Tensor) and decode_pos.dim() == 1:
            rows = torch.arange(b, device=q.device)
            if qlen == 1:
                ck[rows, decode_pos] = k[:, 0]
                cv[rows, decode_pos] = v[:, 0]
                valid = positions[None, :] <= decode_pos[:, None]
            else:
                idx = (decode_pos[:, None]
                       + torch.arange(qlen, device=q.device)[None, :])
                ck.index_put_((rows[:, None], idx), k)
                cv.index_put_((rows[:, None], idx), v)
                # Per-query causality over the cache: dense_attention's
                # kv_mask is per row, so the window goes into the bias
                # with the same exact-zero weight.
                win = positions[None, None, :] <= idx[:, :, None]
                wbias = torch.where(win, 0.0, NEG_INF)[:, None]
                bias = wbias if bias is None else bias + wbias
                valid = None
                verify_window = True
        elif qlen != 1:
            raise ValueError(
                "a multi-token decode step needs a [b] position vector"
            )
        else:
            pos = int(decode_pos)
            ck[:, pos] = k[:, 0]
            cv[:, pos] = v[:, 0]
            valid = (positions <= pos)[None, :].expand(b, kv_len)
        impl = "dense" if verify_window else self.attn_impl
        if impl == "auto":
            impl = choose_decode_impl(b, self.n_heads, kv_len, self.head_dim,
                                      device=q.device)
        if impl == "flash":
            out = flash_decode_attention(q, ck, cv, kv_mask=valid, bias=bias)
        else:
            out = dense_attention(q, ck, cv, kv_mask=valid, bias=bias)
        return self._project_out(out)


class TransformerBlock(nn.Module):
    """Pre- or post-norm block: self-attention [+ cross-attention] + MLP
    (an :class:`MoEMlpBlock` of ``moe_experts`` experts when above 0), with
    LayerNorm (BERT) or RMSNorm (T5)."""

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
        moe_experts: int = 0,
        moe_capacity_factor: float = 1.25,
        mesh: Any = None,
    ):
        super().__init__()
        if norm not in ("layernorm", "rmsnorm"):
            raise ValueError(f"norm {norm!r}: layernorm or rmsnorm")
        norm_cls = RMSNorm if norm == "rmsnorm" else LayerNorm
        self.prenorm = prenorm
        self.use_cross = use_cross
        self.attn = MultiHeadAttention(
            d_model, n_heads, head_dim, dropout_rate=dropout_rate,
            dtype=dtype, attn_impl=attn_impl, causal=causal, mesh=mesh,
        )
        self.attn_norm = norm_cls(d_model, dtype)
        if use_cross:
            self.cross = MultiHeadAttention(
                d_model, n_heads, head_dim, dropout_rate=dropout_rate,
                dtype=dtype, attn_impl=attn_impl, causal=False, mesh=mesh,
            )
            self.cross_norm = norm_cls(d_model, dtype)
        if moe_experts > 0:
            # The reference's module name: ``layer_i/moe``.
            self.moe = MoEMlpBlock(
                d_model, moe_experts, d_ff, capacity_factor=moe_capacity_factor,
                dropout_rate=dropout_rate, dtype=dtype, mesh=mesh,
            )
        else:
            self.mlp = MlpBlock(
                d_model, d_ff, dropout_rate=dropout_rate, dtype=dtype,
                dropout_site=mlp_dropout_site, mesh=mesh,
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
        losses: Optional[List[torch.Tensor]] = None,
    ) -> torch.Tensor:
        """``losses``: where an MoE MLP appends its load-balancing loss."""
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
        if hasattr(self, "moe"):
            return self._sub(x, self.mlp_norm,
                             lambda h: self.moe(h, generator, losses))
        return self._sub(x, self.mlp_norm, lambda h: self.mlp(h, generator))
