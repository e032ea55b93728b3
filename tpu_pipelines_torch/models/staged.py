"""Pipeline-staged transformer classifier, the port of
``tpu_pipelines/models/staged.py``: pipeline parallelism reachable from
the Trainer.

A token classifier whose transformer depth splits into ``n_stages``
stages: ``embed`` (token embedding plus a learned position table), then
the stages, each ``layers_per_stage`` pre-norm ``TransformerBlock``s,
then ``head`` (a final LayerNorm, the mean over positions, a linear
classifier in f32).  Each stage parameter is STACKED on a leading stage
dim (``stages.layers.0.attn.query.weight`` is ``[S, H*Dh, d_model]``),
and the stage module runs on one slice of them through
``torch.func.functional_call``.

Built on a mesh whose ``pipe`` axis is S > 1 (``n_stages`` must equal it)
a rank holds its stage alone (``[1, ...]`` slices, marked over ``pipe``
with ``parallel.partition.hold_slices``; a whole state dict loads into
them) and the forward runs GPipe (``parallel/pipeline_parallel.py``) over
``num_microbatches``.  With no mesh, or ``pipe`` = 1, or once the stages
are gathered whole, it runs the stages in order: the same network, the
loss-parity oracle of the tests and the serving path after export (the
loaded model needs no mesh).

The reference's constraints hold: a stage's activation is one ``[batch,
seq, d_model]`` tensor, so the stages run UNMASKED dense self-attention
(pad tokens attend; masks would have to ride the pipeline), and dropout
is 0 inside them.  :func:`staged_partition_rules` shard the stacked
stages' leading dim over ``pipe``; ``embed`` and ``head`` replicate.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpu_pipelines_torch.models.transformer import (
    TRUNCATED_NORMAL_STD,
    LayerNorm,
    TransformerBlock,
)
from tpu_pipelines_torch.parallel.partition import (
    draw_whole,
    hold_slices,
    slice_group,
)
from tpu_pipelines_torch.parallel.pipeline_parallel import gpipe

DEFAULT_HPARAMS: Dict[str, Any] = {
    "vocab_size": 64,
    "d_model": 32,
    "n_heads": 2,
    "head_dim": 16,
    "d_ff": 64,
    "max_len": 16,
    "num_classes": 4,
    "n_stages": 4,
    "layers_per_stage": 1,
    "num_microbatches": 4,
    "dtype": "float32",
    "learning_rate": 1e-3,
    "batch_size": 32,
}


class _Embed(nn.Module):
    def __init__(self, vocab_size: int, d_model: int, max_len: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.token = nn.Embedding(vocab_size, d_model)
        self.pos_embedding = nn.Parameter(torch.empty(max_len, d_model))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.token(tokens.long()).to(self.dtype)
        return x + self.pos_embedding[None, :tokens.shape[1]].to(self.dtype)


class _Stage(nn.Module):
    """One pipeline stage: ``layers_per_stage`` transformer blocks (dense
    unmasked attention, dropout 0), shape- and dtype-preserving."""

    def __init__(self, layers_per_stage: int, d_model: int, n_heads: int,
                 head_dim: int, d_ff: int, dtype: torch.dtype):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerBlock(d_model, n_heads, head_dim, d_ff, dropout_rate=0.0,
                             dtype=dtype, attn_impl="dense")
            for _ in range(layers_per_stage))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class _Head(nn.Module):
    def __init__(self, d_model: int, num_classes: int, dtype: torch.dtype):
        super().__init__()
        self.final_norm = LayerNorm(d_model, dtype)
        self.classifier = nn.Linear(d_model, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x).mean(dim=1).float()
        return F.linear(x, self.classifier.weight.float(),
                        self.classifier.bias.float())


class StagedClassifier(nn.Module):
    """embed -> S stacked stages (GPipe on a ``pipe`` mesh, else in
    order) -> head; ``model(tokens)`` gives ``[batch, num_classes]`` f32
    logits."""

    def __init__(self, hp: Dict[str, Any], mesh: Any = None):
        super().__init__()
        dtype = getattr(torch, str(hp["dtype"]))
        d_model = int(hp["d_model"])
        self.n_stages = int(hp["n_stages"])
        self.num_microbatches = int(hp["num_microbatches"])
        self.mesh = mesh
        pipe = mesh.axis_size("pipe") if mesh is not None else 1
        if pipe > 1 and self.n_stages != pipe:
            raise ValueError(f"n_stages {self.n_stages} must equal the mesh "
                             f"pipe axis ({pipe})")
        group = mesh.axis_group("pipe") if pipe > 1 else None
        self.embed = _Embed(int(hp["vocab_size"]), d_model, int(hp["max_len"]),
                            dtype)
        self.stages = _Stage(int(hp["layers_per_stage"]), d_model,
                             int(hp["n_heads"]), int(hp["head_dim"]),
                             int(hp["d_ff"]), dtype)
        held = self.n_stages // pipe
        for module in self.stages.modules():
            for leaf, p in list(module.named_parameters(recurse=False)):
                setattr(module, leaf, nn.Parameter(p.detach().new_empty(held, *p.shape)))
                hold_slices(module, {leaf: (0, group)}, axis="pipe")
        self.stage_names: List[str] = [n for n, _ in self.stages.named_parameters()]
        self.head = _Head(d_model, int(hp["num_classes"]), dtype)

    def _pipe_group(self) -> Any:
        owner, _, leaf = self.stage_names[0].rpartition(".")
        return slice_group(self.stages.get_submodule(owner), leaf, "pipe")

    def _stage(self, params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(self.stages, params, (x,))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed(tokens)
        # getattr reads what an outer functional_call put in place.
        stacked = {n: functools.reduce(getattr, n.split("."), self.stages)
                   for n in self.stage_names}
        if self._pipe_group() is not None:
            x = gpipe(self._stage, stacked, x, mesh=self.mesh,
                      num_microbatches=self.num_microbatches)
        else:
            # The sequential oracle and serving path: the stages in order.
            for i in range(next(iter(stacked.values())).shape[0]):
                x = self._stage({n: p[i] for n, p in stacked.items()}, x)
        return self.head(x)


def build_staged_model(hparams: Optional[Dict[str, Any]] = None,
                       mesh: Any = None) -> StagedClassifier:
    """The reference's ``build_staged_model``; on a ``mesh`` whose ``pipe``
    axis is above 1 each rank holds its stage."""
    return StagedClassifier({**DEFAULT_HPARAMS, **(hparams or {})}, mesh=mesh)


@torch.no_grad()
def init_staged_weights(model: StagedClassifier,
                        generator: torch.Generator) -> StagedClassifier:
    """The flax initialisers' scales, drawn from ``generator``, each stage's
    parameters drawn whole and the rank's stage kept: Dense and
    DenseGeneral kernels lecun-normal (truncated at 2 sigma), zero
    biases, unit LayerNorm, the token embedding normal with std
    sqrt(1 / d_model) (flax ``Embed``'s), the position table normal(0,
    0.02)."""
    for module in model.modules():
        if isinstance(module, nn.Linear):
            std = math.sqrt(1.0 / module.weight.shape[-1]) / TRUNCATED_NORMAL_STD
            draw_whole(module, "weight", lambda w: nn.init.trunc_normal_(
                w, 0.0, std, -2 * std, 2 * std, generator=generator))
            module.bias.zero_()
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            module.weight.normal_(0.0, module.weight.shape[1] ** -0.5,
                                  generator=generator)
        elif isinstance(module, _Embed):
            module.pos_embedding.normal_(0.0, 0.02, generator=generator)
    return model


def staged_partition_rules():
    """``param_partition`` rules: the stacked stage parameters shard their
    leading stage dim over ``pipe``; ``embed`` and ``head`` replicate
    (first match wins)."""
    return [(r"^stages\.", ("pipe",))]
