"""BERT encoder and heads, the port of ``tpu_pipelines/models/bert.py``.

Post-LN, as the original BERT.  The three embeddings are gathered, cast to
the compute dtype and summed in it; the pooler and the classifier head run
in f32 on the [CLS] position.  Weights come from a flax tree through
``models/convert.py`` or from :func:`init_bert_weights`.  Its partition
rules are ``parallel/partition.py``'s ``bert_partition_rules``.

On a mesh whose ``model`` axis is n > 1 (tensor parallelism) the blocks
hold their rank's heads and MLP columns (``models/transformer.py``), the
token embedding its V/n vocabulary rows (each rank looks up the ids it
holds, zeroes the others, and the rows are summed over ``model`` by
``leave_partial``: one process's lookup, bit for bit) and the MLM head its
V/n logit columns, all-gathered by ``leave_split``; ``pos_embed``,
``type_embed``, the norms, the pooler and the classifier replicate.
:func:`init_bert_weights` draws every whole weight and keeps the rank's
slice, so a tensor-parallel model starts from one process's weights.

``moe_experts > 0`` makes every odd layer (the Switch convention) a
mixture-of-experts MLP (``models/transformer.py``'s ``MoEMlpBlock``),
expert-parallel over the mesh ``expert`` axis; the forward takes a
``losses`` list its load-balancing losses go to (``apply_with_moe_aux``).

On a mesh whose ``seq`` axis is above 1 and whose ``seq_split`` is set
(a ``batch_partition`` over ``seq``), a rank's tokens are its block of
the sequence: ``pos_embed`` reads the
block's global positions, and the [CLS] row, which only the first ``seq``
rank holds, is broadcast over ``seq`` before the pooler.  Every rank then
computes the same pooler, head and loss: the objective is their sum, the
broadcast's backward brings the sum of their gradients home to the first
rank, and the encoder's exchanges carry it to every block, so the train
loop's mean over ``seq`` of each rank's gradient is the single-device
gradient (the replicated tail's own gradient is the same on every rank,
the encoder's the sum of each rank's share).  Each dropout site draws
the whole sequence's mask and keeps the rank's block (``Dropout``), so a
split run draws one process's masks.  Unset, a rank holds whole rows.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpu_pipelines_torch.models.transformer import (
    Dropout,
    LayerNorm,
    MoEMlpBlock,
    TransformerBlock,
    _dense,
    _model_split,
    _seq_split,
    vocab_parallel_lookup,
)
from tpu_pipelines_torch.parallel import collectives
from tpu_pipelines_torch.parallel.partition import (
    draw_whole,
    hold_slices,
    slice_group,
)


class BertEncoder(nn.Module):
    def __init__(
        self,
        vocab_size: int = 30522,
        d_model: int = 768,
        n_layers: int = 12,
        n_heads: int = 12,
        d_ff: int = 3072,
        max_len: int = 512,
        type_vocab_size: int = 2,
        dropout_rate: float = 0.1,
        dtype: torch.dtype = torch.bfloat16,
        attn_impl: str = "dense",
        moe_experts: int = 0,
        mesh: Any = None,
    ):
        super().__init__()
        self.mesh = mesh
        self.vocab_size = vocab_size
        self.dtype = dtype
        n, group = _model_split(mesh, vocab_size, "vocabulary rows")
        self.embed = nn.Embedding(vocab_size // n, d_model)
        hold_slices(self.embed, {"weight": (0, group)})
        self.pos_embed = nn.Embedding(max_len, d_model)
        self.type_embed = nn.Embedding(type_vocab_size, d_model)
        self.embed_norm = LayerNorm(d_model, dtype)
        self.dropout = Dropout(dropout_rate, mesh)
        self.layers = nn.ModuleList(
            TransformerBlock(
                d_model, n_heads, d_model // n_heads, d_ff,
                dropout_rate=dropout_rate, dtype=dtype, attn_impl=attn_impl,
                causal=False, prenorm=False,
                moe_experts=moe_experts if i % 2 == 1 else 0, mesh=mesh,
            )
            for i in range(n_layers)
        )

    def forward(
        self,
        input_ids: torch.Tensor,
        *,
        token_type_ids: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        losses: Optional[list] = None,
    ) -> torch.Tensor:
        ids = input_ids.long()
        l = ids.shape[1]
        x = self._token_embed(ids).to(self.dtype)
        start = self.mesh.axis_rank("seq") * l if _seq_split(self.mesh) else 0
        pos = torch.arange(start, start + l, device=ids.device)
        x = x + self.pos_embed(pos)[None].to(self.dtype)
        types = (torch.zeros_like(ids) if token_type_ids is None
                 else token_type_ids.long())
        x = x + self.type_embed(types).to(self.dtype)
        x = self.dropout(self.embed_norm(x), generator)
        for layer in self.layers:
            x = layer(x, attention_mask, generator, losses=losses)
        return x

    def _token_embed(self, ids: torch.Tensor) -> torch.Tensor:
        """The token embedding's rows of ``ids`` (vocabulary-parallel on a
        ``model`` axis: see the module docstring)."""
        return vocab_parallel_lookup(ids, self.embed.weight,
                                     slice_group(self.embed, "weight"))

    def cls(self, x: torch.Tensor) -> torch.Tensor:
        """The [CLS] row of the encoder's output ``x``: on a split
        sequence, the first ``seq`` rank's, broadcast over ``seq``."""
        if not _seq_split(self.mesh):
            return x[:, 0]
        return collectives.broadcast(x[:, 0], 0, self.mesh.axis_group("seq"))


def _encode(
    encoder: BertEncoder,
    batch: Dict[str, Any],
    generator: Optional[torch.Generator],
    losses: Optional[list] = None,
) -> torch.Tensor:
    return encoder(
        batch["input_ids"],
        token_type_ids=batch.get("token_type_ids"),
        attention_mask=batch.get("attention_mask"),
        generator=generator,
        losses=losses,
    )


class BertClassifier(nn.Module):
    """[CLS]-pooled sequence classification (the fine-tune workload).

    ``model(batch, generator=g)``: ``g`` feeds every dropout site in
    ``train()`` mode (flax ``rngs={"dropout": rng}``); serving runs in
    ``eval()`` mode and needs none.  ``losses``: see the module
    docstring."""

    def __init__(
        self, encoder: BertEncoder, num_classes: int = 2,
        dropout_rate: float = 0.1,
    ):
        super().__init__()
        self.encoder = encoder
        d_model = encoder.embed.embedding_dim
        self.pooler = nn.Linear(d_model, d_model)
        self.head = nn.Linear(d_model, num_classes)
        self.dropout = Dropout(dropout_rate)

    def forward(
        self,
        batch: Dict[str, Any],
        generator: Optional[torch.Generator] = None,
        losses: Optional[list] = None,
    ) -> torch.Tensor:
        x = _encode(self.encoder, batch, generator, losses)
        cls = self.encoder.cls(x)
        pooled = torch.tanh(_dense(cls.float(), self.pooler, torch.float32))
        pooled = self.dropout(pooled, generator)
        return _dense(pooled, self.head, torch.float32)


class BertMLMHead(nn.Module):
    """Masked-LM logits over the vocab (pretraining-style objective);
    vocabulary-parallel on a ``model`` axis (the module docstring)."""

    def __init__(self, encoder: BertEncoder):
        super().__init__()
        self.encoder = encoder
        d_model = encoder.embed.embedding_dim
        self.mlm_dense = nn.Linear(d_model, d_model)
        self.mlm_norm = LayerNorm(d_model, encoder.dtype)
        n, group = _model_split(encoder.mesh, encoder.vocab_size,
                                "vocabulary rows")
        self.mlm_head = nn.Linear(d_model, encoder.vocab_size // n)
        hold_slices(self.mlm_head, {"weight": (0, group), "bias": (0, group)})

    def forward(
        self,
        batch: Dict[str, Any],
        generator: Optional[torch.Generator] = None,
        losses: Optional[list] = None,
    ) -> torch.Tensor:
        x = _encode(self.encoder, batch, generator, losses)
        x = F.gelu(_dense(x, self.mlm_dense, x.dtype), approximate="tanh")
        x = self.mlm_norm(x)
        group = slice_group(self.mlm_head, "weight")
        logits = _dense(collectives.enter_partial(x, group), self.mlm_head,
                        torch.float32)
        return collectives.leave_split(logits, -1, group)


DEFAULT_HPARAMS = {
    # bert-base-uncased geometry, vocab padded 30522 -> 30528 (a multiple of
    # 64), identical to the reference's defaults.
    "vocab_size": 30528,
    "d_model": 768,
    "n_layers": 12,
    "n_heads": 12,
    "d_ff": 3072,
    "max_len": 512,
    "type_vocab_size": 2,
    "dropout_rate": 0.1,
    "num_classes": 2,
    "attn_impl": "auto",
    "moe_experts": 0,
    "learning_rate": 3e-5,
    "batch_size": 64,
    "head": "classifier",     # or "mlm"
}


def build_bert_model(hparams: Optional[Dict] = None, mesh: Any = None) -> nn.Module:
    """The reference's ``build_bert_model``; ``mesh`` (a ``DeviceMesh``)
    goes to every block: ring/Ulysses attention on its ``seq`` axis, the
    experts on its ``expert`` axis, the heads, MLP columns and vocabulary
    rows on its ``model`` axis."""
    hp = {**DEFAULT_HPARAMS, **(hparams or {})}
    encoder = BertEncoder(
        vocab_size=int(hp["vocab_size"]),
        d_model=int(hp["d_model"]),
        n_layers=int(hp["n_layers"]),
        n_heads=int(hp["n_heads"]),
        d_ff=int(hp["d_ff"]),
        max_len=int(hp["max_len"]),
        type_vocab_size=int(hp["type_vocab_size"]),
        dropout_rate=float(hp["dropout_rate"]),
        attn_impl=str(hp["attn_impl"]),
        moe_experts=int(hp.get("moe_experts", 0)),
        mesh=mesh,
    )
    if hp["head"] == "mlm":
        return BertMLMHead(encoder)
    return BertClassifier(
        encoder,
        num_classes=int(hp["num_classes"]),
        dropout_rate=float(hp["dropout_rate"]),
    )


@torch.no_grad()
def init_bert_weights(
    model: nn.Module, generator: torch.Generator, std: float = 0.02
) -> nn.Module:
    """BERT's initialisation, drawn from ``generator``: normal(0, ``std``)
    for every Linear and Embedding weight, zero biases, unit LayerNorm;
    an MoE layer's experts keep the reference's fan-in init, drawn from
    ``generator`` too (every expert rank draws all E and keeps its own; a
    tensor-parallel weight is drawn whole and sliced the same way)."""
    for module in model.modules():
        if isinstance(module, MoEMlpBlock):
            module.reset_parameters(generator)
        elif isinstance(module, (nn.Linear, nn.Embedding)):
            draw_whole(module, "weight",
                       lambda w: w.normal_(0.0, std, generator=generator))
            if getattr(module, "bias", None) is not None:
                module.bias.zero_()
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    return model
