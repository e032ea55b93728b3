"""BERT encoder and heads, the port of ``tpu_pipelines/models/bert.py``.

Post-LN, as the original BERT.  The three embeddings are gathered, cast to
the compute dtype and summed in it; the pooler and the classifier head run
in f32 on the [CLS] position.  Weights come from a flax tree through
``models/convert.py`` or from :func:`init_bert_weights`.  Tensor-parallel
partition rules wait for the parallel slice, and mixture-of-experts layers
for the MoE port.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpu_pipelines_torch.models.transformer import (
    LayerNorm,
    TransformerBlock,
    _dense,
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
    ):
        super().__init__()
        if moe_experts:
            raise NotImplementedError(
                "moe_experts > 0: the mixture-of-experts MLP waits for the "
                "parallel slice of the port"
            )
        self.vocab_size = vocab_size
        self.dtype = dtype
        self.embed = nn.Embedding(vocab_size, d_model)
        self.pos_embed = nn.Embedding(max_len, d_model)
        self.type_embed = nn.Embedding(type_vocab_size, d_model)
        self.embed_norm = LayerNorm(d_model, dtype)
        self.dropout = nn.Dropout(dropout_rate)
        self.layers = nn.ModuleList(
            TransformerBlock(
                d_model, n_heads, d_model // n_heads, d_ff,
                dropout_rate=dropout_rate, dtype=dtype, attn_impl=attn_impl,
                causal=False, prenorm=False,
            )
            for _ in range(n_layers)
        )

    def forward(
        self,
        input_ids: torch.Tensor,
        *,
        token_type_ids: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        ids = input_ids.long()
        l = ids.shape[1]
        x = self.embed(ids).to(self.dtype)
        pos = torch.arange(l, device=ids.device)
        x = x + self.pos_embed(pos)[None].to(self.dtype)
        types = (torch.zeros_like(ids) if token_type_ids is None
                 else token_type_ids.long())
        x = x + self.type_embed(types).to(self.dtype)
        x = self.dropout(self.embed_norm(x))
        for layer in self.layers:
            x = layer(x, attention_mask)
        return x


def _encode(encoder: BertEncoder, batch: Dict[str, Any]) -> torch.Tensor:
    return encoder(
        batch["input_ids"],
        token_type_ids=batch.get("token_type_ids"),
        attention_mask=batch.get("attention_mask"),
    )


class BertClassifier(nn.Module):
    """[CLS]-pooled sequence classification (the fine-tune workload)."""

    def __init__(
        self, encoder: BertEncoder, num_classes: int = 2,
        dropout_rate: float = 0.1,
    ):
        super().__init__()
        self.encoder = encoder
        d_model = encoder.embed.embedding_dim
        self.pooler = nn.Linear(d_model, d_model)
        self.head = nn.Linear(d_model, num_classes)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, batch: Dict[str, Any]) -> torch.Tensor:
        x = _encode(self.encoder, batch)
        pooled = torch.tanh(_dense(x[:, 0].float(), self.pooler, torch.float32))
        pooled = self.dropout(pooled)
        return _dense(pooled, self.head, torch.float32)


class BertMLMHead(nn.Module):
    """Masked-LM logits over the vocab (pretraining-style objective)."""

    def __init__(self, encoder: BertEncoder):
        super().__init__()
        self.encoder = encoder
        d_model = encoder.embed.embedding_dim
        self.mlm_dense = nn.Linear(d_model, d_model)
        self.mlm_norm = LayerNorm(d_model, encoder.dtype)
        self.mlm_head = nn.Linear(d_model, encoder.vocab_size)

    def forward(self, batch: Dict[str, Any]) -> torch.Tensor:
        x = _encode(self.encoder, batch)
        x = F.gelu(_dense(x, self.mlm_dense, x.dtype), approximate="tanh")
        x = self.mlm_norm(x)
        return _dense(x, self.mlm_head, torch.float32)


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


def build_bert_model(hparams: Optional[Dict] = None) -> nn.Module:
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
    for every Linear and Embedding weight, zero biases, unit LayerNorm."""
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Embedding)):
            module.weight.normal_(0.0, std, generator=generator)
            if getattr(module, "bias", None) is not None:
                module.bias.zero_()
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    return model
