"""Wide-and-deep model for the Chicago-Taxi workload.

The port of ``tpu_pipelines/models/taxi.py``: embeddings plus an MLP for the
deep path, a linear head over the one-hot / multi-hot wide features, summed
into one logit per example.  Parameter layout (and so
``models/convert.py``'s ``taxi_state_dict_from_flax``): the numeric features
stacked in order; then one ``nn.Embedding`` per categorical feature, in
sorted name order (``embed_<name>``); then ``hidden_dims`` Linear+ReLU
layers (``dense_<i>``); then ``deep_head``; plus ``wide_head`` over the
flattened wide features.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn


class WideAndDeep(nn.Module):
    """Dict-of-features in, (batch,) f32 logit out."""

    def __init__(
        self,
        numeric_features: Sequence[str],
        categorical_features: Dict[str, Tuple[int, int]],
        wide_features: Sequence[str] = (),
        hidden_dims: Sequence[int] = (64, 32),
        wide_dim: int = 0,
    ):
        super().__init__()
        self.numeric_features = tuple(numeric_features)
        self.categorical = tuple(sorted(categorical_features.items()))
        self.wide_features = tuple(wide_features)
        self.embeds = nn.ModuleDict({
            f"embed_{name}": nn.Embedding(card, dim)
            for name, (card, dim) in self.categorical
        })
        width = len(self.numeric_features) + sum(
            dim for _, (_, dim) in self.categorical
        )
        layers = {}
        for i, h in enumerate(hidden_dims):
            layers[f"dense_{i}"] = nn.Linear(width, h)
            width = h
        self.dense = nn.ModuleDict(layers)
        self.deep_head = nn.Linear(width, 1)
        # Flax sizes the wide head at first call; here the width is the
        # hyperparameter ``wide_dim`` (the taxi module passes it).
        self.wide_head = nn.Linear(wide_dim, 1) if self.wide_features else None

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        deep = [torch.stack(
            [batch[f].to(torch.float32) for f in self.numeric_features], -1
        )]
        for name, _ in self.categorical:
            ids = batch[name].to(torch.int64)
            deep.append(self.embeds[f"embed_{name}"](ids))
        x = torch.cat(deep, -1)
        for layer in self.dense.values():
            x = torch.relu(layer(x))
        logit = self.deep_head(x)[..., 0]
        if self.wide_head is not None:
            wide = torch.cat([
                batch[f].to(torch.float32).reshape(logit.shape[0], -1)
                for f in self.wide_features
            ], -1)
            logit = logit + self.wide_head(wide)[..., 0]
        return logit


DEFAULT_HPARAMS = {
    "numeric_features": ["miles_z", "fare_01", "log_fare_z", "tip_ratio"],
    "categorical_features": {
        "company_id": [8, 4],
        "hour_bucket": [8, 2],
    },
    "wide_features": ["payment_onehot", "is_cash"],
    # Flattened width of the wide features: payment_onehot (2) + is_cash (1).
    "wide_dim": 3,
    "hidden_dims": [64, 32],
    "label": "label_big_tip",
    "learning_rate": 1e-3,
    "batch_size": 64,
}


def build_taxi_model(hparams: Dict) -> WideAndDeep:
    hp = {**DEFAULT_HPARAMS, **(hparams or {})}
    return WideAndDeep(
        numeric_features=tuple(hp["numeric_features"]),
        categorical_features={
            k: tuple(v) for k, v in hp["categorical_features"].items()
        },
        wide_features=tuple(hp["wide_features"]),
        hidden_dims=tuple(hp["hidden_dims"]),
        wide_dim=int(hp["wide_dim"]),
    )


def init_taxi_weights(model: WideAndDeep, generator: torch.Generator) -> WideAndDeep:
    """Flax's initialisers, drawn from ``generator``: Dense kernels
    LeCun-normal (truncated normal, std sqrt(1/fan_in) / 0.8796), biases
    zero; Embed tables normal with std 1 / sqrt(features)."""
    with torch.no_grad():
        for name, module in model.named_modules():
            if isinstance(module, nn.Linear):
                fan_in = module.weight.shape[1]
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(module.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
                module.bias.zero_()
            elif isinstance(module, nn.Embedding):
                dim = module.weight.shape[1]
                nn.init.normal_(module.weight, std=dim ** -0.5,
                                generator=generator)
    return model
