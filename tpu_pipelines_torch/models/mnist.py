"""MNIST CNN (BASELINE configs[1]: "MNIST Keras CNN via TFX Trainer").

The port of ``tpu_pipelines/models/mnist.py``: two conv blocks (3x3
"SAME" conv with bias, ReLU, 2x2 VALID max-pool) and an MLP head, all f32.
Images arrive NHWC (``[batch, 28, 28]`` or ``[batch, 28, 28, 1]``).  The
flatten before ``dense_0`` is in flax's (H, W, C) order, so a flax
``dense_0`` kernel carries over transposed and nothing else
(``models/convert.py``'s ``mnist_state_dict_from_flax``).  Dropout is
active in ``train()`` mode and draws its mask from the caller's generator
(``model(images, generator=g)``, as ``models/transformer.py``'s
``Dropout``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpu_pipelines_torch.models.transformer import Dropout

_LECUN_TRUNC = 0.87962566103423978  # std of a unit normal truncated at +-2


class MnistCNN(nn.Module):
    """``[batch, 28, 28(, 1)]`` images in, ``[batch, num_classes]`` logits
    out."""

    def __init__(self, num_classes: int = 10,
                 conv_features: Sequence[int] = (32, 64),
                 hidden_dim: int = 128, dropout_rate: float = 0.25):
        super().__init__()
        self.convs = nn.ModuleDict()
        channels, size = 1, 28
        for i, features in enumerate(conv_features):
            self.convs[f"conv_{i}"] = nn.Conv2d(channels, features, 3, padding=1)
            channels, size = features, size // 2
        self.dense_0 = nn.Linear(size * size * channels, hidden_dim)
        self.dropout = Dropout(dropout_rate)
        self.head = nn.Linear(hidden_dim, num_classes)
        init_mnist_weights(self)

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = images.float()
        if x.ndim == 3:
            x = x[..., None]
        x = x.permute(0, 3, 1, 2)
        for conv in self.convs.values():
            x = F.max_pool2d(F.relu(conv(x)), 2)
        x = x.permute(0, 2, 3, 1).flatten(1)  # flax's (H, W, C) order
        x = self.dropout(F.relu(self.dense_0(x)), generator)
        return self.head(x)


def init_mnist_weights(model: nn.Module,
                       generator: Optional[torch.Generator] = None) -> nn.Module:
    """Flax's initialisers drawn from ``generator``: LeCun-normal conv and
    dense kernels (truncated normal, std sqrt(1/fan_in) / 0.8796), zero
    biases."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                fan_in = module.weight[0].numel()
                std = (1.0 / fan_in) ** 0.5 / _LECUN_TRUNC
                nn.init.trunc_normal_(module.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
                module.bias.zero_()
    return model


DEFAULT_HPARAMS = {
    "num_classes": 10,
    "conv_features": [32, 64],
    "hidden_dim": 128,
    "dropout_rate": 0.25,
    "learning_rate": 1e-3,
    "batch_size": 256,
}


def build_mnist_model(hparams: Dict) -> MnistCNN:
    hp = {**DEFAULT_HPARAMS, **(hparams or {})}
    return MnistCNN(
        num_classes=int(hp["num_classes"]),
        conv_features=tuple(hp["conv_features"]),
        hidden_dim=int(hp["hidden_dim"]),
        dropout_rate=float(hp["dropout_rate"]),
    )
