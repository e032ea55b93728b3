"""ResNet for image classification (BASELINE configs[2]: ResNet-50 ImageNet).

The port of ``tpu_pipelines/models/resnet.py``: v1.5 bottleneck ordering
(stride on the 3x3), f32 parameters and BatchNorm statistics, bf16 compute
(``dtype``) with an f32 head over the spatial mean of the bf16
activations.  Images arrive NHWC; ``ResNet.forward`` views them as NCHW,
which is ``channels_last`` in memory, the layout cuDNN's bf16 convolutions
want, and keeps that layout through the network.

Where torch's defaults differ from flax's, the port follows flax:

  - **"SAME" padding** pads ``total = max((ceil(n/s) - 1) * s + k - n, 0)``
    with ``total // 2`` before and the rest after, so a stride-2 layer may
    pad one more on the bottom and right (the 7x7/2 stem on 224 pads 2
    and 3; a 3x3/2 conv on an even size 0 and 1).  ``Conv`` pads through
    ``F.pad`` when the pads are uneven, and the stem's max-pool pads with
    -inf the same way, so the output grid is flax's;
  - **BatchNorm** (``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)``):
    in ``train()`` mode it normalizes with the batch's f32 mean and
    biased variance, ``E[x^2] - E[x]^2`` clipped at 0, and moves the
    running buffers ``0.9 * running + 0.1 * batch`` in place (``mul_`` /
    ``add_``: a captured CUDA graph keeps writing the tensors it
    recorded, so a buffer must never be rebound); ``eval()`` reads the
    running buffers.  The normalization is f32 and rounds to ``dtype``
    once;
  - **init** (``init_resnet_weights``): LeCun-normal conv and dense
    kernels (truncated normal, std sqrt(1/fan_in) / 0.8796), zero biases,
    BatchNorm scale 1 but 0 for the last BatchNorm of each block, running
    mean 0 and variance 1.

Parameter names follow the flax tree (``models/convert.py``'s
``resnet_state_dict_from_flax``): ``conv_init``, ``bn_init``, then
``blocks.stage{i}_block{j}`` with ``conv0..2`` / ``bn0..2`` (flax's
``Conv_k`` / ``BatchNorm_k``) and ``proj`` / ``proj_bn``, then ``head``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# depth -> per-stage block counts
STAGE_SIZES = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}
BN_MOMENTUM = 0.9
BN_EPSILON = 1e-5
_LECUN_TRUNC = 0.87962566103423978  # std of a unit normal truncated at +-2


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """``(before, after)`` padding of one spatial axis under flax/XLA
    "SAME"."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _same(x: torch.Tensor, kernel: int, stride: int):
    """``x``'s "SAME" pads as ``(top, bottom, left, right)``."""
    return (*same_pads(x.shape[2], kernel, stride),
            *same_pads(x.shape[3], kernel, stride))


class Conv(nn.Module):
    """``flax.linen.Conv(use_bias=False, padding="SAME", dtype=dtype)``:
    an f32 kernel ``[out, in, k, k]``, input and kernel cast to ``dtype``."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int = 1, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.weight = nn.Parameter(
            torch.empty(features, in_features, kernel, kernel))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        top, bottom, left, right = _same(x, self.kernel, self.stride)
        w = self.weight.to(self.dtype)
        x = x.to(self.dtype)
        if top == bottom and left == right:
            return F.conv2d(x, w, stride=self.stride, padding=(top, left))
        return F.conv2d(F.pad(x, (left, right, top, bottom)), w,
                        stride=self.stride)


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm`` over the channel axis of an NCHW tensor
    (see the module docstring); output in ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16,
                 zero_scale: bool = False):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            (torch.zeros if zero_scale else torch.ones)(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            mean = xf.mean((0, 2, 3))
            var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_(
                    mean, alpha=1.0 - BN_MOMENTUM)
                self.running_var.mul_(BN_MOMENTUM).add_(
                    var, alpha=1.0 - BN_MOMENTUM)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPSILON) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(self.dtype)


class BottleneckBlock(nn.Module):
    def __init__(self, in_features: int, filters: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        out = filters * 4
        self.conv0 = Conv(in_features, filters, 1, dtype=dtype)
        self.bn0 = BatchNorm(filters, dtype)
        self.conv1 = Conv(filters, filters, 3, stride, dtype)
        self.bn1 = BatchNorm(filters, dtype)
        self.conv2 = Conv(filters, out, 1, dtype=dtype)
        self.bn2 = BatchNorm(out, dtype, zero_scale=True)
        self.proj = self.proj_bn = None
        if stride != 1 or in_features != out:
            self.proj = Conv(in_features, out, 1, stride, dtype)
            self.proj_bn = BatchNorm(out, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn0(self.conv0(x)))
        y = F.relu(self.bn1(self.conv1(y)))
        y = self.bn2(self.conv2(y))
        residual = x if self.proj is None else self.proj_bn(self.proj(x))
        return F.relu(residual + y)


class BasicBlock(nn.Module):
    def __init__(self, in_features: int, filters: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        self.conv0 = Conv(in_features, filters, 3, stride, dtype)
        self.bn0 = BatchNorm(filters, dtype)
        self.conv1 = Conv(filters, filters, 3, dtype=dtype)
        self.bn1 = BatchNorm(filters, dtype, zero_scale=True)
        self.proj = self.proj_bn = None
        if stride != 1 or in_features != filters:
            self.proj = Conv(in_features, filters, 1, stride, dtype)
            self.proj_bn = BatchNorm(filters, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn0(self.conv0(x)))
        y = self.bn1(self.conv1(y))
        residual = x if self.proj is None else self.proj_bn(self.proj(x))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """NHWC images ``[batch, H, W, 3]`` in, ``[batch, num_classes]`` f32
    logits out.  ``train()`` mode normalizes with batch statistics and
    moves the running buffers; ``eval()`` uses the running averages."""

    def __init__(self, num_classes: int = 1000, depth: int = 50,
                 width: int = 64, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        block_cls = BottleneckBlock if depth >= 50 else BasicBlock
        expansion = 4 if depth >= 50 else 1
        self.conv_init = Conv(3, width, 7, 2, dtype)
        self.bn_init = BatchNorm(width, dtype)
        blocks = OrderedDict()
        features = width
        for i, n_blocks in enumerate(STAGE_SIZES[depth]):
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                blocks[f"stage{i}_block{j}"] = block_cls(
                    features, width * 2 ** i, stride, dtype)
                features = width * 2 ** i * expansion
        self.blocks = nn.Sequential(blocks)
        self.head = nn.Linear(features, num_classes)
        init_resnet_weights(self)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(self.dtype).permute(0, 3, 1, 2)  # channels_last NCHW
        x = F.relu(self.bn_init(self.conv_init(x)))
        top, bottom, left, right = _same(x, 3, 2)
        x = F.max_pool2d(F.pad(x, (left, right, top, bottom),
                               value=float("-inf")), 3, 2)
        x = self.blocks(x)
        return self.head(x.mean((2, 3)).float())


def init_resnet_weights(model: nn.Module,
                        generator: Optional[torch.Generator] = None) -> nn.Module:
    """Flax's initialisers (see the module docstring), drawn from
    ``generator``; BatchNorm keeps the values its constructor set."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (Conv, nn.Linear)):
                fan_in = module.weight[0].numel()
                std = (1.0 / fan_in) ** 0.5 / _LECUN_TRUNC
                nn.init.trunc_normal_(module.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
            if isinstance(module, nn.Linear):
                module.bias.zero_()
    return model


DEFAULT_HPARAMS = {
    "num_classes": 1000,
    "depth": 50,
    "width": 64,
    "learning_rate": 0.1,
    "batch_size": 1024,
}


def build_resnet_model(hparams: Dict) -> ResNet:
    hp = {**DEFAULT_HPARAMS, **(hparams or {})}
    return ResNet(
        num_classes=int(hp["num_classes"]),
        depth=int(hp["depth"]),
        width=int(hp["width"]),
    )
