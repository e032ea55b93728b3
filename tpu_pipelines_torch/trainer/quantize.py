"""Serving-dtype helpers for parameter state dicts.

The port of ``infer_dtype``, ``cast_params`` and ``params_nbytes`` from
``tpu_pipelines/trainer/quantize.py``, on ``{name: tensor}`` mappings.
int8 weight quantization waits for the Rewriter slice.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

DTYPE_FLOAT32 = "float32"
DTYPE_BFLOAT16 = "bfloat16"
DTYPE_AQT_INT8 = "aqt_int8"


def cast_params(
    params: Mapping[str, torch.Tensor], dtype: torch.dtype
) -> Dict[str, torch.Tensor]:
    """Every floating tensor cast to ``dtype``; others untouched."""
    return {
        name: t.to(dtype) if t.is_floating_point() else t
        for name, t in params.items()
    }


def params_nbytes(params: Mapping[str, torch.Tensor]) -> int:
    """Resident bytes of the tensors."""
    return sum(t.numel() * t.element_size() for t in params.values())


def infer_dtype(params: Mapping[str, torch.Tensor]) -> str:
    """Serving-dtype string: "bfloat16" when every floating tensor is
    bf16, "float32" when any is f32/f64 or none is floating, else the
    first floating dtype name in sorted order."""
    names = {
        str(t.dtype).replace("torch.", "")
        for t in params.values() if t.is_floating_point()
    }
    if names == {"bfloat16"}:
        return DTYPE_BFLOAT16
    if not names or "float32" in names or "float64" in names:
        return DTYPE_FLOAT32
    return sorted(names)[0]
