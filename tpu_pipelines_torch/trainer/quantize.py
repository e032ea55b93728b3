"""Serving-dtype helpers and int8 weight quantization for state dicts.

The port of ``tpu_pipelines/trainer/quantize.py`` on ``{name: tensor}``
mappings: ``infer_dtype``, ``cast_params``, ``params_nbytes``, and the
Rewriter's int8 half, ``quantize_params``, ``dequantize_params`` and
``tree_is_quantized``.

A quantized weight ``<name>`` is stored as two entries of the state dict,
``<name>.qvalue`` (int8, the weight's own torch layout) and
``<name>.scale`` (float32), with the numerics of the quantizer the
reference runs (aqt's ``quantizer_make(8)``: an f32 scale ``max|w| / 127.5``
(1/127.5 for an all-zero channel), ``q = round_half_even(clip(w · (1 /
scale), ±127))``; the reference's own fallback, ``max|w| / 127``, is not
what it runs when aqt is installed, and gives other q-values).  The
reference's scales run along flax's FIRST axis (it
reduces over every other axis), so a flax ``Dense`` kernel ``[in, out]``
gets one scale per input feature.  The port reduces over the same
elements: :func:`channel_layouts` gives, for each weight of a torch model,
the layout ``models/convert.py`` maps flax's first axis to:

  - ``nn.Linear`` ``[out, in]``: axis 1 (scale ``[1, in]``);
  - an attention block's output projection (flax ``[H, Dh, d_model]``,
    torch ``[d_model, H*Dh]``): the head, ``("heads", H)`` (scale
    ``[1, H, 1]`` against the weight viewed ``[d_model, H, Dh]``);
  - an embedding table ``[V, D]`` and any other tensor the converter
    copies as it is: axis 0;
  - a 4-D convolution weight (flax HWIO, torch OIHW): axis 2, the
    kernel's rows.

Weights with fewer than ``DEFAULT_MIN_QUANT_SIZE`` elements or fewer than
two dimensions stay float, as in the reference.  The serving loader keeps
the int8 tensors resident and dequantizes inside the predict step
(``trainer/export.py``), so on the card the dequantization is part of
every captured bucket graph.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import torch
from torch import nn

DTYPE_FLOAT32 = "float32"
DTYPE_BFLOAT16 = "bfloat16"
DTYPE_AQT_INT8 = "aqt_int8"

QVALUE = ".qvalue"
SCALE = ".scale"

# Leaves smaller than this many elements stay float.
DEFAULT_MIN_QUANT_SIZE = 4096


def quantized_names(params: Mapping[str, Any]) -> List[str]:
    """The weight names stored as ``.qvalue`` / ``.scale`` pairs."""
    return sorted(k[: -len(QVALUE)] for k in params if k.endswith(QVALUE))


def tree_is_quantized(params: Mapping[str, Any]) -> bool:
    return any(k.endswith(QVALUE) for k in params)


def channel_layouts(model: nn.Module) -> Dict[str, Tuple[str, int]]:
    """``{parameter name: layout}`` for every parameter of ``model`` with
    two or more dimensions: ``("axis", d)`` or ``("heads", H)`` (see the
    module docstring)."""
    layouts: Dict[str, Tuple[str, int]] = {}
    for name, p in model.named_parameters():
        if p.dim() >= 2:
            layouts[name] = ("axis", 2 if p.dim() == 4 else 0)
    modules = list(model.named_modules())
    for prefix, module in modules:
        if isinstance(module, nn.Linear):
            layouts[f"{prefix}.weight" if prefix else "weight"] = ("axis", 1)
    for prefix, module in modules:  # after the Linear rule, which it overrides
        out = getattr(module, "out", None)
        if isinstance(out, nn.Linear) and hasattr(module, "n_heads"):
            dot = f"{prefix}." if prefix else ""
            layouts[f"{dot}out.weight"] = ("heads", int(module.n_heads))
    return layouts


def _view(shape: torch.Size, layout: Tuple[str, int]) -> Tuple[Tuple[int, ...], int]:
    """(the shape the weight is viewed as, its channel axis in it)."""
    kind, n = layout
    if kind == "heads":
        return (shape[0], n, shape[1] // n), 1
    return tuple(shape), n


def _quantize(w: torch.Tensor, layout: Tuple[str, int]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    view, axis = _view(w.shape, layout)
    x = w.detach().float().reshape(view)
    dims = tuple(d for d in range(len(view)) if d != axis)
    amax = x.abs().amax(dim=dims, keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax) / 127.5
    q = torch.round(torch.clamp(x * (1.0 / scale), -127, 127)).to(torch.int8)
    return q.reshape(w.shape), scale


def compact_scale(full: torch.Tensor, layout: Tuple[str, int]) -> torch.Tensor:
    """A scale tensor broadcast to the weight's shape, reduced to the
    layout's one value a channel."""
    view, axis = _view(full.shape, layout)
    dims = tuple(d for d in range(len(view)) if d != axis)
    return full.float().reshape(view).amax(dim=dims, keepdim=True)


def quantize_params(
    params: Mapping[str, torch.Tensor],
    layouts: Mapping[str, Tuple[str, int]],
    min_size: int = DEFAULT_MIN_QUANT_SIZE,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Quantize the eligible floating weights of ``params`` (float, two
    or more dimensions, at least ``min_size`` elements) along
    ``layouts`` (:func:`channel_layouts` of the model).  Returns ``(state
    dict, report)``; the report has the reference's fields, with the
    port's parameter names and shapes."""
    out: Dict[str, torch.Tensor] = {}
    quantized: List[Dict[str, Any]] = []
    for name, t in params.items():
        if not (t.is_floating_point() and t.dim() >= 2
                and t.numel() >= int(min_size)):
            out[name] = t
            continue
        if name not in layouts:
            raise KeyError(
                f"quantize_params: no channel layout for {name!r}; pass "
                "channel_layouts(model) of the model the state dict is of")
        q, scale = _quantize(t, layouts[name])
        out[name + QVALUE] = q
        out[name + SCALE] = scale
        quantized.append({
            "path": name,
            "shape": [int(d) for d in t.shape],
            "bytes_float": t.numel() * t.element_size(),
            "bytes_int8": q.numel() + scale.numel() * 4,
        })
    report = {
        "quantized_leaves": quantized,
        "num_quantized": len(quantized),
        "min_quant_size": int(min_size),
    }
    return out, report


def dequantize_params(params: Mapping[str, torch.Tensor],
                      dtype: torch.dtype = torch.float32
                      ) -> Dict[str, torch.Tensor]:
    """Every ``.qvalue`` / ``.scale`` pair replaced by the dense ``q * s``
    weight in ``dtype`` (other entries passed through).  Plain torch ops,
    so inside a captured step the dequantization is part of the graph."""
    out: Dict[str, torch.Tensor] = {}
    for name, t in params.items():
        if name.endswith(SCALE) and name[: -len(SCALE)] + QVALUE in params:
            continue
        if not name.endswith(QVALUE):
            out[name] = t
            continue
        base = name[: -len(QVALUE)]
        scale = params[base + SCALE]
        if scale.dim() == t.dim():
            dense = t.to(dtype) * scale.to(dtype)
        else:  # grouped by heads: the weight viewed [out, H, Dh]
            view = t.view(*t.shape[:-1], scale.shape[-2], -1)
            dense = (view.to(dtype) * scale.to(dtype)).view(t.shape)
        out[base] = dense
    return out


def cast_params(
    params: Mapping[str, torch.Tensor], dtype: torch.dtype
) -> Dict[str, torch.Tensor]:
    """Every floating tensor cast to ``dtype``; others, and the scales of
    quantized weights, untouched."""
    return {
        name: t.to(dtype) if t.is_floating_point() and not (
            name.endswith(SCALE)
            and name[: -len(SCALE)] + QVALUE in params) else t
        for name, t in params.items()
    }


def params_nbytes(params: Mapping[str, torch.Tensor]) -> int:
    """Resident bytes of the tensors (a quantized weight counts its int8
    values and its scales)."""
    return sum(t.numel() * t.element_size() for t in params.values())


def infer_dtype(params: Mapping[str, torch.Tensor]) -> str:
    """Serving-dtype string: "aqt_int8" when any weight is quantized,
    "bfloat16" when every floating tensor is bf16, "float32" when any is
    f32/f64 or none is floating, else the first floating dtype name in
    sorted order."""
    if tree_is_quantized(params):
        return DTYPE_AQT_INT8
    names = {
        str(t.dtype).replace("torch.", "")
        for t in params.values() if t.is_floating_point()
    }
    if names == {"bfloat16"}:
        return DTYPE_BFLOAT16
    if not names or "float32" in names or "float64" in names:
        return DTYPE_FLOAT32
    return sorted(names)[0]

