"""Weight carrier: a flax params tree as the port's ``state_dict``.

``bert_state_dict_from_flax``, ``t5_state_dict_from_flax`` and
``taxi_state_dict_from_flax`` map the
nested dict of numpy arrays that ``tpu_pipelines.models.bert`` / ``.t5``
train (``model.init(...)["params"]``) onto the modules of
``tpu_pipelines_torch.models.bert`` / ``.t5``.  Values are copied bit for
bit (bfloat16 leaves included); only layouts change:

  - ``Dense`` kernel ``[in, out]`` -> ``Linear.weight`` ``[out, in]``;
  - ``DenseGeneral`` q/k/v kernel ``[d_model, H, Dh]`` and bias ``[H, Dh]``
    -> ``Linear(d_model, H*Dh)``; out kernel ``[H, Dh, d_model]`` ->
    ``Linear(H*Dh, d_model)``;
  - ``LayerNorm`` scale/bias -> weight/bias; ``RMSNorm`` scale -> weight;
    ``Embed`` embedding -> weight; T5's ``rel_embedding`` keeps its name.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _tensor(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: reinterpret the bits
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(
            torch.bfloat16
        )
    return torch.from_numpy(np.array(a, copy=True))


def _linear(node: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {
        "weight": _tensor(node["kernel"]).t().contiguous(),
        "bias": _tensor(node["bias"]),
    }


def _linear_in_heads(node: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    kernel = _tensor(node["kernel"])          # [d_model, H, Dh]
    return {
        "weight": kernel.reshape(kernel.shape[0], -1).t().contiguous(),
        "bias": _tensor(node["bias"]).reshape(-1),
    }


def _linear_out_heads(node: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    kernel = _tensor(node["kernel"])          # [H, Dh, d_model]
    return {
        "weight": kernel.reshape(-1, kernel.shape[-1]).t().contiguous(),
        "bias": _tensor(node["bias"]),
    }


def _norm(node: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {"weight": _tensor(node["scale"]), "bias": _tensor(node["bias"])}


def _embed(node: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {"weight": _tensor(node["embedding"])}


def bert_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``state_dict`` for ``BertClassifier`` or ``BertMLMHead`` from the
    flax params tree of the same geometry."""
    out: Dict[str, torch.Tensor] = {}

    def put(prefix: str, tensors: Dict[str, torch.Tensor]) -> None:
        for name, t in tensors.items():
            out[f"{prefix}.{name}"] = t

    enc = params["encoder"]
    for name in ("embed", "pos_embed", "type_embed"):
        put(f"encoder.{name}", _embed(enc[name]))
    put("encoder.embed_norm", _norm(enc["embed_norm"]))
    n_layers = sum(1 for key in enc if key.startswith("layer_"))
    for i in range(n_layers):
        layer = enc[f"layer_{i}"]
        prefix = f"encoder.layers.{i}"
        for proj in ("query", "key", "value"):
            put(f"{prefix}.attn.{proj}", _linear_in_heads(layer["attn"][proj]))
        put(f"{prefix}.attn.out", _linear_out_heads(layer["attn"]["out"]))
        put(f"{prefix}.attn_norm", _norm(layer["attn_norm"]))
        put(f"{prefix}.mlp.wi", _linear(layer["mlp"]["wi"]))
        put(f"{prefix}.mlp.wo", _linear(layer["mlp"]["wo"]))
        put(f"{prefix}.mlp_norm", _norm(layer["mlp_norm"]))
    for name in ("pooler", "head", "mlm_dense", "mlm_head"):
        if name in params:
            put(name, _linear(params[name]))
    if "mlm_norm" in params:
        put("mlm_norm", _norm(params["mlm_norm"]))
    return out


def _rms(node: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {"weight": _tensor(node["scale"])}


def t5_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``state_dict`` for ``tpu_pipelines_torch.models.t5.T5`` from the flax
    params tree of the same geometry: ``shared``, each stack's
    ``rel_pos/rel_embedding``, its layers' self-attention, the decoder's
    cross-attention, the MLP, the ``*_norm/scale`` RMSNorm scales and
    ``final_norm``."""
    out: Dict[str, torch.Tensor] = {}

    def put(prefix: str, tensors: Dict[str, torch.Tensor]) -> None:
        for name, t in tensors.items():
            out[f"{prefix}.{name}"] = t

    put("shared", _embed(params["shared"]))
    for stack in ("encoder", "decoder"):
        tree = params[stack]
        out[f"{stack}.rel_pos.rel_embedding"] = _tensor(
            tree["rel_pos"]["rel_embedding"]
        )
        n_layers = sum(1 for key in tree if key.startswith("layer_"))
        for i in range(n_layers):
            layer = tree[f"layer_{i}"]
            prefix = f"{stack}.layers.{i}"
            for attn in ("attn", "cross"):
                if attn not in layer:
                    continue
                for proj in ("query", "key", "value"):
                    put(f"{prefix}.{attn}.{proj}",
                        _linear_in_heads(layer[attn][proj]))
                put(f"{prefix}.{attn}.out", _linear_out_heads(layer[attn]["out"]))
                put(f"{prefix}.{attn}_norm", _rms(layer[f"{attn}_norm"]))
            put(f"{prefix}.mlp.wi", _linear(layer["mlp"]["wi"]))
            put(f"{prefix}.mlp.wo", _linear(layer["mlp"]["wo"]))
            put(f"{prefix}.mlp_norm", _rms(layer["mlp_norm"]))
        put(f"{stack}.final_norm", _rms(tree["final_norm"]))
    return out


def taxi_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``tpu_pipelines.models.taxi`` ``WideAndDeep`` params ->
    ``tpu_pipelines_torch.models.taxi`` state dict: ``embed_<name>`` tables
    as they are, ``dense_<i>``, ``deep_head`` and ``wide_head`` kernels
    transposed."""
    out: Dict[str, torch.Tensor] = {}
    for key, node in params.items():
        if key.startswith("embed_"):
            prefix = f"embeds.{key}"
            tensors = _embed(node)
        elif key.startswith("dense_"):
            prefix, tensors = f"dense.{key}", _linear(node)
        elif key in ("deep_head", "wide_head"):
            prefix, tensors = key, _linear(node)
        else:
            raise KeyError(f"unexpected taxi param {key!r}")
        for name, t in tensors.items():
            out[f"{prefix}.{name}"] = t
    return out
