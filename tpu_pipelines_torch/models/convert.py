"""Weight carrier: a flax params tree as the port's ``state_dict``.

``bert_state_dict_from_flax``, ``t5_state_dict_from_flax``,
``taxi_state_dict_from_flax``, ``mnist_state_dict_from_flax`` and
``resnet_state_dict_from_flax`` map the
nested dict of numpy arrays that ``tpu_pipelines.models.bert`` / ``.t5`` /
``.taxi`` / ``.mnist`` / ``.resnet`` train (``model.init(...)["params"]``;
for ResNet the whole variables dict, ``batch_stats`` included) onto the
modules of the same name in ``tpu_pipelines_torch.models``.  Values are
copied bit for bit (bfloat16 leaves included); only layouts change:

  - ``Dense`` kernel ``[in, out]`` -> ``Linear.weight`` ``[out, in]``;
  - ``DenseGeneral`` q/k/v kernel ``[d_model, H, Dh]`` and bias ``[H, Dh]``
    -> ``Linear(d_model, H*Dh)``; out kernel ``[H, Dh, d_model]`` ->
    ``Linear(H*Dh, d_model)``;
  - ``LayerNorm`` scale/bias -> weight/bias; ``RMSNorm`` scale -> weight;
    ``Embed`` embedding -> weight; T5's ``rel_embedding`` keeps its name;
  - ``Conv`` kernel ``[kh, kw, in, out]`` (HWIO) -> ``weight``
    ``[out, in, kh, kw]`` (OIHW); ``BatchNorm`` scale/bias ->
    weight/bias and its ``batch_stats`` mean/var -> the
    ``running_mean`` / ``running_var`` buffers.

``staged_state_dict_from_flax`` maps ``tpu_pipelines.models.staged``'s
tree (``embed``, the ``stages`` stacked on a leading stage dim, ``head``)
onto ``tpu_pipelines_torch.models.staged``, the stage dim kept in front.
A model built on a mesh loads any of these whole state dicts into the
slices its rank holds (``parallel.partition.hold_slices``).

``int8_state_dict_from_flax`` carries a reference int8 tree (each
quantized leaf a ``{QUANT_Q: int8, QUANT_S: f32 [d0, 1, ...]}`` subtree,
``tpu_pipelines/trainer/quantize.py``) into the port's int8 state dict
(``<name>.qvalue`` / ``<name>.scale``, ``trainer/quantize.py``) through any
of the converters above.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# The reference's markers of a quantized leaf (its payload format).
QUANT_Q = "__aqt_int8_q__"
QUANT_S = "__aqt_int8_s__"


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


def block_state_dict_from_flax(layer: Mapping[str, Any], prefix: str = ""
                               ) -> Dict[str, torch.Tensor]:
    """A layernorm ``TransformerBlock``'s tensors (self-attention, the MLP
    or its MoE, the two norms) under ``prefix``."""
    out: Dict[str, torch.Tensor] = {}
    lead = f"{prefix}." if prefix else ""

    def put(sub: str, tensors: Dict[str, torch.Tensor]) -> None:
        for name, t in tensors.items():
            out[f"{lead}{sub}.{name}"] = t

    for proj in ("query", "key", "value"):
        put(f"attn.{proj}", _linear_in_heads(layer["attn"][proj]))
    put("attn.out", _linear_out_heads(layer["attn"]["out"]))
    put("attn_norm", _norm(layer["attn_norm"]))
    if "moe" in layer:
        moe = layer["moe"]
        put("moe.router", _linear(moe["router"]))
        put("moe", {"wi": _tensor(moe["wi"]), "wo": _tensor(moe["wo"])})
    else:
        put("mlp.wi", _linear(layer["mlp"]["wi"]))
        put("mlp.wo", _linear(layer["mlp"]["wo"]))
    put("mlp_norm", _norm(layer["mlp_norm"]))
    return out


def bert_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``state_dict`` for ``BertClassifier`` or ``BertMLMHead`` from the
    flax params tree of the same geometry.  An MoE layer's
    ``moe/{router,wi,wo}`` keep their names; ``wi`` ``[E, d, ff]`` and
    ``wo`` ``[E, ff, d]`` keep the flax layout, all E experts (a rank on
    an ``expert`` axis loads its slice: ``MoEMlpBlock``)."""
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
        out.update(block_state_dict_from_flax(enc[f"layer_{i}"], f"encoder.layers.{i}"))
    for name in ("pooler", "head", "mlm_dense", "mlm_head"):
        if name in params:
            put(name, _linear(params[name]))
    if "mlm_norm" in params:
        put("mlm_norm", _norm(params["mlm_norm"]))
    return out


def staged_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``state_dict`` for ``StagedClassifier`` from the reference's staged
    tree: ``embed/token`` and ``embed/pos_embedding``, each ``stages``
    leaf ``[S, ...]`` carried stage by stage through the block layouts and
    stacked again on dim 0 (``stages.layers.{j}...``), ``head/final_norm``
    and ``head/classifier``."""
    out: Dict[str, torch.Tensor] = {
        "embed.token.weight": _tensor(params["embed"]["token"]["embedding"]),
        "embed.pos_embedding": _tensor(params["embed"]["pos_embedding"]),
    }
    stages = params["stages"]
    n_stages = int(np.shape(stages["layer_0"]["attn_norm"]["scale"])[0])
    per_stage = []
    for s in range(n_stages):
        one = {}
        for key, layer in stages.items():
            j = int(key.split("_")[1])
            leaf = _map_tree(layer, lambda a: np.asarray(a)[s])
            one.update(block_state_dict_from_flax(leaf, f"stages.layers.{j}"))
        per_stage.append(one)
    for name in per_stage[0]:
        out[name] = torch.stack([one[name] for one in per_stage])
    out.update({f"head.final_norm.{k}": v
                for k, v in _norm(params["head"]["final_norm"]).items()})
    out.update({f"head.classifier.{k}": v
                for k, v in _linear(params["head"]["classifier"]).items()})
    return out


def _map_tree(node: Any, fn: Callable[[Any], Any]) -> Any:
    if isinstance(node, Mapping):
        return {k: _map_tree(v, fn) for k, v in node.items()}
    return fn(node)


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


def _conv(node: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    out = {"weight": _tensor(node["kernel"]).permute(3, 2, 0, 1).contiguous()}
    if "bias" in node:
        out["bias"] = _tensor(node["bias"])
    return out


def mnist_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``tpu_pipelines.models.mnist`` ``MnistCNN`` params ->
    ``tpu_pipelines_torch.models.mnist`` state dict: ``conv_<i>`` kernels
    to OIHW, ``dense_0`` and ``head`` transposed (the port flattens in
    flax's (H, W, C) order, so ``dense_0``'s rows keep theirs)."""
    out: Dict[str, torch.Tensor] = {}
    for key, node in params.items():
        if key.startswith("conv_"):
            prefix, tensors = f"convs.{key}", _conv(node)
        elif key in ("dense_0", "head"):
            prefix, tensors = key, _linear(node)
        else:
            raise KeyError(f"unexpected MNIST param {key!r}")
        for name, t in tensors.items():
            out[f"{prefix}.{name}"] = t
    return out


_RESNET_LAYER = {"Conv": "conv", "BatchNorm": "bn"}


def resnet_state_dict_from_flax(variables: Mapping[str, Any]
                                ) -> Dict[str, torch.Tensor]:
    """``tpu_pipelines.models.resnet`` variables (``{"params": ...,
    "batch_stats": ...}``) -> ``tpu_pipelines_torch.models.resnet`` state
    dict: ``conv_init`` / ``bn_init`` / ``head`` as they are named,
    ``stage{i}_block{j}`` under ``blocks.`` with flax's ``Conv_k`` /
    ``BatchNorm_k`` as ``conv{k}`` / ``bn{k}`` (``proj`` / ``proj_bn``
    kept)."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    out: Dict[str, torch.Tensor] = {}

    def layer(prefix: str, node: Mapping[str, Any],
              stat: Optional[Mapping[str, Any]]) -> None:
        if "kernel" in node and np.ndim(node["kernel"]) == 4:
            tensors = _conv(node)
        elif "kernel" in node:
            tensors = _linear(node)
        else:
            tensors = _norm(node)
            if stat is None:
                raise KeyError(f"no batch_stats for BatchNorm {prefix!r}")
            tensors["running_mean"] = _tensor(stat["mean"])
            tensors["running_var"] = _tensor(stat["var"])
        for name, t in tensors.items():
            out[f"{prefix}.{name}"] = t

    for key, node in params.items():
        if key.startswith("stage"):
            for sub, leaf in node.items():
                kind, _, k = sub.partition("_")
                name = f"{_RESNET_LAYER[kind]}{k}" if kind in _RESNET_LAYER else sub
                layer(f"blocks.{key}.{name}", leaf, stats.get(key, {}).get(sub))
        else:
            layer(key, node, stats.get(key))
    return out


def int8_state_dict_from_flax(
    tree: Mapping[str, Any],
    convert: Callable[[Mapping[str, Any]], Dict[str, torch.Tensor]],
    layouts: Mapping[str, Tuple[str, int]],
) -> Dict[str, torch.Tensor]:
    """The port's int8 state dict of a reference int8 ``tree``: the
    converter ``convert`` (e.g. :func:`bert_state_dict_from_flax`) moves
    each leaf's int8 values into the torch layout unchanged, and its
    scales broadcast to the leaf's shape, which are then reduced to one a
    channel along ``layouts`` (``trainer.quantize.channel_layouts`` of the
    port's model)."""
    from tpu_pipelines_torch.trainer.quantize import QVALUE, SCALE, compact_scale

    def pick(node: Any, scales: bool) -> Any:
        if isinstance(node, Mapping) and QUANT_Q in node:
            q = np.asarray(node[QUANT_Q])
            return (np.broadcast_to(np.asarray(node[QUANT_S], np.float32),
                                    q.shape) if scales else q)
        if isinstance(node, Mapping):
            return {k: pick(v, scales) for k, v in node.items()}
        return node

    values = convert(pick(tree, False))
    scales = convert(pick(tree, True))
    out: Dict[str, torch.Tensor] = {}
    for name, t in values.items():
        if t.dtype == torch.int8:
            out[name + QVALUE] = t
            out[name + SCALE] = compact_scale(scales[name], layouts[name])
        else:
            out[name] = t
    return out
