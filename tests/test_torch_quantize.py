"""Port parity: int8 weight quantization and int8 payloads.

  - The reference quantizes a flax tree with per-FIRST-axis scales
    (``tpu_pipelines/trainer/quantize.py``); the port quantizes the
    converted state dict along ``channel_layouts`` of its model.  After
    ``int8_state_dict_from_flax`` carries the reference's int8 tree over,
    the port's q-values must equal the reference's exactly and its scales
    bit for bit (aqt's f32 ``max|w| / 127.5``, ``w · (1/scale)`` clipped to
    ±127, round-half-even), for a
    tiny BERT (Dense, DenseGeneral q/k/v, the head-grouped output
    projection, embeddings) and a ResNet-18 (HWIO convolutions, the head).
    The report has the same count, total float bytes and total int8 bytes.
  - An int8 payload exported by the port serves on the CPU (int8 resident,
    no float copy of a quantized weight, dequantized in the step) as the
    reference's int8 payload of the same weights: both compute in bf16, so
    the two int8 payloads may differ by no more than twice what the two
    float payloads of the same weights differ by (measured 1.49x);
    ``dequantize_params`` of the state dict is each weight within half a
    scale of the float one.
"""

import jax
import numpy as np
import pytest
import torch

from tpu_pipelines.models.bert import build_bert_model as jax_build_bert
from tpu_pipelines.models.resnet import build_resnet_model as ref_build_resnet
from tpu_pipelines.trainer import quantize as ref_qz
from tpu_pipelines.trainer.export import export_model as jax_export_model
from tpu_pipelines.trainer.export import load_exported_model as jax_load
from tpu_pipelines_torch.examples import bert_module, resnet_module
from tpu_pipelines_torch.models.convert import (
    bert_state_dict_from_flax,
    int8_state_dict_from_flax,
    resnet_state_dict_from_flax,
)
from tpu_pipelines_torch.trainer import quantize as qz
from tpu_pipelines_torch.trainer.export import export_model, load_exported_model

from test_torch_serving import HP, JAX_MODULE, PORT_MODULE, _batch



def _bert_tree():
    model = jax_build_bert(HP)
    params = model.init(jax.random.key(3), _batch())["params"]
    rng = np.random.default_rng(0)
    # Spread the values so the scales differ channel by channel.
    return jax.tree.map(
        lambda a: np.asarray(a) * rng.uniform(0.5, 2.0, np.shape(a)).astype(np.float32)
        if np.ndim(a) else np.asarray(a), params)


def _resnet_variables():
    hp = {"depth": 18, "width": 8, "num_classes": 4}
    variables = ref_build_resnet(hp).init(
        jax.random.key(0), np.zeros((1, 8, 8, 3), np.float32), train=False)
    return hp, jax.tree.map(np.asarray, variables)


CASES = {
    "bert": (lambda: (HP, _bert_tree()), bert_state_dict_from_flax,
             lambda hp: bert_module.build_model(hp)),
    "resnet": (_resnet_variables, resnet_state_dict_from_flax,
               lambda hp: resnet_module.build_model(hp)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_quantization_equals_the_references_after_conversion(name):
    make, convert, build = CASES[name]
    hp, tree = make()
    layouts = qz.channel_layouts(build(hp))
    ref_tree, ref_report = ref_qz.quantize_params(tree)
    ref_tree = jax.tree.map(np.asarray, ref_tree)
    want = int8_state_dict_from_flax(ref_tree, convert, layouts)
    got, report = qz.quantize_params(convert(tree), layouts)
    assert sorted(got) == sorted(want)
    assert qz.quantized_names(got) and qz.tree_is_quantized(got)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        if k.endswith(qz.SCALE):
            assert got[k].numel() == v.numel(), k
        assert torch.equal(got[k], v), k
    for key in ("num_quantized", "min_quant_size"):
        assert report[key] == ref_report[key]
    for field in ("bytes_float", "bytes_int8"):
        assert (sum(leaf[field] for leaf in report["quantized_leaves"])
                == sum(leaf[field] for leaf in ref_report["quantized_leaves"]))
    assert qz.infer_dtype(got) == ref_qz.infer_dtype(ref_tree) == qz.DTYPE_AQT_INT8


def test_dequantize_is_within_half_a_scale_and_leaves_the_rest():
    hp, tree = HP, _bert_tree()
    sd = bert_state_dict_from_flax(tree)
    q, _ = qz.quantize_params(sd, qz.channel_layouts(bert_module.build_model(hp)))
    dense = qz.dequantize_params(q)
    assert sorted(dense) == sorted(sd)
    for name in qz.quantized_names(q):
        scale = q[name + qz.SCALE]
        gap = (dense[name] - sd[name]).abs()
        if scale.dim() == gap.dim():
            bound = scale / 2
        else:
            bound = scale.view(1, -1, 1).expand(
                gap.shape[0], -1, gap.shape[1] // scale.shape[1]).reshape(gap.shape) / 2
        # Half a scale, plus the f32 rounding of the scale and the product.
        assert bool((gap <= bound + 1e-6 * sd[name].abs()).all()), name
    for name in set(sd) - set(qz.quantized_names(q)):
        assert torch.equal(dense[name], sd[name]), name
    cast = qz.cast_params(q, torch.bfloat16)
    assert all(cast[n + qz.SCALE].dtype == torch.float32 for n in qz.quantized_names(q))


def test_int8_payload_serves_as_the_references(tmp_path):
    tree = _bert_tree()
    ref_tree, _ = ref_qz.quantize_params(tree)
    jax_export_model(serving_model_dir=str(tmp_path / "ref"), params=ref_tree,
                     module_file=JAX_MODULE, hyperparameters=HP,
                     serving_dtype="aqt_int8")
    sd = bert_state_dict_from_flax(tree)
    q, _ = qz.quantize_params(sd, qz.channel_layouts(bert_module.build_model(HP)))
    export_model(serving_model_dir=str(tmp_path / "int8"), params=q,
                 module_file=PORT_MODULE, hyperparameters=HP,
                 serving_dtype="aqt_int8")
    export_model(serving_model_dir=str(tmp_path / "f32"), params=sd,
                 module_file=PORT_MODULE, hyperparameters=HP)
    ref = jax_load(str(tmp_path / "ref"))
    loaded = load_exported_model(str(tmp_path / "int8"), device="cpu")
    dense = load_exported_model(str(tmp_path / "f32"), device="cpu")
    assert loaded.dtype == "aqt_int8" and loaded.generate is None
    assert loaded.decode_fns is None
    int8_names = [k for k, v in loaded.params.items() if v.dtype == torch.int8]
    assert len(int8_names) == len(qz.quantized_names(q))
    # No float copy of a quantized weight is resident.
    assert not set(qz.quantized_names(q)) & set(loaded.params)
    assert all(p.numel() == 0 for n, p in loaded.model.named_parameters()
               if n in qz.quantized_names(q))
    assert loaded.params_bytes < 0.5 * dense.params_bytes
    jax_export_model(serving_model_dir=str(tmp_path / "ref_f32"), params=tree,
                     module_file=JAX_MODULE, hyperparameters=HP)
    ref_dense = jax_load(str(tmp_path / "ref_f32"))
    batch = _batch()
    got = loaded.predict_transformed(batch)
    want = np.asarray(ref.predict_transformed(batch))
    # The two frameworks' bf16 roundings: the int8 payloads may differ no
    # more than 2x the float payloads of the same weights differ.
    floor = np.abs(dense.predict_transformed(batch)
                   - np.asarray(ref_dense.predict_transformed(batch))).max()
    print({"int8_gap": float(np.abs(got - want).max()), "f32_gap": float(floor)})
    assert np.abs(got - want).max() <= 2.0 * floor + 1e-6
    assert np.abs(got - dense.predict_transformed(batch)).max() > 0
