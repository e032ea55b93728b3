"""The ResNet Evaluator's loss: the port against the reference on the same
weights and rows.

The ResNet DAG on the card read an eval loss of 75.5 at accuracy 0.847 on
72 rows, which nobody had compared with the reference.  Here ResNet-18
(width 8, 8x8 images, 4 classes) gets flax weights with running statistics
far from the batches' own (a running variance of 0.1 inflates every
BatchNorm output about threefold in eval mode, as the running averages of
a short high-rate run leave them), the same weights are converted into the port's state dict
(``models/convert.py``), both packages export their payload, and both
Evaluators' ``evaluate_payload`` (``problem="multiclass"``, eval mode on
the running averages) read the same 72 rows.  Both models compute in bf16 (the payloads'
hyperparameters name no dtype, and neither model reads one), so the
tolerance is ``tests/test_torch_vision_models.py``'s for bf16: the port's
loss may sit no further from the reference's than 1.5x the reference's
own bf16 loss sits from its f32 loss (the same weights and rows through
flax in f32, scored by the reference's metric function).  Accuracy, top-3
accuracy and macro F1 must be equal.  The loss is large and the logits
hundreds wide, as a loss like the card's comes from the model's eval-mode
logits, not from the Evaluator.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa

from tpu_pipelines.components.evaluator import evaluate_payload as ref_evaluate
from tpu_pipelines.data import examples_io as ref_io
from tpu_pipelines.evaluation.metrics import _multiclass_metrics
from tpu_pipelines.models.resnet import build_resnet_model as ref_build
from tpu_pipelines.trainer.export import export_model as ref_export
from tpu_pipelines_torch.components.evaluator import evaluate_payload
from tpu_pipelines_torch.data import examples_io as port_io
from tpu_pipelines_torch.examples import resnet_module
from tpu_pipelines_torch.models.convert import resnet_state_dict_from_flax
from tpu_pipelines_torch.trainer.export import export_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_MODULE = os.path.join(REPO, "examples", "resnet", "resnet_trainer_module.py")
SIZE, CLASSES, ROWS = 8, 4, 72
HP = {"depth": 18, "width": 8, "num_classes": CLASSES, "image_size": SIZE}
BF16_FLOOR = 1.5


def _variables():
    model = ref_build(HP)
    variables = jax.device_get(model.init(
        jax.random.PRNGKey(0), np.zeros((1, SIZE, SIZE, 3), np.float32),
        train=False))
    rng = np.random.default_rng(1)
    variables = jax.tree_util.tree_map(np.asarray, variables)

    def stats(node):
        if isinstance(node, dict) and "mean" in node:
            return {"mean": rng.normal(0, 0.1, node["mean"].shape).astype(np.float32),
                    "var": np.full(node["var"].shape, 0.1, np.float32)}
        return {k: stats(v) for k, v in node.items()}

    def scales(node):
        if isinstance(node, dict) and "scale" in node and "bias" in node:
            return {"scale": np.ones_like(node["scale"]), "bias": node["bias"]}
        if isinstance(node, dict):
            return {k: scales(v) for k, v in node.items()}
        return node

    return {"params": scales(variables["params"]),
            "batch_stats": stats(variables["batch_stats"])}


def _rows():
    rng = np.random.default_rng(2)
    images = rng.normal(size=(ROWS, SIZE * SIZE * 3)).astype(np.float32)
    labels = rng.integers(0, CLASSES, ROWS).astype(np.int64)
    return images, labels


def test_resnet_eval_loss_matches_the_reference_on_the_same_weights(tmp_path):
    variables = _variables()
    images, labels = _rows()
    ref_uri = str(tmp_path / "ref_model")
    ref_export(serving_model_dir=ref_uri, params=variables,
               module_file=REF_MODULE, hyperparameters=HP)
    port_uri = export_model(
        serving_model_dir=str(tmp_path / "port_model"),
        params=resnet_state_dict_from_flax(variables),
        module_file=resnet_module.__file__, hyperparameters=HP)

    ref_examples, port_examples = str(tmp_path / "ref_ex"), str(tmp_path / "port_ex")
    ref_io.write_split(ref_examples, "eval", pa.table({
        "image": pa.array(list(images), type=pa.list_(pa.float32())),
        "label": pa.array(labels)}))
    port_io.write_split(port_examples, "eval", {"image": images, "label": labels})

    props = {"label_key": "label", "problem": "multiclass",
             "eval_split": "eval", "batch_size": 24, "slice_columns": (),
             "max_eval_examples": 0}
    ref = ref_evaluate(ref_uri, ref_examples, props).overall().metrics
    port = evaluate_payload(port_uri, port_examples, props,
                            device="cpu").overall().metrics
    f32_logits = ref_build(HP).clone(dtype=jnp.float32).apply(
        variables, images.reshape(-1, SIZE, SIZE, 3), train=False)
    ref_f32 = _multiclass_metrics(np.asarray(f32_logits), labels)
    bound = BF16_FLOOR * abs(ref["loss"] - ref_f32["loss"])
    print(json.dumps({"test": "test_torch_resnet_eval_loss.py::"
                      "test_resnet_eval_loss_matches_the_reference_on_the_same_weights",
                      "reference": ref, "port": port,
                      "reference_f32_loss": ref_f32["loss"],
                      "loss_tolerance": bound,
                      "where": "components/evaluator.py:evaluate_payload"}))
    assert sorted(port) == sorted(ref)
    assert abs(port["loss"] - ref["loss"]) <= bound
    for k in ("accuracy", "top3_accuracy", "macro_f1"):
        assert port[k] == ref[k], (k, ref, port)
    assert ref["loss"] > 100.0          # eval-mode logits of this model
