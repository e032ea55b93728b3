"""Taxi trainer module: the ``run_fn`` / ``build_model`` user contract.

The port of ``examples/taxi/taxi_trainer_module.py``: the module a pipeline
names as the Trainer's ``module_file``.  ``run_fn`` trains the
wide-and-deep model on the Transform's examples through the port's
``train_loop`` on ``fn_args.device`` (sigmoid cross-entropy plus accuracy,
Adam as ``optax.adam``: betas 0.9/0.999, eps 1e-8; ``capturable`` on CUDA,
so the update joins the step's CUDA graph), checkpoints every quarter of
the run, and exports a self-contained payload (state dict, this module,
the transform graph), with TensorBoard scalars under
``<model_run_dir>/tensorboard``.
"""

import os
from typing import Any, Dict

import torch
import torch.nn.functional as F

from tpu_pipelines_torch.data.input_pipeline import (
    BatchIterator,
    InputConfig,
    per_host_input_config,
)
from tpu_pipelines_torch.models.taxi import (
    DEFAULT_HPARAMS,
    build_taxi_model,
    init_taxi_weights,
)
from tpu_pipelines_torch.trainer import TrainLoopConfig, export_model, train_loop


def build_model(hyperparameters):
    return build_taxi_model(hyperparameters)


def _features(model) -> tuple:
    return (model.numeric_features + tuple(n for n, _ in model.categorical)
            + model.wide_features)


def apply_fn(model, params, batch: Dict[str, Any]):
    """Serving hook: numpy or tensor features in, logits on the params'
    device out (only the model's feature columns are read)."""
    device = next(iter(params.values())).device
    features = {
        k: torch.as_tensor(batch[k], device=device) for k in _features(model)
    }
    return torch.func.functional_call(model, params, (features,))


def make_loss_fn(label: str):
    def loss_fn(model, batch, generator):
        logits = model(batch)
        labels = batch[label].to(torch.float32)
        loss = F.binary_cross_entropy_with_logits(logits, labels)
        accuracy = ((logits > 0) == (labels > 0.5)).to(torch.float32).mean()
        return loss, {"accuracy": accuracy}
    return loss_fn


def adam(learning_rate: float):
    """``optax.adam(learning_rate)`` as an optimizer factory (capturable
    on CUDA parameters; torch refuses ``capturable`` on the CPU)."""
    def make(params):
        params = list(params)
        on_cuda = bool(params) and params[0].device.type == "cuda"
        return torch.optim.Adam(
            params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
            capturable=on_cuda,
        )
    return make


def run_fn(fn_args):
    hp = {**DEFAULT_HPARAMS, **fn_args.hyperparameters}
    label = hp["label"]
    batch_size = int(hp["batch_size"])

    train_iter = BatchIterator(
        fn_args.train_examples_uri, "train",
        per_host_input_config(
            InputConfig(batch_size=batch_size, shuffle=True, seed=0)),
    )

    def eval_iter_fn():
        return BatchIterator(
            fn_args.eval_examples_uri, "eval",
            InputConfig(batch_size=batch_size, shuffle=False, num_epochs=1,
                        drop_remainder=True),
        )

    def init_params_fn(generator, sample_batch):
        return init_taxi_weights(build_model(hp), generator)

    model, result = train_loop(
        loss_fn=make_loss_fn(label),
        init_params_fn=init_params_fn,
        optimizer=adam(hp["learning_rate"]),
        train_iter=train_iter,
        eval_iter_fn=eval_iter_fn,
        config=TrainLoopConfig(
            train_steps=fn_args.train_steps,
            batch_size=batch_size,
            eval_steps=fn_args.eval_steps,
            checkpoint_every=max(1, fn_args.train_steps // 4),
            log_every=max(1, fn_args.train_steps // 10),
            mesh_config=fn_args.mesh_config or None,
            tensorboard_dir=os.path.join(fn_args.model_run_dir, "tensorboard"),
        ),
        checkpoint_dir=fn_args.model_run_dir,
        device=fn_args.device,
    )

    export_model(
        serving_model_dir=fn_args.serving_model_dir,
        params=model.state_dict(),
        module_file=__file__,
        hyperparameters=hp,
        transform_graph_uri=fn_args.transform_graph_uri,
        extra_spec={"label": label},
    )
    return result
