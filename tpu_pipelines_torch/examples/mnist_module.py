"""MNIST trainer module: the port of ``examples/mnist/mnist_trainer_module.py``
(BASELINE configs[1]).

The module a pipeline names as the Trainer's ``module_file``.  It expects
Examples rows with an ``image`` column (flattened 28*28 floats or (28, 28)
arrays) and an integer ``label`` column.  ``run_fn`` trains the CNN through
the port's ``train_loop`` on ``fn_args.device`` (softmax cross-entropy plus
accuracy, Adam as ``optax.adam(1e-3)``: betas 0.9/0.999, eps 1e-8;
``capturable`` on CUDA, so the update joins the step's CUDA graph; dropout
from the loop's per-step generator), warm-starts from a wired base model,
checkpoints every quarter of the run and exports a payload.
"""

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from tpu_pipelines_torch.parallel.distributed import maybe_join_process_group
from tpu_pipelines_torch.data.input_pipeline import (
    BatchIterator,
    InputConfig,
    per_host_input_config,
)
from tpu_pipelines_torch.examples.taxi_module import adam
from tpu_pipelines_torch.models.mnist import (
    DEFAULT_HPARAMS,
    build_mnist_model,
    init_mnist_weights,
)
from tpu_pipelines_torch.trainer import (
    TrainLoopConfig,
    export_model,
    train_loop,
    warm_start_init,
)


def build_model(hyperparameters):
    return build_mnist_model(hyperparameters)


def apply_fn(model, params, batch: Dict[str, Any]):
    """Serving hook: the image column (flattened rows or images) in, logits
    on the params' device out, in ``eval()`` mode."""
    device = next(iter(params.values())).device
    img = torch.as_tensor(batch["image"], device=device).float()
    if img.ndim == 2:
        img = img.reshape(img.shape[0], 28, 28, 1)
    model.eval()
    return torch.func.functional_call(model, params, (img,))


def _to_images(batch):
    img = np.asarray(batch["image"], np.float32)
    if img.ndim == 2:  # flattened rows
        img = img.reshape(len(img), 28, 28, 1)
    return img


def loss_fn(model, batch, generator):
    """Mean softmax cross-entropy against the integer ``label`` column,
    and accuracy."""
    logits = model(batch["image"], generator=generator)
    labels = batch["label"].long()
    loss = F.cross_entropy(logits, labels)
    accuracy = (logits.argmax(-1) == labels).float().mean()
    return loss, {"accuracy": accuracy}


def run_fn(fn_args):
    hp = {**DEFAULT_HPARAMS, **fn_args.hyperparameters}
    batch_size = int(hp["batch_size"])
    rank, world = maybe_join_process_group(fn_args.device)

    def with_images(it):
        for b in it:
            yield {**b, "image": _to_images(b)}

    train_iter = with_images(BatchIterator(
        fn_args.train_examples_uri, "train",
        per_host_input_config(
            InputConfig(batch_size=batch_size // world, shuffle=True, seed=0)),
    ))

    def eval_iter_fn():
        return with_images(BatchIterator(
            fn_args.eval_examples_uri, "eval",
            InputConfig(batch_size=batch_size, shuffle=False, num_epochs=1,
                        drop_remainder=True),
        ))

    def init_params_fn(generator, sample_batch):
        return init_mnist_weights(build_model(hp), generator)

    model, result = train_loop(
        loss_fn=loss_fn,
        init_params_fn=warm_start_init(fn_args, init_params_fn),
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
        ),
        checkpoint_dir=fn_args.model_run_dir,
        device=fn_args.device,
    )

    if rank:
        return result  # rank 0 exports
    export_model(
        serving_model_dir=fn_args.serving_model_dir,
        params=model.state_dict(),
        module_file=__file__,
        hyperparameters=hp,
        transform_graph_uri=fn_args.transform_graph_uri,
        extra_spec={"label": "label"},
    )
    return result
