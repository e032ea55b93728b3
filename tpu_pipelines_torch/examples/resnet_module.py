"""ResNet trainer module: the port of ``examples/resnet/resnet_trainer_module.py``
(BASELINE configs[2], ResNet-50 ImageNet).

The module a pipeline names as the Trainer's ``module_file``.  It expects
Examples rows with an ``image`` column (flattened H*W*3 floats) and an
integer ``label`` column; ``image_size`` in the hyperparameters gives
H = W.  ``run_fn`` trains through the port's ``train_loop`` with
``has_model_state=True`` on ``fn_args.device``: the BatchNorm running
statistics are the model's buffers, moved by every training step (the
eager first step and each replay of the captured one), carried by the
checkpoints and shipped in the exported payload's state dict, where
``apply_fn`` serves from them in ``eval()`` mode.

The optimizer is ``optax.sgd(lr, momentum=0.9, nesterov=True)``:
``torch.optim.SGD(momentum=0.9, nesterov=True, dampening=0)`` with no
weight decay (the reference ignores ``EXAMPLE_DEFAULTS["weight_decay"]``,
and so does this module).  SGD has no ``capturable`` flag and needs none:
its learning rate is a constant of the graph, and its momentum buffers
are born in the loop's eager first step, so the capture records updates
of tensors that already exist (``chip_smoke.py``'s ``vision_train`` phase
holds the captured run against eager SGD bit for bit on the card).
"""

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from tpu_pipelines_torch.data.input_pipeline import (
    BatchIterator,
    InputConfig,
    per_host_input_config,
)
from tpu_pipelines_torch.models.resnet import (
    DEFAULT_HPARAMS,
    build_resnet_model,
    init_resnet_weights,
)
from tpu_pipelines_torch.trainer import (
    TrainLoopConfig,
    export_model,
    train_loop,
    warm_start_init,
)

EXAMPLE_DEFAULTS = {
    **DEFAULT_HPARAMS,
    "image_size": 224,
    "batch_size": 256,
    "momentum": 0.9,
    "weight_decay": 1e-4,
}


def build_model(hyperparameters):
    return build_resnet_model(hyperparameters)


def apply_fn(model, params, batch: Dict[str, Any]):
    """Serving hook: flattened H*W*3 rows (or NHWC images) in, logits on
    the params' device out, in ``eval()`` mode on the running averages
    (``params`` is the whole state dict, buffers included).  The side
    length comes from the column width."""
    device = next(iter(params.values())).device
    img = torch.as_tensor(batch["image"], device=device).float()
    if img.ndim == 2:
        size = int(round((img.shape[1] // 3) ** 0.5))
        img = img.reshape(img.shape[0], size, size, 3)
    model.eval()
    return torch.func.functional_call(model, params, (img,))


def _to_images(batch, size):
    img = np.asarray(batch["image"], np.float32)
    if img.ndim == 2:  # flattened rows
        img = img.reshape(len(img), size, size, 3)
    return img


def loss_fn(model, batch, generator):
    """Mean softmax cross-entropy of the f32 logits against the integer
    ``label`` column, and accuracy; ``train()`` mode moves the BatchNorm
    running statistics."""
    logits = model(batch["image"])
    labels = batch["label"].long()
    loss = F.cross_entropy(logits, labels)
    accuracy = (logits.argmax(-1) == labels).float().mean()
    return loss, {"accuracy": accuracy}


def sgd(learning_rate: float, momentum: float = 0.9):
    """``optax.sgd(learning_rate, momentum, nesterov=True)`` as an
    optimizer factory (see the module docstring)."""
    def make(params):
        return torch.optim.SGD(params, lr=learning_rate, momentum=momentum,
                               dampening=0.0, nesterov=True, weight_decay=0.0)
    return make


def run_fn(fn_args):
    hp = {**EXAMPLE_DEFAULTS, **fn_args.hyperparameters}
    batch_size = int(hp["batch_size"])
    size = int(hp["image_size"])

    def with_images(it):
        for b in it:
            yield {**b, "image": _to_images(b, size)}

    train_iter = with_images(BatchIterator(
        fn_args.train_examples_uri, "train",
        per_host_input_config(
            InputConfig(batch_size=batch_size, shuffle=True, seed=0)),
    ))

    def eval_iter_fn():
        return with_images(BatchIterator(
            fn_args.eval_examples_uri, "eval",
            InputConfig(batch_size=batch_size, shuffle=False, num_epochs=1,
                        drop_remainder=True),
        ))

    def init_params_fn(generator, sample_batch):
        return init_resnet_weights(build_model(hp), generator)

    model, result = train_loop(
        loss_fn=loss_fn,
        init_params_fn=warm_start_init(fn_args, init_params_fn),
        optimizer=sgd(hp["learning_rate"], hp["momentum"]),
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
        has_model_state=True,
        device=fn_args.device,
    )

    export_model(
        serving_model_dir=fn_args.serving_model_dir,
        # The whole state dict: apply_fn serves from the BatchNorm running
        # statistics it carries.
        params=model.state_dict(),
        module_file=__file__,
        hyperparameters=hp,
        transform_graph_uri=fn_args.transform_graph_uri,
        extra_spec={"label": "label"},
    )
    return result
