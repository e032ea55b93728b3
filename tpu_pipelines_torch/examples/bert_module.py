"""BERT fine-tune trainer module: the port of
``examples/bert/bert_trainer_module.py``.

``build_model`` / ``apply_fn`` are the payload contract: the serving hook
routes the tokenized feature dict into the classifier, with
``attention_mask = input_ids > 0`` when the request carries none.
``run_fn`` is the Trainer's contract: it sizes the embedding from the
vocabulary the Transform's tokenizer learned (rounded up to a multiple of
64) unless the hyperparameters pin ``vocab_size``, trains through the
port's ``train_loop`` on ``fn_args.device`` (``loss_fn``: softmax
cross-entropy on integer labels plus accuracy; ``adamw``: ``optax.adamw``),
warm-starts from a wired base model (``warm_start_init``), checkpoints every
quarter of the run and exports a payload with the transform graph.  The
Trainer's ``mesh`` is passed through to ``train_loop`` as its
``mesh_config``: run under ``torchrun --nproc-per-node N`` (or the
``TPP_*`` variables, ``parallel/distributed.py``), every process joins the
process group, reads its own shard of the train split
(``per_host_input_config``, ``batch_size / N`` rows a step) and trains
data-parallel; rank 0 exports.  ``custom_config["train_loop"]``, a dict of
``TrainLoopConfig`` fields, is laid over the module's own (the loop's
extras, e.g. ``profile_dir``, ``tensorboard_dir``,
``collect_cost_analysis``, ``stall_timeout_s``, or ``checkpoint_every``),
so a pipeline turns them on without a module of its own.
"""

import functools
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from tpu_pipelines_torch.data.input_pipeline import (
    BatchIterator,
    InputConfig,
    per_host_input_config,
)
from tpu_pipelines_torch.parallel.distributed import maybe_join_process_group
from tpu_pipelines_torch.models.bert import (
    DEFAULT_HPARAMS,
    build_bert_model,
    init_bert_weights,
)
from tpu_pipelines_torch.trainer import (
    TrainLoopConfig,
    export_model,
    train_loop,
    warm_start_init,
)

LABEL = "label"


def build_model(hyperparameters):
    return build_bert_model(hyperparameters)


def apply_fn(model, params, batch):
    """Serving hook: numpy (or tensor) features in, logits on the params'
    device out."""
    device = next(iter(params.values())).device
    ids = torch.as_tensor(batch["input_ids"], device=device).long()
    mask = batch.get("attention_mask")
    mask = (ids > 0) if mask is None else torch.as_tensor(mask, device=device)
    features = {"input_ids": ids, "attention_mask": mask.to(torch.int32)}
    return torch.func.functional_call(model, params, (features,))


def init_params_fn(
    generator: torch.Generator,
    sample_batch: Dict[str, Any],
    hyperparameters: Optional[Dict[str, Any]] = None,
) -> torch.nn.Module:
    """A BERT classifier with BERT's initialisation drawn from
    ``generator`` (bind ``hyperparameters`` with ``functools.partial``)."""
    return init_bert_weights(build_bert_model(hyperparameters), generator)


def loss_fn(model, batch, generator):
    """Mean softmax cross-entropy of the classifier's logits against the
    integer ``label`` column, and accuracy."""
    features = {k: v for k, v in batch.items() if k != LABEL}
    logits = model(features, generator=generator)
    labels = batch[LABEL].long()
    loss = F.cross_entropy(logits.float(), labels)
    accuracy = (logits.argmax(-1) == labels).float().mean()
    return loss, {"accuracy": accuracy}


def adamw(learning_rate: float):
    """``optax.adamw(learning_rate)`` as an optimizer factory: the same
    update rule with optax's defaults (betas 0.9/0.999, eps 1e-8, decoupled
    weight decay 1e-4, not torch's 0.01).

    On CUDA parameters it is built ``capturable``, so its step count and
    bias correction stay on the device and ``train_loop`` can capture the
    update into its step's CUDA graph, and ``fused``: one captured update
    of BERT-base's parameters takes about 1.1 ms fused against 9.4 ms
    foreach (chip_smoke.py's training phase on an H100, PERF.md).  On CPU
    parameters it is the plain foreach AdamW (torch refuses
    ``capturable`` there)."""
    def make(params):
        params = list(params)
        on_cuda = bool(params) and params[0].device.type == "cuda"
        return torch.optim.AdamW(
            params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=1e-4, capturable=on_cuda, fused=on_cuda,
        )
    return make


def run_fn(fn_args):
    hp = {**DEFAULT_HPARAMS, **fn_args.hyperparameters}
    # Size the embedding from what the tokenizer learned (padded to a
    # multiple of 64) unless the user pinned it.
    if "vocab_size" not in fn_args.hyperparameters and fn_args.transform_graph_uri:
        from tpu_pipelines_torch.transform.graph import TransformGraph

        sizes = TransformGraph.load(
            fn_args.transform_graph_uri
        ).tokenizer_vocab_sizes()
        if "input_ids" in sizes:
            hp["vocab_size"] = -(-sizes["input_ids"] // 64) * 64
    batch_size = int(hp["batch_size"])
    rank, world = maybe_join_process_group(fn_args.device)

    train_iter = BatchIterator(
        fn_args.train_examples_uri, "train",
        per_host_input_config(
            InputConfig(batch_size=batch_size // world, shuffle=True, seed=0)),
    )

    def eval_iter_fn():
        return BatchIterator(
            fn_args.eval_examples_uri, "eval",
            InputConfig(batch_size=batch_size, shuffle=False, num_epochs=1,
                        drop_remainder=True),
        )

    model, result = train_loop(
        loss_fn=loss_fn,
        init_params_fn=warm_start_init(
            fn_args, functools.partial(init_params_fn, hyperparameters=hp)),
        optimizer=adamw(hp["learning_rate"]),
        train_iter=train_iter,
        eval_iter_fn=eval_iter_fn,
        config=TrainLoopConfig(**{
            "train_steps": fn_args.train_steps,
            "batch_size": batch_size,
            "eval_steps": fn_args.eval_steps,
            "checkpoint_every": max(1, fn_args.train_steps // 4),
            "log_every": max(1, fn_args.train_steps // 10),
            "mesh_config": fn_args.mesh_config or None,
            **((fn_args.custom_config or {}).get("train_loop") or {}),
        }),
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
        extra_spec={"label": LABEL},
    )
    return result
