"""T5 seq2seq trainer module: the port of
``examples/t5/t5_trainer_module.py``.

``build_model``, ``apply_fn``, ``make_generate_step`` and
``make_decode_fns`` are the payload contract:

  - ``apply_fn`` is the serving hook for ``:predict``: the teacher-forced
    logits of ``{inputs, targets [, input_mask]}``;
  - ``make_generate_step`` is the ``:generate`` hook (and BulkInferrer's
    ``predict_method="generate"``): beam search with ``beam_size``,
    ``max_decode_len`` and ``eos_id`` from the payload's hyperparameters;
  - ``make_decode_fns`` opts the payload into the continuous-batching
    engine (``serving/generative.py``).

``run_fn`` is the Trainer's contract: teacher-forced cross-entropy
(``loss_fn``, masked to the non-pad target positions) with Adam as
``optax.adam`` (``adam``), the vocabulary sized from the largest tokenize
output unless pinned, through the port's ``train_loop`` on
``fn_args.device``; it exports a payload with the transform graph, so the
payload's ``generate`` decodes raw examples.  The Trainer's ``mesh`` is
built into the run's mesh under a process group: the rows are dealt
over the ``data`` axis alone, as the reference shards its batch over
``data`` (the ranks of one data coordinate read the same shard of the
train split, ``data_coordinate``), the loss is one masked mean
over the whole batch (``loss_fn``), and T5 is built without a mesh, as
the reference's ``run_fn`` builds it: replicated on every other axis;
rank 0 exports.

End-of-sequence defaults to the tokenizer's [SEP] (id 3), as in the
reference module: its tokenizer emits "[CLS] ... [SEP]" with [PAD]=0
[UNK]=1 [CLS]=2 [SEP]=3, so trained targets end with 3.
"""

import functools
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from tpu_pipelines_torch.parallel import collectives
from tpu_pipelines_torch.parallel.distributed import maybe_join_process_group
from tpu_pipelines_torch.parallel.mesh import data_coordinate, make_mesh
from tpu_pipelines_torch.data.input_pipeline import (
    BatchIterator,
    InputConfig,
    per_host_input_config,
)
from tpu_pipelines_torch.models.transformer import batch_groups
from tpu_pipelines_torch.models.t5 import (
    DEFAULT_HPARAMS,
    build_t5_model,
    init_t5_weights,
    make_beam_generate,
    make_continuous_decode_fns,
)
from tpu_pipelines_torch.trainer import (
    TrainLoopConfig,
    export_model,
    train_loop,
    warm_start_init,
)
from tpu_pipelines_torch.trainer.export import resolve_device

EOS_ID = 3


def build_model(hyperparameters):
    return build_t5_model(hyperparameters)


def _device(params) -> torch.device:
    return next(iter(params.values())).device


def _ids(batch, key, device) -> torch.Tensor:
    return torch.as_tensor(batch[key], device=device).long()


def _mask(batch, device) -> Optional[torch.Tensor]:
    if "input_mask" not in batch:
        return None
    return torch.as_tensor(batch["input_mask"], device=device).to(torch.int32)


def apply_fn(model, params, batch):
    """Serving hook: numpy (or tensor) features in, f32 logits [b, l, vocab]
    on the params' device out."""
    device = _device(params)
    features: Dict[str, Any] = {
        "inputs": _ids(batch, "inputs", device),
        "targets": _ids(batch, "targets", device),
        "input_mask": _mask(batch, device),
    }
    return torch.func.functional_call(model, params, (features,))


def make_generate_step(model, hyperparameters):
    """Export hook: beam-search decoding, ``fn(params, batch) -> tokens
    [b, max_decode_len]`` (params stay an argument of every call)."""
    gen = make_beam_generate(
        model,
        beam_size=int(hyperparameters.get("beam_size", 4)),
        max_decode_len=int(hyperparameters.get("max_decode_len", 32)),
        eos_id=int(hyperparameters.get("eos_id", EOS_ID)),
    )

    def fn(params, batch):
        device = _device(params)
        tokens, _score = gen(params, _ids(batch, "inputs", device),
                             _mask(batch, device))
        return tokens

    return fn


def make_decode_fns(model, hyperparameters):
    """Export hook: the continuous-batching decode contract (prefill/step
    and geometry), with the same eos/pad conventions as
    ``make_generate_step``."""
    return make_continuous_decode_fns(
        model,
        max_decode_len=int(hyperparameters.get("max_decode_len", 32)),
        eos_id=int(hyperparameters.get("eos_id", EOS_ID)),
        max_input_len=int(hyperparameters.get("max_input_len", 64)),
    )


def init_params_fn(
    generator: torch.Generator,
    sample_batch: Dict[str, Any],
    hyperparameters: Optional[Dict[str, Any]] = None,
    mesh: Any = None,
) -> torch.nn.Module:
    """A T5 with the flax initialisers' scales drawn from ``generator``
    (bind ``hyperparameters`` and ``mesh`` with ``functools.partial``)."""
    return init_t5_weights(build_t5_model(hyperparameters, mesh=mesh), generator)


def loss_fn(model, batch, generator, mesh=None):
    """Teacher-forced softmax cross-entropy, masked by ``target_mask``
    (else ``targets > 0``) and divided by ``max(mask.sum(), 1)``: the
    reference's masked mean over the batch's tokens.

    Where a rank holds a share of the batch (``batch_groups`` of ``mesh``,
    else of the model's: its rows over ``data`` in the train loop's
    implicit mode, its block of the sequence on a split ``seq``), the
    loop averages each rank's loss and gradients over those axes.  A mean
    of per-rank masked means is not the masked mean when the ranks'
    counts differ, so the rank returns n x (its masked sum) / (the whole
    batch's count), and the loop's mean over the n ranks is the masked
    mean, its gradient one process's.  The count is summed here, in the
    loss, because it is the objective's denominator: the model's logits
    are right as they are, and the mask belongs to the batch the loss
    reads."""
    logits = model(batch, generator=generator)
    targets = batch["targets"].long()
    mask = batch.get("target_mask")
    mask = (targets > 0) if mask is None else mask
    mask = mask.to(torch.float32)
    per_tok = F.cross_entropy(
        logits.float().flatten(0, 1), targets.flatten(), reduction="none",
    ).view_as(mask)
    total, count = (per_tok * mask).sum(), mask.sum()
    for group, n in batch_groups(mesh or getattr(model, "mesh", None)):
        count = collectives.leave_partial(count, group)
        total = total * n
    return total / count.clamp_min(1.0), {}


def adam(learning_rate: float):
    """``optax.adam(learning_rate)`` as an optimizer factory (betas
    0.9/0.999, eps 1e-8, no weight decay); ``capturable`` and ``fused`` on
    CUDA parameters, so the update joins the step's CUDA graph as one
    launch; the plain foreach Adam on the CPU (torch refuses
    ``capturable`` there)."""
    def make(params):
        params = list(params)
        on_cuda = bool(params) and params[0].device.type == "cuda"
        return torch.optim.Adam(
            params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
            capturable=on_cuda, fused=on_cuda,
        )
    return make


def run_fn(fn_args):
    hp = {**DEFAULT_HPARAMS, **fn_args.hyperparameters}
    if "vocab_size" not in fn_args.hyperparameters and fn_args.transform_graph_uri:
        from tpu_pipelines_torch.transform.graph import TransformGraph

        sizes = TransformGraph.load(
            fn_args.transform_graph_uri
        ).tokenizer_vocab_sizes()
        if sizes:
            hp["vocab_size"] = -(-max(sizes.values()) // 64) * 64
    batch_size = int(hp["batch_size"])
    rank, world = maybe_join_process_group(fn_args.device)
    # The mesh deals the rows and gives the loss its axes; T5 itself is
    # built without it.
    mesh = (make_mesh(fn_args.mesh_config, device=resolve_device(fn_args.device))
            if world > 1 else None)

    index, count = data_coordinate(mesh)
    train_iter = BatchIterator(
        fn_args.train_examples_uri, "train",
        per_host_input_config(
            InputConfig(batch_size=batch_size // count, shuffle=True, seed=0),
            process_index=index, process_count=count),
    )

    def eval_iter_fn():
        return BatchIterator(
            fn_args.eval_examples_uri, "eval",
            InputConfig(batch_size=batch_size, shuffle=False, num_epochs=1,
                        drop_remainder=True),
        )

    model, result = train_loop(
        loss_fn=functools.partial(loss_fn, mesh=mesh),
        init_params_fn=warm_start_init(
            fn_args, functools.partial(init_params_fn, hyperparameters=hp)),
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
        mesh=mesh,
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
        extra_spec={"label": "targets"},
    )
    return result
