"""Pipeline-parallel trainer module: the port of
``examples/staged/staged_trainer_module.py`` (dp x pp through the Trainer
component).

With a Trainer ``mesh`` of ``{"data": D, "pipe": S}`` (run under
``torchrun --nproc-per-node D*S``, or the ``TPP_*`` variables of
``parallel/distributed.py``) the staged classifier (``models/staged.py``)
trains with GPipe microbatching over ``pipe``: ``n_stages`` is S, every
rank holds its stage, and ``param_partition`` comes from
``staged_partition_rules`` (the stacked stages over ``pipe``; embed and
head replicate).  The rows are dealt over ``data`` alone: the S ranks of
one data coordinate read the same shard.  With no mesh (or ``pipe`` = 1)
the same module trains the same network with its stages in order.  The
loss is softmax cross-entropy on the integer ``label`` plus accuracy, the
optimizer ``optax.adam(learning_rate)``.  Rank 0 exports the gathered
model, whose payload always serves its stages in order, with no mesh.
"""

from typing import Any, Dict

import torch
import torch.nn.functional as F

from tpu_pipelines_torch.data.input_pipeline import (
    BatchIterator,
    InputConfig,
    per_host_input_config,
)
from tpu_pipelines_torch.examples.taxi_module import adam
from tpu_pipelines_torch.models.staged import (
    DEFAULT_HPARAMS,
    build_staged_model,
    init_staged_weights,
    staged_partition_rules,
)
from tpu_pipelines_torch.parallel.distributed import maybe_join_process_group
from tpu_pipelines_torch.parallel.mesh import as_mesh_config, make_mesh
from tpu_pipelines_torch.parallel.partition import make_param_partition
from tpu_pipelines_torch.trainer import (
    TrainLoopConfig,
    export_model,
    train_loop,
    warm_start_init,
)
from tpu_pipelines_torch.trainer.export import resolve_device

LABEL = "label"


def build_model(hyperparameters):
    return build_staged_model(hyperparameters)


def apply_fn(model, params, batch: Dict[str, Any]):
    """Serving and eval hook: the stages in order, no mesh."""
    device = next(iter(params.values())).device
    tokens = torch.as_tensor(batch["tokens"], device=device).long()
    return torch.func.functional_call(model, params, (tokens,))


def loss_fn(model, batch, generator):
    """Mean softmax cross-entropy against the integer ``label`` column,
    and accuracy."""
    logits = model(batch["tokens"])
    labels = batch[LABEL].long()
    loss = F.cross_entropy(logits, labels)
    accuracy = (logits.argmax(-1) == labels).float().mean()
    return loss, {"accuracy": accuracy}


def run_fn(fn_args):
    hp = {**DEFAULT_HPARAMS, **fn_args.hyperparameters}
    batch_size = int(hp["batch_size"])
    rank, world = maybe_join_process_group(fn_args.device)
    sizes = vars(as_mesh_config(fn_args.mesh_config or None))
    mesh = None
    shard = per_host_input_config(
        InputConfig(batch_size=batch_size // world, shuffle=True, seed=0,
                    drop_remainder=True))
    if any(sizes[a] != 1 for a in ("model", "seq", "expert", "pipe")):
        mesh = make_mesh(fn_args.mesh_config, device=resolve_device(fn_args.device))
        shard = per_host_input_config(
            InputConfig(batch_size=batch_size // mesh.size, shuffle=True, seed=0,
                        drop_remainder=True),
            process_index=mesh.rank, process_count=mesh.size)
    # The stage count is the pipe axis: the stages split exactly over it.
    pipe = mesh.axis_size("pipe") if mesh is not None else 1
    hp["n_stages"] = pipe if pipe > 1 else int(
        fn_args.hyperparameters.get("n_stages", DEFAULT_HPARAMS["n_stages"]))
    with torch.device("meta"):
        param_partition = make_param_partition(build_staged_model(hp),
                                               staged_partition_rules())

    train_iter = BatchIterator(fn_args.train_examples_uri, "train", shard)

    def eval_iter_fn():
        return BatchIterator(
            fn_args.eval_examples_uri, "eval",
            InputConfig(batch_size=batch_size, shuffle=False, num_epochs=1,
                        drop_remainder=True),
        )

    def init_params_fn(generator, sample_batch):
        return init_staged_weights(build_staged_model(hp, mesh=mesh), generator)

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
            param_partition=param_partition,
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
        extra_spec={"label": LABEL},
    )
    return result
