"""Pipeline-parallel training pipeline on the port, the twin of
``examples/staged/pipeline.py``:

    ImportExampleGen -> Trainer (dp x pp) -> Evaluator

The Trainer trains the staged transformer classifier (``models/staged.py``)
over a ``{"data": D, "pipe": S}`` mesh through the ordinary component
(``staged_module.py``).  Run it with ``python -m tpu_pipelines_torch run
--pipeline-module tpu_pipelines_torch/examples/staged_pipeline.py`` (add
``--device cpu`` for the CPU); for the pipeline schedule, start D x S
processes (``torchrun --nproc-per-node 8``).  Env knobs:
``STAGED_TRAIN_STEPS`` (60), ``STAGED_DATA`` (2), ``STAGED_PIPE`` (4).
When the processes of the group (or of the one the env describes) are
fewer than D x S (one process, as the CLI runs), the reference's fallback
applies: plain data parallelism
with the stages in order, the same network with no pipeline schedule.
Synthetic token data (label = first token mod 4, numpy seed 0, the
reference's file) is written on first run.  Output lands under
``base_dir``, else ``$TPP_PIPELINE_HOME``, else this directory's
``_staged_run``.
"""

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def _ensure_data(base: str) -> str:
    path = os.path.join(base, "staged_synthetic.npz")
    if not os.path.exists(path):
        os.makedirs(base, exist_ok=True)
        rng = np.random.default_rng(0)
        n, seq_len, vocab, classes = 4096, 16, 64, 4
        tokens = rng.integers(2, vocab, size=(n, seq_len))
        np.savez(
            path,
            tokens=tokens.astype(np.int64),
            label=(tokens[:, 0] % classes).astype(np.int64),
        )
    return path


def create_pipeline(base_dir: str = ""):
    from tpu_pipelines_torch.components import (
        Evaluator,
        ImportExampleGen,
        Trainer,
    )
    from tpu_pipelines_torch.dsl.pipeline import Pipeline
    from tpu_pipelines_torch.parallel.distributed import (
        DistributedConfig,
        process_topology,
    )

    base = base_dir or os.environ.get(
        "TPP_PIPELINE_HOME", os.path.join(HERE, "_staged_run")
    )
    data = int(os.environ.get("STAGED_DATA", "2"))
    pipe = int(os.environ.get("STAGED_PIPE", "4"))
    # The processes of the group, or of the one the env describes (the
    # run_fn joins it).
    described = DistributedConfig.from_env()
    processes = max(process_topology()[1],
                    described.num_processes if described else 1)
    if processes < data * pipe:
        # Fewer processes than the mesh: plain DP, the stages in order,
        # the same network with no pipeline schedule.
        data, pipe = -1, 1

    gen = ImportExampleGen(input_path=_ensure_data(base))
    trainer = Trainer(
        examples=gen.outputs["examples"],
        module_file=os.path.join(HERE, "staged_module.py"),
        train_steps=int(os.environ.get("STAGED_TRAIN_STEPS", "60")),
        hyperparameters={"batch_size": 32},
        mesh={"data": data, "pipe": pipe},
    )
    evaluator = Evaluator(
        examples=gen.outputs["examples"],
        model=trainer.outputs["model"],
        label_key="label",
        problem="multiclass",
        batch_size=64,
    )
    return Pipeline(
        "staged-pp", [gen, trainer, evaluator],
        pipeline_root=os.path.join(base, "root"),
        metadata_path=os.path.join(base, "metadata.sqlite"),
    )


if __name__ == "__main__":
    from tpu_pipelines_torch.orchestration import LocalDagRunner

    result = LocalDagRunner().run(create_pipeline())
    for node_id, nr in result.nodes.items():
        print(f"  {node_id}: {nr.status}")
