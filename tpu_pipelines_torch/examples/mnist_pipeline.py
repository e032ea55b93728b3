"""MNIST CNN pipeline on the port (BASELINE configs[1]), the twin of
``examples/mnist/pipeline.py``:

    ImportExampleGen -> Trainer -> Evaluator

Run it on the GPU with ``python -m tpu_pipelines_torch run
--pipeline-module tpu_pipelines_torch/examples/mnist_pipeline.py`` (add
``--device cpu`` for the CPU).  ``MNIST_NPZ`` names an npz with ``image``
[N, 784] float and ``label`` [N] int arrays; without it, MNIST-shaped data
(the class encoded in the mean brightness) is drawn from numpy's seed 0,
the same file the reference writes.  ``MNIST_TRAIN_STEPS`` sets the budget
(100 steps of 128).  Output lands under ``base_dir``, else
``$TPP_PIPELINE_HOME``, else this directory's ``_mnist_run``.
"""

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def _ensure_data(base: str) -> str:
    given = os.environ.get("MNIST_NPZ", "")
    if given:
        return given
    path = os.path.join(base, "mnist_synthetic.npz")
    if not os.path.exists(path):
        os.makedirs(base, exist_ok=True)
        rng = np.random.default_rng(0)
        n = 4096
        labels = rng.integers(0, 10, size=n)
        base_img = labels[:, None] / 10.0
        images = (
            base_img + 0.15 * rng.normal(size=(n, 28 * 28))
        ).astype(np.float32)
        np.savez(path, image=images, label=labels.astype(np.int64))
    return path


def create_pipeline(base_dir: str = ""):
    from tpu_pipelines_torch.components import (
        Evaluator,
        ImportExampleGen,
        Trainer,
    )
    from tpu_pipelines_torch.dsl.pipeline import Pipeline

    base = base_dir or os.environ.get(
        "TPP_PIPELINE_HOME", os.path.join(HERE, "_mnist_run")
    )
    gen = ImportExampleGen(input_path=_ensure_data(base))
    trainer = Trainer(
        examples=gen.outputs["examples"],
        module_file=os.path.join(HERE, "mnist_module.py"),
        train_steps=int(os.environ.get("MNIST_TRAIN_STEPS", "100")),
        hyperparameters={"batch_size": 128},
    )
    evaluator = Evaluator(
        examples=gen.outputs["examples"],
        model=trainer.outputs["model"],
        label_key="label",
        problem="multiclass",
        batch_size=128,
    )
    return Pipeline(
        "mnist-cnn", [gen, trainer, evaluator],
        pipeline_root=os.path.join(base, "root"),
        metadata_path=os.path.join(base, "metadata.sqlite"),
    )


if __name__ == "__main__":
    from tpu_pipelines_torch.orchestration import LocalDagRunner

    result = LocalDagRunner().run(create_pipeline())
    for node_id, nr in result.nodes.items():
        print(f"  {node_id}: {nr.status}")
