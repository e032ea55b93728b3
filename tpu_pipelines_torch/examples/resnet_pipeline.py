"""ResNet pipeline on the port (BASELINE configs[2], ResNet-50 ImageNet),
the twin of ``examples/resnet/pipeline.py``:

    ImportExampleGen -> Trainer (BatchNorm model state) -> Evaluator

Run it on the GPU with ``python -m tpu_pipelines_torch run
--pipeline-module tpu_pipelines_torch/examples/resnet_pipeline.py`` (add
``--device cpu`` and a small ``RESNET_DEPTH`` / ``RESNET_IMAGE_SIZE`` for
the CPU).  ImageNet-shaped inputs come from ``RESNET_NPZ`` (npz: ``image``
[N, H*W*3] float, ``label`` [N] int); without it, 2048 synthetic images
(the class encoded in the mean brightness) are drawn from numpy's seed 0,
the same file the reference writes.  Env knobs, read when the pipeline is
made: ``RESNET_DEPTH`` (50), ``RESNET_IMAGE_SIZE`` (32), ``RESNET_CLASSES``
(10), ``RESNET_TRAIN_STEPS`` (60), ``RESNET_BATCH`` (64).  Output lands
under ``base_dir``, else ``$TPP_PIPELINE_HOME``, else this directory's
``_resnet_run``.
"""

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def _image_size() -> int:
    return int(os.environ.get("RESNET_IMAGE_SIZE", "32"))


def _n_classes() -> int:
    return int(os.environ.get("RESNET_CLASSES", "10"))


def _ensure_data(base: str) -> str:
    given = os.environ.get("RESNET_NPZ", "")
    if given:
        return given
    image_size, n_classes = _image_size(), _n_classes()
    path = os.path.join(base, f"images_{image_size}_c{n_classes}.npz")
    if not os.path.exists(path):
        os.makedirs(base, exist_ok=True)
        rng = np.random.default_rng(0)
        n = 2048
        labels = rng.integers(0, n_classes, size=n)
        base_img = labels[:, None, None, None] / n_classes
        images = (
            base_img + 0.1 * rng.normal(size=(n, image_size, image_size, 3))
        ).astype(np.float32)
        np.savez(path, image=images.reshape(n, -1),
                 label=labels.astype(np.int64))
    return path


def create_pipeline(base_dir: str = ""):
    from tpu_pipelines_torch.components import (
        Evaluator,
        ImportExampleGen,
        Trainer,
    )
    from tpu_pipelines_torch.dsl.pipeline import Pipeline

    base = base_dir or os.environ.get(
        "TPP_PIPELINE_HOME", os.path.join(HERE, "_resnet_run")
    )
    gen = ImportExampleGen(input_path=_ensure_data(base))
    trainer = Trainer(
        examples=gen.outputs["examples"],
        module_file=os.path.join(HERE, "resnet_module.py"),
        train_steps=int(os.environ.get("RESNET_TRAIN_STEPS", "60")),
        hyperparameters={
            "depth": int(os.environ.get("RESNET_DEPTH", "50")),
            "num_classes": _n_classes(),
            "image_size": _image_size(),
            "batch_size": int(os.environ.get("RESNET_BATCH", "64")),
        },
    )
    evaluator = Evaluator(
        examples=gen.outputs["examples"],
        model=trainer.outputs["model"],
        label_key="label",
        problem="multiclass",
        batch_size=64,
    )
    return Pipeline(
        "resnet-imagenet", [gen, trainer, evaluator],
        pipeline_root=os.path.join(base, "root"),
        metadata_path=os.path.join(base, "metadata.sqlite"),
    )


if __name__ == "__main__":
    from tpu_pipelines_torch.orchestration import LocalDagRunner

    result = LocalDagRunner().run(create_pipeline())
    for node_id, nr in result.nodes.items():
        print(f"  {node_id}: {nr.status}")
