"""Chicago-Taxi pipeline on the port: the full canonical DAG over the
bundled taxi sample, the twin of ``examples/taxi/pipeline.py``.

    CsvExampleGen -> StatisticsGen -> SchemaGen -> ExampleValidator
      -> Transform -> Trainer -> Evaluator -> InfraValidator -> Pusher

Run it on the GPU::

    from tpu_pipelines_torch.orchestration import LocalDagRunner
    from tpu_pipelines_torch.examples.taxi_pipeline import create_pipeline
    LocalDagRunner(device="cuda").run(create_pipeline("/tmp/taxi"))

(``device="cpu"`` runs it on the CPU).  ``TAXI_DATA_CSV`` names the input
CSV (default: ``tests/testdata/taxi_sample.csv``), ``TAXI_TRAIN_STEPS``
and ``TAXI_BATCH`` the training budget (200 steps of 32).  Output lands
under ``base_dir``, else ``$TPP_PIPELINE_HOME``, else this directory's
``_taxi_run``.
"""

import os
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))


def _data_csv() -> str:
    return os.environ.get(
        "TAXI_DATA_CSV",
        os.path.join(REPO, "tests", "testdata", "taxi_sample.csv"),
    )


def create_pipeline(base_dir: str = "", data_csv: Optional[str] = None):
    from tpu_pipelines_torch.components import (
        CsvExampleGen,
        Evaluator,
        ExampleValidator,
        InfraValidator,
        Pusher,
        SchemaGen,
        StatisticsGen,
        Trainer,
        Transform,
    )
    from tpu_pipelines_torch.dsl.pipeline import Pipeline

    base = base_dir or os.environ.get(
        "TPP_PIPELINE_HOME", os.path.join(HERE, "_taxi_run")
    )
    gen = CsvExampleGen(input_path=data_csv or _data_csv())
    stats = StatisticsGen(examples=gen.outputs["examples"])
    schema = SchemaGen(statistics=stats.outputs["statistics"])
    validator = ExampleValidator(
        statistics=stats.outputs["statistics"],
        schema=schema.outputs["schema"],
    )
    transform = Transform(
        examples=gen.outputs["examples"],
        schema=schema.outputs["schema"],
        module_file=os.path.join(HERE, "taxi_preprocessing.py"),
    )
    trainer = Trainer(
        examples=transform.outputs["transformed_examples"],
        transform_graph=transform.outputs["transform_graph"],
        module_file=os.path.join(HERE, "taxi_module.py"),
        train_steps=int(os.environ.get("TAXI_TRAIN_STEPS", "200")),
        hyperparameters={"batch_size": int(os.environ.get("TAXI_BATCH", "32"))},
    )
    evaluator = Evaluator(
        examples=transform.outputs["transformed_examples"],
        model=trainer.outputs["model"],
        label_key="label_big_tip",
        slice_columns=["hour_bucket"],
        value_thresholds={"accuracy": {"lower_bound": 0.5}},
    )
    infra = InfraValidator(
        model=trainer.outputs["model"],
        examples=gen.outputs["examples"],
    )
    pusher = Pusher(
        model=trainer.outputs["model"],
        blessing=evaluator.outputs["blessing"],
        infra_blessing=infra.outputs["blessing"],
        push_destination=os.path.join(base, "serving", "taxi"),
    )
    return Pipeline(
        "chicago-taxi",
        [gen, stats, schema, validator, transform, trainer, evaluator,
         infra, pusher],
        pipeline_root=os.path.join(base, "root"),
        metadata_path=os.path.join(base, "metadata.sqlite"),
    )


if __name__ == "__main__":
    from tpu_pipelines_torch.orchestration import LocalDagRunner

    result = LocalDagRunner().run(create_pipeline())
    for node_id, nr in result.nodes.items():
        print(f"  {node_id}: {nr.status}")
