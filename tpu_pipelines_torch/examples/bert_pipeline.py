"""BERT-base fine-tune pipeline on the port (BASELINE configs[3], the
north-star workload), the twin of ``examples/bert/pipeline.py``:

    CsvExampleGen -> StatisticsGen -> SchemaGen -> Transform (tokenize)
      -> Trainer -> Evaluator

Run it on the GPU::

    from tpu_pipelines_torch.orchestration import LocalDagRunner
    from tpu_pipelines_torch.examples.bert_pipeline import create_pipeline
    LocalDagRunner().run(create_pipeline("/tmp/bert"))

(``LocalDagRunner(device="cpu")`` runs it on the CPU, with ``BERT_TINY=1``
for a model small enough there).  With ``BERT_DATA_CSV`` (columns
``text,label``) this fine-tunes on real data; without it, a synthetic
sentiment set is written so the DAG runs out of the box.  Model geometry
defaults to BERT-base; ``BERT_TINY=1`` shrinks it, ``BERT_TRAIN_STEPS``
sets the budget (100).  Output lands under ``base_dir``, else
``$TPP_PIPELINE_HOME``, else this directory's ``_bert_run``.
"""

import os

HERE = os.path.dirname(os.path.abspath(__file__))

BERT_BASE = {"batch_size": 256, "learning_rate": 2e-5, "max_len": 128,
             "num_classes": 2}
BERT_TINY = {
    "vocab_size": 512, "d_model": 64, "n_layers": 2, "n_heads": 4,
    "d_ff": 128, "max_len": 64, "dropout_rate": 0.0, "num_classes": 2,
    "batch_size": 32, "learning_rate": 3e-3,
}


def _ensure_data(base: str) -> str:
    given = os.environ.get("BERT_DATA_CSV", "")
    if given:
        return given
    path = os.path.join(base, "reviews.csv")
    if not os.path.exists(path):
        import numpy as np

        os.makedirs(base, exist_ok=True)
        rng = np.random.default_rng(0)
        pos = ["great movie truly fun", "loved it wonderful film",
               "fun and wonderful", "truly great and fun"]
        neg = ["terrible boring mess", "awful waste dull",
               "boring and awful", "dull terrible film"]
        rows = ["text,label"]
        # Enough rows that the ~1/3 eval split clears BERT_BASE's batch of
        # 256 under drop_remainder.
        for i in range(1536):
            bank, label = (pos, 1) if i % 2 == 0 else (neg, 0)
            rows.append(f'"{bank[rng.integers(len(bank))]}",{label}')
        with open(path, "w") as f:
            f.write("\n".join(rows) + "\n")
    return path


def create_pipeline(base_dir: str = ""):
    from tpu_pipelines_torch.components import (
        CsvExampleGen,
        Evaluator,
        SchemaGen,
        StatisticsGen,
        Trainer,
        Transform,
    )
    from tpu_pipelines_torch.dsl.pipeline import Pipeline

    base = base_dir or os.environ.get(
        "TPP_PIPELINE_HOME", os.path.join(HERE, "_bert_run")
    )
    hp = BERT_TINY if os.environ.get("BERT_TINY") else BERT_BASE
    gen = CsvExampleGen(input_path=_ensure_data(base))
    stats = StatisticsGen(examples=gen.outputs["examples"])
    schema = SchemaGen(statistics=stats.outputs["statistics"])
    transform = Transform(
        examples=gen.outputs["examples"],
        schema=schema.outputs["schema"],
        module_file=os.path.join(HERE, "bert_preprocessing.py"),
    )
    trainer = Trainer(
        examples=transform.outputs["transformed_examples"],
        transform_graph=transform.outputs["transform_graph"],
        module_file=os.path.join(HERE, "bert_module.py"),
        train_steps=int(os.environ.get("BERT_TRAIN_STEPS", "100")),
        hyperparameters=hp,
    )
    evaluator = Evaluator(
        examples=transform.outputs["transformed_examples"],
        model=trainer.outputs["model"],
        label_key="label",
        problem="multiclass",  # 2-class logits head
        batch_size=int(hp["batch_size"]),
    )
    return Pipeline(
        "bert-finetune", [gen, stats, schema, transform, trainer, evaluator],
        pipeline_root=os.path.join(base, "root"),
        metadata_path=os.path.join(base, "metadata.sqlite"),
    )


if __name__ == "__main__":
    from tpu_pipelines_torch.orchestration import LocalDagRunner

    result = LocalDagRunner().run(create_pipeline())
    for node_id, nr in result.nodes.items():
        print(f"  {node_id}: {nr.status}")
