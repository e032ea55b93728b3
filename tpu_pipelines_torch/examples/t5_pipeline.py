"""T5-small seq2seq pipeline on the port (BASELINE configs[4]), the twin of
``examples/t5/pipeline.py``:

    CsvExampleGen -> StatisticsGen -> SchemaGen -> Transform (tokenize)
      -> Trainer -> BulkInferrer (beam search over the raw eval split)

Run it on the GPU::

    from tpu_pipelines_torch.orchestration import LocalDagRunner
    from tpu_pipelines_torch.examples.t5_pipeline import create_pipeline
    LocalDagRunner().run(create_pipeline("/tmp/t5"))

(``LocalDagRunner(device="cpu")`` runs it on the CPU, with ``T5_TINY=1``).
``T5_DATA_CSV`` (columns ``source,target``) supplies real pairs; otherwise
a tiny synthetic translation set is written.  ``T5_TRAIN_STEPS`` sets the
budget (100).  Output lands under ``base_dir``, else
``$TPP_PIPELINE_HOME``, else this directory's ``_t5_run``.
"""

import os

HERE = os.path.dirname(os.path.abspath(__file__))

T5_SMALL = {"batch_size": 64, "learning_rate": 1e-3,
            "beam_size": 4, "max_decode_len": 32}
T5_TINY = {
    "vocab_size": 128, "d_model": 32, "n_layers": 1, "n_heads": 2,
    "head_dim": 8, "d_ff": 32, "dropout_rate": 0.0,
    "batch_size": 8, "learning_rate": 3e-3,
    "beam_size": 2, "max_decode_len": 8,
}


def _ensure_data(base: str) -> str:
    given = os.environ.get("T5_DATA_CSV", "")
    if given:
        return given
    path = os.path.join(base, "pairs.csv")
    if not os.path.exists(path):
        os.makedirs(base, exist_ok=True)
        pairs = [("hello world", "bonjour monde"),
                 ("good day", "bonne journee"),
                 ("thank you", "merci"),
                 ("see you soon", "a bientot"),
                 ("good evening", "bonsoir"),
                 ("how are you", "comment allez vous")]
        rows = ["source,target"]
        for i in range(240):
            s, t = pairs[i % len(pairs)]
            rows.append(f'"{s}","{t}"')
        with open(path, "w") as f:
            f.write("\n".join(rows) + "\n")
    return path


def create_pipeline(base_dir: str = ""):
    from tpu_pipelines_torch.components import (
        BulkInferrer,
        CsvExampleGen,
        SchemaGen,
        StatisticsGen,
        Trainer,
        Transform,
    )
    from tpu_pipelines_torch.dsl.pipeline import Pipeline

    base = base_dir or os.environ.get(
        "TPP_PIPELINE_HOME", os.path.join(HERE, "_t5_run")
    )
    hp = T5_TINY if os.environ.get("T5_TINY") else T5_SMALL
    gen = CsvExampleGen(input_path=_ensure_data(base))
    stats = StatisticsGen(examples=gen.outputs["examples"])
    schema = SchemaGen(statistics=stats.outputs["statistics"])
    transform = Transform(
        examples=gen.outputs["examples"],
        schema=schema.outputs["schema"],
        module_file=os.path.join(HERE, "t5_preprocessing.py"),
    )
    trainer = Trainer(
        examples=transform.outputs["transformed_examples"],
        transform_graph=transform.outputs["transform_graph"],
        module_file=os.path.join(HERE, "t5_module.py"),
        train_steps=int(os.environ.get("T5_TRAIN_STEPS", "100")),
        hyperparameters=hp,
    )
    # Beam-search decoding over the raw examples through the payload's
    # embedded transform: the BulkInferrer "generate" path.
    inferrer = BulkInferrer(
        examples=gen.outputs["examples"],
        model=trainer.outputs["model"],
        predict_method="generate",
        data_splits=["eval"],
        batch_size=64,
    )
    return Pipeline(
        "t5-seq2seq", [gen, stats, schema, transform, trainer, inferrer],
        pipeline_root=os.path.join(base, "root"),
        metadata_path=os.path.join(base, "metadata.sqlite"),
    )


if __name__ == "__main__":
    from tpu_pipelines_torch.orchestration import LocalDagRunner

    result = LocalDagRunner().run(create_pipeline())
    for node_id, nr in result.nodes.items():
        print(f"  {node_id}: {nr.status}")
