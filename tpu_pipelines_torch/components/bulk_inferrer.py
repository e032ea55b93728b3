"""BulkInferrer: batch inference over an Examples artifact on the runner's
device.

The port's copy of ``tpu_pipelines/components/bulk_inferrer.py`` (TFX
BulkInferrer): raw examples go through the payload's embedded
TransformGraph (host string stage, then the torch evaluator on the device)
and the model's forward pass, or its beam-search ``generate`` for seq2seq
payloads, batch by batch, with the payload loaded on
``ctx.extras["device"]``.  Predictions are written as an InferenceResult
artifact of ``.npz`` shards (one output shard per input shard, rows in
input order), joined with any requested passthrough columns.
"""

from __future__ import annotations

import logging
import threading

import numpy as np

from tpu_pipelines_torch.data import examples_io
from tpu_pipelines_torch.data.shard_plan import thread_map
from tpu_pipelines_torch.dsl.component import Parameter, component
from tpu_pipelines_torch.trainer.export import (
    load_exported_model,
    model_input_columns,
)


def _shard_batches(uri, split, shard, batch_size, columns):
    """Fixed-size dict-of-numpy batches over one shard, order preserved,
    remainder kept (the shuffle-free single-epoch read BulkInferrer needs,
    without materializing the shard)."""
    pending = None
    for chunk in examples_io.iter_column_chunks(
        uri, split, columns=columns, shards=[shard]
    ):
        pending = chunk if pending is None else {
            k: np.concatenate([pending[k], chunk[k]]) for k in pending
        }
        n = len(next(iter(pending.values())))
        start = 0
        while n - start >= batch_size:
            yield {k: v[start:start + batch_size] for k, v in pending.items()}
            start += batch_size
        if start:
            pending = {k: v[start:] for k, v in pending.items()}
    if pending is not None and len(next(iter(pending.values()))):
        yield pending


@component(
    inputs={
        "examples": "Examples",
        "model": "Model",
        "model_blessing": "ModelBlessing",
    },
    optional_inputs=("model_blessing",),
    outputs={"inference_result": "InferenceResult"},
    parameters={
        "data_splits": Parameter(type=list, default=None),  # None = all
        "batch_size": Parameter(type=int, default=1024),
        # Raw columns copied next to predictions (join keys, ids).
        "passthrough_columns": Parameter(type=list, default=None),
        # Examples are raw (apply embedded transform) vs pre-transformed.
        "raw_examples": Parameter(type=bool, default=True),
        # "forward": the model's forward pass (classification/regression).
        # "generate": autoregressive decoding for seq2seq models — requires
        # the exported module to define make_generate_step (or the legacy
        # make_generate_fn).
        "predict_method": Parameter(type=str, default="forward"),
    },
    resource_class="tpu",
    is_sink=True,
)
def BulkInferrer(ctx):
    from tpu_pipelines_torch.components.evaluator import is_blessed

    out = ctx.output("inference_result")
    if ctx.inputs.get("model_blessing") and not is_blessed(
        ctx.input("model_blessing").uri
    ):
        out.properties["skipped"] = True
        return {"skipped": True, "reason": "model not blessed"}

    loaded = load_exported_model(
        ctx.input("model").uri, device=ctx.extras.get("device", "cuda"))
    method = ctx.exec_properties["predict_method"]
    if method == "generate":
        if loaded.generate is None:
            raise ValueError(
                "predict_method='generate' but the exported module defines "
                "no make_generate_step(model, hyperparameters) (or legacy "
                "make_generate_fn)"
            )
        if not ctx.exec_properties["raw_examples"] and loaded.transform:
            # loaded.generate runs the embedded transform; feeding it
            # already-transformed examples would tokenize them twice.
            raise ValueError(
                "predict_method='generate' consumes RAW examples (the "
                "embedded transform is applied inside generate); wire the "
                "ExampleGen output, not transformed_examples"
            )
        predict = loaded.generate
    elif method == "forward":
        predict = (
            loaded.predict if ctx.exec_properties["raw_examples"]
            else loaded.predict_transformed
        )
    else:
        raise ValueError(
            f"predict_method must be 'forward' or 'generate', got {method!r}"
        )
    examples_uri = ctx.input("examples").uri
    splits = ctx.exec_properties["data_splits"] or examples_io.split_names(
        examples_uri
    )
    passthrough = ctx.exec_properties["passthrough_columns"] or []
    batch_size = ctx.exec_properties["batch_size"]

    # Column projection: decode only what the predict path + passthrough
    # actually consume (None = unknown model surface, read everything).
    columns = model_input_columns(
        loaded, raw=(
            method == "generate" or ctx.exec_properties["raw_examples"]
        ),
    )
    if columns is not None:
        columns = sorted(set(columns) | set(passthrough))

    # One device call at a time, as the server runs its whole-request
    # decodes: the port's predict and generate are eager loops driven from
    # the host, and calls side by side only contend for the interpreter.
    # Host decode and encode of the other shards still overlap them.
    device_lock = threading.Lock()

    def infer_shard(task):
        """One shard in, one predictions shard out, in row order."""
        split, shard, n_shards = task
        writer = None
        schema = None
        n_preds = 0
        try:
            for batch in _shard_batches(
                examples_uri, split, shard, batch_size, columns
            ):
                with device_lock:
                    preds = np.asarray(predict(batch))
                cols = {}
                for c in passthrough:
                    if c not in batch:
                        raise KeyError(
                            f"passthrough column {c!r} not in split {split!r}"
                        )
                    cols[c] = batch[c]
                if preds.ndim == 1:
                    cols["prediction"] = preds
                else:
                    cols["prediction"] = preds.reshape(len(preds), -1)
                table = examples_io.table_from_columns(cols)
                if writer is None:
                    schema = table
                    writer = examples_io.open_split_writer(
                        out.uri, split, schema,
                        shard=shard, num_shards=n_shards,
                    )
                writer.write_table(table)
                n_preds += len(preds)
        finally:
            if writer is not None:
                writer.close()
        return n_preds, schema

    total = 0
    written_splits = set(splits)
    for split in splits:
        n_shards = examples_io.num_split_shards(examples_uri, split)
        results = thread_map(
            infer_shard,
            [(split, shard, n_shards) for shard in range(n_shards)],
        )
        schemas = [s for _, s in results if s is not None]
        if not schemas:
            # Zero batches (the hash split left this split empty): no file
            # was written, so the split is dropped from the artifact's
            # listing rather than published for downstream reads to miss.
            logging.getLogger(__name__).warning(
                "BulkInferrer: split %r empty; omitted from output", split
            )
            written_splits.discard(split)
        else:
            for shard, (n, schema) in enumerate(results):
                if schema is None:  # backfill: complete shard set
                    examples_io.open_split_writer(
                        out.uri, split, schemas[0],
                        shard=shard, num_shards=n_shards,
                    ).close()
        total += sum(n for n, _ in results)
    out.properties["num_predictions"] = total
    out.properties["split_names"] = sorted(written_splits)
    return {"num_predictions": total, "projected_columns": columns}
