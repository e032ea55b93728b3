"""Port parity: the T5 pipeline twin, its payload's ``generate`` and the
port's BulkInferrer, against the JAX package on the CPU.

A seeded CSV of ``source,target`` pairs (commas and doubled quotes inside
quoted fields) goes through the reference pipeline's nodes up to its
Transform (the reference's tokenizing transform graph), and a tiny T5
(``T5_TINY`` of the reference pipeline) initialised by JAX is exported as
a reference payload with that graph, then converted into a port payload
(``t5_state_dict_from_flax``, the same graph).  Both payloads compute in
bf16 and decode by beam search; the port's tokens must equal the
reference's token for token (as ``tests/test_torch_t5_serving.py`` holds
them).  The port's own DAG runs once per module with ``T5_TINY=1``.
"""

import contextlib
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from tpu_pipelines.components.bulk_inferrer import BulkInferrer as RefBulkInferrer
from tpu_pipelines.data import examples_io as ref_io
from tpu_pipelines.dsl.component import ExecutorContext as RefContext
from tpu_pipelines.dsl.pipeline import Pipeline as RefPipeline
from tpu_pipelines.metadata.types import Artifact as RefArtifact
from tpu_pipelines.models.t5 import build_t5_model as ref_build_t5
from tpu_pipelines.orchestration import LocalDagRunner as RefRunner
from tpu_pipelines.trainer.export import export_model as ref_export
from tpu_pipelines.trainer.export import load_exported_model as ref_load
from tpu_pipelines_torch.components.bulk_inferrer import (
    BulkInferrer,
    _shard_batches,
)
from tpu_pipelines_torch.data import examples_io as port_io
from tpu_pipelines_torch.dsl.component import ExecutorContext
from tpu_pipelines_torch.examples import t5_module, t5_pipeline
from tpu_pipelines_torch.metadata.types import Artifact
from tpu_pipelines_torch.models.convert import t5_state_dict_from_flax
from tpu_pipelines_torch.orchestration import LocalDagRunner
from tpu_pipelines_torch.trainer.export import export_model, load_exported_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PIPELINE = os.path.join(REPO, "examples", "t5", "pipeline.py")
REF_MODULE = os.path.join(REPO, "examples", "t5", "t5_trainer_module.py")
PORT_MODULE = os.path.join(REPO, "tpu_pipelines_torch", "examples",
                           "t5_module.py")
ROWS = 96
STEPS = "4"
# loss_fn against the reference formula on the same f32 logits, and Adam
# against optax.adam: f32 math whose sums the two frameworks order
# differently.
F32_TOL = dict(rtol=1e-6, atol=1e-6)


@contextlib.contextmanager
def _env(**values):
    with pytest.MonkeyPatch.context() as mp:
        for k, v in values.items():
            mp.setenv(k, v)
        yield


def _uris(result):
    return {node: {key: arts[0].uri for key, arts in nr.outputs.items()}
            for node, nr in result.nodes.items()}


def _pairs_csv(path, seed=0, rows=ROWS):
    """Seeded ``source,target`` pairs: sources of 3-8 words, the target the
    first four of them reversed and upper-cased; some sources carry a comma
    or a doubled quote inside their quoted field."""
    rng = np.random.default_rng(seed)
    lexicon = [f"w{i}" for i in range(24)] + ["hello", "world", "good", "day"]
    lines = ["source,target"]
    for i in range(rows):
        words = [lexicon[j] for j in rng.integers(0, len(lexicon),
                                                   int(rng.integers(3, 9)))]
        source = " ".join(words)
        target = " ".join(w.upper() for w in words[::-1][:4])
        if i % 7 == 0:
            source = source.replace(" ", ", ", 1)
        if i % 11 == 0:
            source = f'say ""{source}""'
        lines.append(f'"{source}","{target}"')
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


def _ref_pipeline_module():
    spec = importlib.util.spec_from_file_location("ref_t5_pipeline", REF_PIPELINE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    base = tmp_path_factory.mktemp("t5data")
    return _pairs_csv(base / "pairs.csv")


@pytest.fixture(scope="module")
def ref_run(data, tmp_path_factory):
    """The reference pipeline's nodes up to its Transform."""
    base = tmp_path_factory.mktemp("ref")
    module = _ref_pipeline_module()
    with _env(T5_TINY="1", T5_DATA_CSV=data, TPP_TRACE="0",
              TPP_DATA_SHARDS="2"):
        full = module.create_pipeline(str(base))
        ids = ("CsvExampleGen", "StatisticsGen", "SchemaGen", "Transform")
        pipe = RefPipeline(full.name, [c for c in full.components if c.id in ids],
                           pipeline_root=full.pipeline_root,
                           metadata_path=full.metadata_path)
        result = RefRunner().run(pipe)
    return _uris(result), dict(module.T5_TINY)


@pytest.fixture(scope="module")
def payloads(ref_run, tmp_path_factory):
    """(reference payload, port payload, port payload without the graph):
    one tiny T5 initialised by JAX, the reference's transform graph."""
    uris, hp = ref_run
    graph = uris["Transform"]["transform_graph"]
    model = ref_build_t5(hp)
    batch = {"inputs": np.arange(12, dtype=np.int32).reshape(2, 6) % 13 + 2,
             "targets": np.ones((2, 5), np.int32)}
    params = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.key(0), batch)["params"])
    base = tmp_path_factory.mktemp("payloads")
    ref_dir = ref_export(
        serving_model_dir=str(base / "ref"), params=params,
        module_file=REF_MODULE, hyperparameters=hp,
        transform_graph_uri=graph, extra_spec={"label": "targets"})
    state = t5_state_dict_from_flax(params)
    port_dir = export_model(
        serving_model_dir=str(base / "port"), params=state,
        module_file=PORT_MODULE, hyperparameters=hp,
        transform_graph_uri=graph, extra_spec={"label": "targets"})
    plain_dir = export_model(
        serving_model_dir=str(base / "plain"), params=state,
        module_file=PORT_MODULE, hyperparameters=hp)
    return ref_dir, port_dir, plain_dir


@pytest.fixture(scope="module")
def port_runs(data, tmp_path_factory):
    base = tmp_path_factory.mktemp("port")
    with _env(T5_TINY="1", T5_DATA_CSV=data, T5_TRAIN_STEPS=STEPS,
              TPP_DATA_SHARDS="2"):
        cold = LocalDagRunner(device="cpu").run(
            t5_pipeline.create_pipeline(str(base)))
        warm = LocalDagRunner(device="cpu").run(
            t5_pipeline.create_pipeline(str(base)))
    return cold, warm


def test_generate_applies_the_embedded_transform(ref_run, payloads):
    uris, hp = ref_run
    ref_dir, port_dir, plain_dir = payloads
    raw = ref_io.read_split(uris["CsvExampleGen"]["examples"], "eval")
    want = np.asarray(ref_load(ref_dir).generate(raw))
    loaded = load_exported_model(port_dir, device="cpu")
    assert loaded.transform is not None
    got = loaded.generate(raw)
    rows = len(raw["source"])
    assert got.shape == want.shape == (rows, hp["max_decode_len"])
    np.testing.assert_array_equal(got, want)
    # The same weights without the graph, fed the reference Transform's
    # materialised columns.
    columns = ref_io.read_split(uris["Transform"]["transformed_examples"],
                                "eval")
    plain = load_exported_model(plain_dir, device="cpu").generate(columns)
    np.testing.assert_array_equal(got, plain)


def _port_context(tmp_path, examples_uri, model_uri, blessing_uri=None,
                  **params):
    props = {k: p.default for k, p in BulkInferrer.SPEC.parameters.items()}
    props.update(params)
    inputs = {"examples": [Artifact("Examples", examples_uri)],
              "model": [Artifact("Model", model_uri)]}
    if blessing_uri is not None:
        inputs["model_blessing"] = [Artifact("ModelBlessing", blessing_uri)]
    out = Artifact(type_name="InferenceResult", uri=str(tmp_path / "out"))
    return ExecutorContext(
        node_id="BulkInferrer", inputs=inputs,
        outputs={"inference_result": [out]}, exec_properties=props,
        extras={"device": "cpu"},
    ), out


def test_bulk_inferrer_matches_the_reference_in_row_order(
        ref_run, payloads, port_runs, tmp_path):
    uris, _ = ref_run
    ref_dir, port_dir, _ = payloads
    params = {"predict_method": "generate", "data_splits": ["eval"],
              "batch_size": 8}
    ref_props = {k: p.default for k, p in RefBulkInferrer.SPEC.parameters.items()}
    ref_props.update(params)
    ref_out = RefArtifact(type_name="InferenceResult", uri=str(tmp_path / "ref"))
    RefBulkInferrer.EXECUTOR(RefContext(
        node_id="BulkInferrer",
        inputs={"examples": [RefArtifact("Examples",
                                         uris["CsvExampleGen"]["examples"])],
                "model": [RefArtifact("Model", ref_dir)]},
        outputs={"inference_result": [ref_out]}, exec_properties=ref_props,
    ))
    want = ref_io.read_split(ref_out.uri, "eval")["prediction"]

    port_examples = _uris(port_runs[0])["CsvExampleGen"]["examples"]
    ctx, out = _port_context(tmp_path, port_examples, port_dir,
                             passthrough_columns=["source"], **params)
    props = BulkInferrer.EXECUTOR(ctx)
    got = port_io.read_split(out.uri, "eval")
    raw = port_io.read_split(port_examples, "eval")
    assert props["num_predictions"] == len(raw["source"]) == len(want)
    assert props["projected_columns"] == ["source", "target"]
    assert out.properties["split_names"] == ["eval"]
    assert got["prediction"].dtype.kind == "i"
    np.testing.assert_array_equal(got["prediction"], want)
    assert got["source"].tolist() == raw["source"].tolist()


def test_bulk_inferrer_is_skipped_when_the_model_is_not_blessed(
        payloads, port_runs, tmp_path):
    blessing = tmp_path / "blessing"
    blessing.mkdir()
    (blessing / "NOT_BLESSED").write_text("{}")
    examples = _uris(port_runs[0])["CsvExampleGen"]["examples"]
    ctx, out = _port_context(tmp_path, examples, payloads[1], str(blessing),
                             predict_method="generate")
    assert BulkInferrer.EXECUTOR(ctx) == {"skipped": True,
                                          "reason": "model not blessed"}
    assert out.properties["skipped"] is True
    assert not os.path.exists(out.uri)


def test_generate_on_transformed_examples_is_refused(payloads, port_runs,
                                                     tmp_path):
    uris = _uris(port_runs[0])
    ctx, _ = _port_context(tmp_path, uris["Transform"]["transformed_examples"],
                           payloads[1], predict_method="generate",
                           raw_examples=False)
    with pytest.raises(ValueError, match="consumes RAW examples"):
        BulkInferrer.EXECUTOR(ctx)
    ctx, _ = _port_context(tmp_path, uris["CsvExampleGen"]["examples"],
                           payloads[1], predict_method="sample")
    with pytest.raises(ValueError, match="'forward' or 'generate'"):
        BulkInferrer.EXECUTOR(ctx)


def test_an_empty_split_is_omitted(payloads, port_runs, tmp_path):
    raw = port_io.read_split(_uris(port_runs[0])["CsvExampleGen"]["examples"],
                             "eval")
    examples = str(tmp_path / "examples")
    port_io.write_split(examples, "eval", {k: v[:5].astype(str)
                                           for k, v in raw.items()})
    port_io.write_split(examples, "train", {k: v[:0].astype(str)
                                            for k, v in raw.items()},
                        num_shards=2)
    ctx, out = _port_context(tmp_path, examples, payloads[1],
                             predict_method="generate", batch_size=2)
    props = BulkInferrer.EXECUTOR(ctx)
    assert props["num_predictions"] == 5
    assert out.properties["split_names"] == ["eval"]
    assert port_io.split_names(out.uri) == ["eval"]


def test_shard_batches_keep_row_order_and_the_remainder(tmp_path):
    uri = str(tmp_path / "ex")
    port_io.write_split(uri, "eval", {"x": np.arange(23)}, num_shards=2)
    batches = [list(b["x"]) for shard in range(2)
               for b in _shard_batches(uri, "eval", shard, 5, None)]
    assert [len(b) for b in batches] == [5, 5, 2, 5, 5, 1]
    assert sum(batches, []) == list(range(23))


def test_port_dag_infers_every_eval_row_and_reruns_cached(port_runs):
    cold, warm = port_runs
    assert list(cold.nodes) == ["CsvExampleGen", "StatisticsGen", "SchemaGen",
                                "Transform", "Trainer", "BulkInferrer"]
    assert {nr.status for nr in cold.nodes.values()} == {"COMPLETE"}
    assert {nr.status for nr in warm.nodes.values()} == {"CACHED"}
    uris = _uris(cold)
    raw = port_io.read_split(uris["CsvExampleGen"]["examples"], "eval")
    got = port_io.read_split(uris["BulkInferrer"]["inference_result"], "eval")
    tiny = t5_pipeline.T5_TINY
    assert got["prediction"].shape == (len(raw["source"]),
                                       tiny["max_decode_len"])
    assert got["prediction"].dtype.kind == "i"
    spec = load_exported_model(uris["Trainer"]["model"], device="cpu").spec
    assert spec["has_transform"] and spec["label"] == "targets"


def test_loss_fn_matches_the_reference_formula():
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(3)
    logits = rng.normal(size=(3, 5, 11)).astype(np.float32)
    targets = rng.integers(0, 11, size=(3, 5)).astype(np.int32)
    targets[:, 3:] = 0
    for mask in (None, (targets > 0).astype(np.float32)):
        batch = {"targets": torch.from_numpy(targets)}
        ref_mask = jnp.asarray(targets > 0, jnp.float32)
        if mask is not None:
            batch["target_mask"] = torch.from_numpy(mask)
            ref_mask = jnp.asarray(mask)
        per_tok = optax.softmax_cross_entropy_with_integer_labels(
            jnp.asarray(logits), jnp.asarray(targets))
        want = float((per_tok * ref_mask).sum()
                     / jnp.maximum(ref_mask.sum(), 1.0))
        got, metrics = t5_module.loss_fn(
            lambda b, generator: torch.from_numpy(logits), batch, None)
        assert metrics == {}
        np.testing.assert_allclose(float(got), want, **F32_TOL)


def test_adam_matches_optax_adam():
    import optax

    rng = np.random.default_rng(4)
    w0 = rng.normal(size=(4, 3)).astype(np.float32)
    grads = [rng.normal(size=(4, 3)).astype(np.float32) for _ in range(3)]
    opt = optax.adam(1e-2)
    w, state = w0, opt.init(w0)
    for g in grads:
        updates, state = opt.update(g, state, w)
        w = optax.apply_updates(w, updates)
    param = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    torch_opt = t5_module.adam(1e-2)([param])
    for g in grads:
        param.grad = torch.from_numpy(g)
        torch_opt.step()
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(w),
                               **F32_TOL)
