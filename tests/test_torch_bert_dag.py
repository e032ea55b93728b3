"""Port parity: the BERT pipeline twin against the JAX package, on the CPU.

A seeded CSV of about 120 ``text,label`` reviews (commas and doubled
quotes inside quoted fields) goes through the reference pipeline's nodes
up to its Transform, and through the port's whole DAG, once per module,
at the reference test's tiny hyperparameters
(``tests/test_tokenize_and_bert_pipeline.py``) with ``attn_impl "flash"``
and 25 steps.  Then:

  - the twins compile to DAGs of the same shape;
  - split membership, the learned vocabulary and the tokenized columns
    are equal bit for bit;
  - a tiny BERT initialised by JAX, exported by the reference with its
    tokenizing graph and converted (``bert_state_dict_from_flax``), gives
    the reference's ``predict(raw)`` logits within BF16_TOL through the
    port's payload, and the reference Evaluator's loss and accuracy through
    the port's ``evaluate_payload`` (bounds derived from BF16_TOL);
  - the port DAG trains (25 steps, finite losses, positive and negative
    reviews separated), its flash attention is reached from inside the
    runner (the kernels' plain versions, counted as launches would be),
    and a rerun is all cache hits;
  - ``warm_start_init`` restores a base model wired from an earlier
    Trainer and refuses one of another geometry, naming the paths.
"""

import contextlib
import functools
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from tpu_pipelines.components.evaluator import evaluate_payload as ref_evaluate
from tpu_pipelines.data import examples_io as ref_io
from tpu_pipelines.dsl.compiler import Compiler as RefCompiler
from tpu_pipelines.dsl.pipeline import Pipeline as RefPipeline
from tpu_pipelines.models.bert import build_bert_model as ref_build_bert
from tpu_pipelines.orchestration import LocalDagRunner as RefRunner
from tpu_pipelines.trainer.export import export_model as ref_export
from tpu_pipelines.trainer.export import load_exported_model as ref_load
from tpu_pipelines_torch.components import Trainer
from tpu_pipelines_torch.components.evaluator import evaluate_payload
from tpu_pipelines_torch.data import examples_io as port_io
from tpu_pipelines_torch.dsl.compiler import Compiler
from tpu_pipelines_torch.dsl.pipeline import Pipeline
from tpu_pipelines_torch.examples import bert_module, bert_pipeline
from tpu_pipelines_torch.metadata import open_store
from tpu_pipelines_torch.models.convert import bert_state_dict_from_flax
from tpu_pipelines_torch.ops import flash_attention as fa
from tpu_pipelines_torch.orchestration import LocalDagRunner
from tpu_pipelines_torch.trainer.export import (
    export_model,
    load_exported_model,
    warm_start_init,
)
from tpu_pipelines_torch.trainer.fn_args import FnArgs
from tpu_pipelines_torch.transform.graph import TransformGraph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PIPELINE = os.path.join(REPO, "examples", "bert", "pipeline.py")
REF_MODULE = os.path.join(REPO, "examples", "bert", "bert_trainer_module.py")
PORT_MODULE = os.path.join(REPO, "tpu_pipelines_torch", "examples",
                           "bert_module.py")
ROWS = 120
STEPS = 25
# tests/test_tokenize_and_bert_pipeline.py's tiny BERT.
HP = {"vocab_size": 256, "d_model": 32, "n_layers": 2, "n_heads": 4,
      "d_ff": 64, "max_len": 64, "dropout_rate": 0.0, "num_classes": 2,
      "batch_size": 32, "learning_rate": 3e-3}
# Payload logits, port against reference: both compute in bf16 and round
# at different places (tests/test_torch_serving.py's bound for logits of
# magnitude ~1).  Cross-entropy moves by at most 2 x the largest logit
# change, so the Evaluator's loss is held to 2 x BF16_TOL, and its accuracy
# may differ only by rows whose reference margin is under 2 x BF16_TOL.
BF16_TOL = 5e-2


@contextlib.contextmanager
def _env(**values):
    with pytest.MonkeyPatch.context() as mp:
        for k, v in values.items():
            mp.setenv(k, v)
        yield


def _uris(result):
    return {node: {key: arts[0].uri for key, arts in nr.outputs.items()}
            for node, nr in result.nodes.items()}


def _reviews_csv(path, seed=0, rows=ROWS):
    """Seeded reviews: two sentiment words of the row's label among 2-7
    filler words; some carry a comma or a doubled quote inside the field."""
    rng = np.random.default_rng(seed)
    positive = ["great", "fun", "wonderful", "loved", "truly"]
    negative = ["terrible", "boring", "awful", "dull", "mess"]
    filler = ["the", "movie", "film", "plot", "and", "it", "was", "a"]
    lines = ["text,label"]
    for i in range(rows):
        label = i % 2
        words = [filler[j] for j in rng.integers(0, len(filler),
                                                  int(rng.integers(2, 8)))]
        for w in rng.choice(positive if label else negative, 2):
            words.insert(int(rng.integers(0, len(words) + 1)), str(w))
        text = " ".join(words)
        if i % 5 == 0:
            text = text.replace(" ", ", ", 1)
        if i % 9 == 0:
            text = f'he said ""{text}""'
        lines.append(f'"{text}",{label}')
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


def _ref_pipeline_module():
    spec = importlib.util.spec_from_file_location("ref_bert_pipeline",
                                                  REF_PIPELINE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _node(pipeline, node_id):
    return next(c for c in pipeline.components if c.id == node_id)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return _reviews_csv(tmp_path_factory.mktemp("bertdata") / "reviews.csv")


@pytest.fixture(scope="module")
def ref_run(data, tmp_path_factory):
    """The reference pipeline's nodes up to its Transform."""
    base = tmp_path_factory.mktemp("ref")
    with _env(BERT_TINY="1", BERT_DATA_CSV=data, TPP_TRACE="0",
              TPP_DATA_SHARDS="2"):
        full = _ref_pipeline_module().create_pipeline(str(base))
        ids = ("CsvExampleGen", "StatisticsGen", "SchemaGen", "Transform")
        pipe = RefPipeline(full.name, [c for c in full.components if c.id in ids],
                           pipeline_root=full.pipeline_root,
                           metadata_path=full.metadata_path)
        return _uris(RefRunner().run(pipe))


def _counting(name, plain):
    """On CPU tensors a wrapper runs its kernel's plain version and counts
    nothing; here each plain version counts as its kernel's launch would."""
    def counted(*args, **kwargs):
        fa._count(name, capturing=False)
        return plain(*args, **kwargs)
    return counted


def _port_pipeline(data, base, hp):
    with _env(BERT_TINY="1", BERT_DATA_CSV=data, BERT_TRAIN_STEPS=str(STEPS),
              TPP_DATA_SHARDS="2"):
        pipe = bert_pipeline.create_pipeline(base)
    _node(pipe, "Trainer").exec_properties["hyperparameters"] = hp
    return pipe


@pytest.fixture(scope="module")
def port_runs(data, tmp_path_factory):
    """The port's DAG, cold and warm."""
    base = str(tmp_path_factory.mktemp("port"))
    cold = LocalDagRunner(device="cpu").run(_port_pipeline(data, base, HP))
    warm = LocalDagRunner(device="cpu").run(_port_pipeline(data, base, HP))
    return cold, warm, base


@pytest.fixture(scope="module")
def flash_run(data, port_runs):
    """The same DAG with flash attention (two heads of 16: the kernels take
    head_dim 16 to 128) and its kernels' plain versions counted: only the
    Trainer and the Evaluator run again."""
    before = {name: getattr(fa, name) for name in fa.COUNTERS}
    with pytest.MonkeyPatch.context() as mp:
        for attr, name in (("flash_attention_reference", "launches"),
                           ("_dvec", "dvec_launches"),
                           ("flash_bwd_dq_reference", "dq_launches"),
                           ("flash_bwd_dkv_reference", "dkv_launches")):
            mp.setattr(fa, attr, _counting(name, getattr(fa, attr)))
        result = LocalDagRunner(device="cpu").run(_port_pipeline(
            data, port_runs[2], {**HP, "n_heads": 2, "attn_impl": "flash"}))
    return result, {name: getattr(fa, name) - before[name]
                    for name in fa.COUNTERS}


def test_compiled_dags_have_the_same_shape(tmp_path):
    with _env(BERT_DATA_CSV=str(tmp_path / "x.csv")):
        ref_ir = RefCompiler().compile(
            _ref_pipeline_module().create_pipeline(str(tmp_path)))
        port_ir = Compiler().compile(bert_pipeline.create_pipeline(str(tmp_path)))
    shape = lambda ir: [(n.id, n.component_type, n.upstream, n.resource_class,
                         sorted(n.exec_properties)) for n in ir.nodes]
    assert shape(port_ir) == shape(ref_ir)
    assert bert_pipeline.BERT_BASE == _ref_pipeline_module().BERT_BASE


def test_splits_vocabulary_and_tokenized_columns_are_identical(ref_run,
                                                               port_runs):
    port = _uris(port_runs[0])
    for split in ("train", "eval"):
        want = ref_io.read_split(ref_run["CsvExampleGen"]["examples"], split)
        got = port_io.read_split(port["CsvExampleGen"]["examples"], split)
        assert sorted(got) == sorted(want)
        for name in want:
            assert np.asarray(got[name]).tolist() == want[name].tolist(), name
    ref_graph = TransformGraph.load(ref_run["Transform"]["transform_graph"])
    port_graph = TransformGraph.load(port["Transform"]["transform_graph"])
    assert port_graph.tokenizer_vocab_sizes() == ref_graph.tokenizer_vocab_sizes()
    for nid, state in ref_graph.state.items():
        if "vocab" in state:
            assert list(port_graph.state[nid]["vocab"]) == list(state["vocab"])
    for split in ("train", "eval"):
        want = ref_io.read_split(ref_run["Transform"]["transformed_examples"],
                                 split)
        got = port_io.read_split(port["Transform"]["transformed_examples"],
                                 split)
        assert sorted(got) == sorted(want) == ["attention_mask", "input_ids",
                                               "label"]
        for name in want:
            # The reference reads a vector column back through Arrow's
            # Python lists, as int64; the port keeps the graph's int32.
            assert got[name].dtype.kind == want[name].dtype.kind, name
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.fixture(scope="module")
def payloads(ref_run, tmp_path_factory):
    """(reference payload, port payload): a tiny BERT initialised by JAX
    with the reference's tokenizing graph."""
    graph = ref_run["Transform"]["transform_graph"]
    model = ref_build_bert(HP)
    sample = {"input_ids": np.ones((2, 8), np.int32),
              "attention_mask": np.ones((2, 8), np.int32)}
    params = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.key(0), sample)["params"])
    base = tmp_path_factory.mktemp("payloads")
    ref_dir = ref_export(serving_model_dir=str(base / "ref"), params=params,
                         module_file=REF_MODULE, hyperparameters=HP,
                         transform_graph_uri=graph, extra_spec={"label": "label"})
    port_dir = export_model(serving_model_dir=str(base / "port"),
                            params=bert_state_dict_from_flax(params),
                            module_file=PORT_MODULE, hyperparameters=HP,
                            transform_graph_uri=graph,
                            extra_spec={"label": "label"})
    return ref_dir, port_dir


def test_reference_payload_predicts_and_evaluates_through_the_port(
        ref_run, port_runs, payloads):
    ref_dir, port_dir = payloads
    raw = ref_io.read_split(ref_run["CsvExampleGen"]["examples"], "eval")
    want = np.asarray(ref_load(ref_dir).predict(raw))
    got = load_exported_model(port_dir, device="cpu").predict(raw)
    assert got.shape == want.shape == (len(raw["text"]), 2)
    assert np.abs(want).max() > 10 * BF16_TOL     # logits that say something
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_TOL)

    props = {"label_key": "label", "eval_split": "eval", "batch_size": 32,
             "slice_columns": None, "problem": "multiclass"}
    ref_metrics = ref_evaluate(ref_dir, ref_run["Transform"][
        "transformed_examples"], props).overall()
    port_metrics = evaluate_payload(port_dir, _uris(port_runs[0])["Transform"][
        "transformed_examples"], props, device="cpu").overall()
    assert port_metrics.num_examples == ref_metrics.num_examples == len(want)
    assert abs(port_metrics.metrics["loss"] - ref_metrics.metrics["loss"]) <= (
        2 * BF16_TOL)
    margin = np.abs(want[:, 1] - want[:, 0])
    near = int(np.sum(margin < 2 * BF16_TOL))
    assert abs(port_metrics.metrics["accuracy"]
               - ref_metrics.metrics["accuracy"]) * len(want) <= near


def test_port_dag_trains_separates_reviews_and_reruns_cached(port_runs):
    cold, warm, base = port_runs
    assert list(cold.nodes) == ["CsvExampleGen", "StatisticsGen", "SchemaGen",
                                "Transform", "Trainer", "Evaluator"]
    assert {nr.status for nr in cold.nodes.values()} == {"COMPLETE"}
    assert {nr.status for nr in warm.nodes.values()} == {"CACHED"}
    store = open_store(os.path.join(base, "metadata.sqlite"))
    try:
        props = store.get_execution(cold.nodes["Trainer"].execution_id).properties
    finally:
        store.close()
    assert props["steps_completed"] == STEPS
    assert np.isfinite(props["final_loss"]) and np.isfinite(
        props["final_eval_loss"])
    loaded = load_exported_model(_uris(cold)["Trainer"]["model"], device="cpu")
    assert loaded.spec["label"] == "label" and loaded.spec["has_transform"]
    raw = {"text": np.asarray(["truly wonderful fun film", "awful boring mess"],
                              dtype=object), "label": np.zeros(2, np.int64)}
    logits = loaded.predict(raw)
    assert logits.shape == (2, 2)
    assert logits[0, 1] > logits[0, 0]   # positive review
    assert logits[1, 0] > logits[1, 1]   # negative review


def test_flash_attention_is_reached_from_inside_the_runner(flash_run):
    result, counts = flash_run
    assert {k: nr.status for k, nr in result.nodes.items()} == {
        "CsvExampleGen": "CACHED", "StatisticsGen": "CACHED",
        "SchemaGen": "CACHED", "Transform": "CACHED",
        "Trainer": "COMPLETE", "Evaluator": "COMPLETE"}
    uris = _uris(result)
    n_eval = port_io.num_rows(uris["Transform"]["transformed_examples"], "eval")
    layers, batch = HP["n_layers"], HP["batch_size"]
    # Training steps, the Trainer's end-of-run eval (drop_remainder) and
    # the Evaluator (every row); the backward only in the steps.
    forwards = STEPS + n_eval // batch + -(-n_eval // batch)
    assert counts == {"launches": layers * forwards,
                      "dvec_launches": layers * STEPS,
                      "dq_launches": layers * STEPS,
                      "dkv_launches": layers * STEPS,
                      "decode_launches": 0}


def test_warm_start_restores_a_wired_base_model_and_refuses_a_mismatch(
        data, port_runs):
    cold, _, base = port_runs
    uris = _uris(cold)
    # A second Trainer wired to the first one's model, at learning rate 0:
    # its payload is the base model's weights.
    pipe = _port_pipeline(data, base, HP)
    second = Trainer(
        examples=_node(pipe, "Transform").outputs["transformed_examples"],
        transform_graph=_node(pipe, "Transform").outputs["transform_graph"],
        base_model=_node(pipe, "Trainer").outputs["model"],
        module_file=PORT_MODULE, train_steps=2,
        hyperparameters={**HP, "learning_rate": 0.0},
    ).with_id("WarmTrainer")
    result = LocalDagRunner(device="cpu").run(
        Pipeline(pipe.name, [*pipe.components, second],
                 pipeline_root=pipe.pipeline_root,
                 metadata_path=pipe.metadata_path))
    assert result.nodes["Trainer"].status == "CACHED"
    assert result.nodes["WarmTrainer"].status == "COMPLETE"
    want = load_exported_model(uris["Trainer"]["model"], device="cpu").params
    got = load_exported_model(
        _uris(result)["WarmTrainer"]["model"], device="cpu").params
    assert sorted(got) == sorted(want)
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)

    fn_args = FnArgs(custom_config={"base_model_uri": uris["Trainer"]["model"]})
    assert warm_start_init(FnArgs(), bert_module.init_params_fn) is (
        bert_module.init_params_fn)
    wider = warm_start_init(fn_args, functools.partial(
        bert_module.init_params_fn, hyperparameters={**HP, "d_model": 64}))
    with pytest.raises(ValueError, match=r"does not match.*embed\.weight: init "
                                         r"\(256, 64\)/torch.float32 vs base "
                                         r"model \(256, 32\)") as err:
        wider(torch.Generator().manual_seed(0), None)
    assert str(err.value).count("; ") == 7          # eight paths named


def test_a_mesh_is_refused_naming_its_item(port_runs, tmp_path):
    uris = _uris(port_runs[0])
    examples = uris["Transform"]["transformed_examples"]
    fn_args = FnArgs(
        train_examples_uri=examples, eval_examples_uri=examples,
        transform_graph_uri=uris["Transform"]["transform_graph"],
        serving_model_dir=str(tmp_path / "model"),
        model_run_dir=str(tmp_path / "run"), train_steps=1,
        hyperparameters=HP, mesh_config={"data": 2}, device="cpu")
    # A mesh is ported (A5, A6a, A6b): two ranks do not cover a run of one
    # process (the reference's error), nor do two on 'seq', 'expert',
    # 'model' or 'pipe'.
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        bert_module.run_fn(fn_args)
    for axis in ("seq", "expert"):
        fn_args.mesh_config = {"data": 1, axis: 2}
        with pytest.raises(ValueError, match="does not cover 1 devices"):
            bert_module.run_fn(fn_args)
    for axis in ("model", "pipe"):
        fn_args.mesh_config = {"data": 1, axis: 2}
        with pytest.raises(ValueError, match="does not cover 1 devices"):
            bert_module.run_fn(fn_args)


def test_vocab_size_comes_from_the_tokenizer_unless_pinned(port_runs,
                                                          tmp_path):
    uris = _uris(port_runs[0])
    examples = uris["Transform"]["transformed_examples"]
    graph = uris["Transform"]["transform_graph"]
    learned = TransformGraph.load(graph).tokenizer_vocab_sizes()["input_ids"]
    unpinned = {k: v for k, v in HP.items() if k != "vocab_size"}
    for hp, want in ((unpinned, -(-learned // 64) * 64), (HP, 256)):
        out = tmp_path / str(want)
        bert_module.run_fn(FnArgs(
            train_examples_uri=examples, eval_examples_uri=examples,
            transform_graph_uri=graph, serving_model_dir=str(out / "model"),
            model_run_dir=str(out / "run"), train_steps=1, hyperparameters=hp,
            device="cpu"))
        with open(out / "model" / "model_spec.json") as f:
            assert json.load(f)["hyperparameters"]["vocab_size"] == want
