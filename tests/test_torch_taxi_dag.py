"""Port parity: the Chicago-taxi DAG, the port's runner against the
reference's, on the CPU.

Both DAGs run once per module on ``tests/testdata/taxi_sample.csv`` at 8
train steps (the reference under jax on the CPU, the port with
``device="cpu"``), and the port's a second time, which must be fully
cached.  Then, artifact by artifact:

  - split membership: the raw examples of each split equal row for row;
  - statistics: counts, min/max, medians, histograms and top values
    exact, means and standard deviations within STATS_RTOL (the order of
    float64 sums over merged shards);
  - schema and anomalies equal;
  - Transform: analyzer states within 1e-12 relative (float64 on both
    sides), transformed columns equal except log_fare_z, within
    LOG_TOL (torch's log1p against numpy's, a few f32 ulps);
  - the reference Trainer's payload converted into a port payload
    (``taxi_state_dict_from_flax``) gives the reference Evaluator's
    metrics through the port's ``evaluate_payload`` (accuracy exactly, AUC
    within 1e-6) and its raw-example predictions through the port's
    ``predict`` (within 1e-5: f32 forwards that differ in sum order).
"""

import contextlib
import glob
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from tpu_pipelines.data import examples_io as ref_io
from tpu_pipelines.orchestration import LocalDagRunner as RefRunner
from tpu_pipelines.trainer.export import load_exported_model as ref_load
from tpu_pipelines.trainer.export import restore_exported_params
from tpu_pipelines_torch.components.evaluator import evaluate_payload
from tpu_pipelines_torch.data import examples_io as port_io
from tpu_pipelines_torch.dsl.compiler import Compiler
from tpu_pipelines_torch.examples import taxi_pipeline
from tpu_pipelines_torch.models.convert import taxi_state_dict_from_flax
from tpu_pipelines_torch.orchestration import LocalDagRunner
from tpu_pipelines_torch.trainer.export import export_model, load_exported_model
from tpu_pipelines_torch.transform import graph as port_graph
from tpu_pipelines_torch.transform.graph import TransformGraph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PIPELINE = os.path.join(REPO, "examples", "taxi", "pipeline.py")
TAXI_MODULE = os.path.join(REPO, "tpu_pipelines_torch", "examples",
                           "taxi_module.py")
STEPS = "8"
STATS_RTOL = 1e-12
STATE_RTOL = 1e-12
LOG_TOL = dict(rtol=1e-6, atol=1e-6)
AUC_TOL = 1e-6
PRED_TOL = dict(rtol=1e-5, atol=1e-5)


@contextlib.contextmanager
def _env(**values):
    with pytest.MonkeyPatch.context() as mp:
        for k, v in values.items():
            mp.setenv(k, v)
        yield


def _uris(result):
    return {node: {key: arts[0].uri for key, arts in nr.outputs.items()}
            for node, nr in result.nodes.items()}


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    base = tmp_path_factory.mktemp("ref")
    spec = importlib.util.spec_from_file_location("ref_taxi", REF_PIPELINE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    with _env(TAXI_TRAIN_STEPS=STEPS, TPP_TRACE="0"):
        result = RefRunner().run(module.create_pipeline(str(base)))
    return _uris(result)


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("port")
    with _env(TAXI_TRAIN_STEPS=STEPS):
        cold = LocalDagRunner(device="cpu").run(
            taxi_pipeline.create_pipeline(str(base)))
        warm = LocalDagRunner(device="cpu").run(
            taxi_pipeline.create_pipeline(str(base)))
    return cold, warm


@pytest.fixture(scope="module")
def port_run(port_runs):
    return _uris(port_runs[0])


def _json(uri, name):
    with open(os.path.join(uri, name)) as f:
        return json.load(f)


def test_port_dag_runs_nine_nodes_blesses_pushes_and_reruns_cached(port_runs):
    cold, warm = port_runs
    assert list(cold.nodes) == [
        "CsvExampleGen", "StatisticsGen", "SchemaGen", "ExampleValidator",
        "Transform", "Trainer", "Evaluator", "InfraValidator", "Pusher"]
    assert {nr.status for nr in cold.nodes.values()} == {"COMPLETE"}
    assert {nr.status for nr in warm.nodes.values()} == {"CACHED"}
    uris = _uris(cold)
    assert os.path.exists(os.path.join(uris["Evaluator"]["blessing"], "BLESSED"))
    assert os.path.exists(
        os.path.join(uris["InfraValidator"]["blessing"], "BLESSED"))
    pushed = open(os.path.join(uris["Pusher"]["pushed_model"],
                               "pushed_version.txt")).read().strip()
    spec = json.load(open(os.path.join(pushed, "model_spec.json")))
    assert spec["has_transform"] and spec["label"] == "label_big_tip"


def test_compiled_dags_have_the_same_shape(tmp_path):
    from tpu_pipelines.dsl.compiler import Compiler as RefCompiler

    spec = importlib.util.spec_from_file_location("ref_taxi2", REF_PIPELINE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    ref_ir = RefCompiler().compile(module.create_pipeline(str(tmp_path)))
    port_ir = Compiler().compile(taxi_pipeline.create_pipeline(str(tmp_path)))
    shape = lambda ir: [(n.id, n.component_type, n.upstream, n.resource_class,
                         sorted(n.exec_properties)) for n in ir.nodes]
    assert shape(port_ir) == shape(ref_ir)


def test_split_membership_is_identical(ref_run, port_run):
    ref_uri = ref_run["CsvExampleGen"]["examples"]
    port_uri = port_run["CsvExampleGen"]["examples"]
    for split in ("train", "eval"):
        want = ref_io.read_split(ref_uri, split)
        got = port_io.read_split(port_uri, split)
        assert list(got) == list(want)
        for name in want:
            assert np.asarray(got[name]).tolist() == want[name].tolist(), name


def _assert_stats_equal(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_stats_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_stats_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and path.rsplit(".", 1)[-1] in (
            "mean", "std_dev", "avg_length"):
        assert got == pytest.approx(want, rel=STATS_RTOL, abs=0), path
    else:
        assert got == want, path


def test_statistics_schema_and_anomalies_equal(ref_run, port_run):
    _assert_stats_equal(
        _json(port_run["StatisticsGen"]["statistics"], "stats.json"),
        _json(ref_run["StatisticsGen"]["statistics"], "stats.json"))
    assert _json(port_run["SchemaGen"]["schema"], "schema.json") == _json(
        ref_run["SchemaGen"]["schema"], "schema.json")
    assert _json(port_run["ExampleValidator"]["anomalies"],
                 "anomalies.json") == _json(
        ref_run["ExampleValidator"]["anomalies"], "anomalies.json")


def test_transform_states_and_columns_equal(ref_run, port_run):
    ref_graph = TransformGraph.load(ref_run["Transform"]["transform_graph"])
    port_graph_ = TransformGraph.load(port_run["Transform"]["transform_graph"])
    assert sorted(port_graph_.state) == sorted(ref_graph.state)
    for nid, st in ref_graph.state.items():
        for key, want in st.items():
            got = port_graph_.state[nid][key]
            if key == "vocab":
                assert list(got) == list(want)
            else:
                np.testing.assert_allclose(np.asarray(got, np.float64),
                                           np.asarray(want, np.float64),
                                           rtol=STATE_RTOL, atol=0)
    ref_uri = ref_run["Transform"]["transformed_examples"]
    port_uri = port_run["Transform"]["transformed_examples"]
    for split in ("train", "eval"):
        want = ref_io.read_split(ref_uri, split)
        got = port_io.read_split(port_uri, split)
        assert sorted(got) == sorted(want)
        for name in want:
            g = np.asarray(got[name], np.float64)
            w = np.asarray(want[name], np.float64)
            if name == "log_fare_z":
                np.testing.assert_allclose(g, w, err_msg=name, **LOG_TOL)
            else:
                np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.fixture(scope="module")
def converted_payload(ref_run, tmp_path_factory):
    """The reference Trainer's payload as a port payload: same weights,
    hyperparameters and transform graph."""
    ref_model = ref_run["Trainer"]["model"]
    spec = _json(ref_model, "model_spec.json")
    params = restore_exported_params(ref_model)
    out = str(tmp_path_factory.mktemp("converted") / "1")
    export_model(
        serving_model_dir=out,
        params=taxi_state_dict_from_flax(
            {k: {n: np.asarray(v) for n, v in node.items()}
             for k, node in params.items()}),
        module_file=TAXI_MODULE,
        hyperparameters=spec["hyperparameters"],
        transform_graph_uri=os.path.join(ref_model, "transform_graph"),
        extra_spec={"label": spec["label"]},
    )
    return out


def test_reference_payload_gives_the_reference_metrics_through_the_port(
        ref_run, port_run, converted_payload):
    want = json.load(open(glob.glob(os.path.join(
        ref_run["Evaluator"]["evaluation"], "metrics.json"))[0]))
    props = {"label_key": "label_big_tip", "eval_split": "eval",
             "batch_size": 512, "slice_columns": ["hour_bucket"],
             "problem": "binary_classification"}
    got = evaluate_payload(converted_payload,
                           port_run["Transform"]["transformed_examples"],
                           props, device="cpu")
    want_slices = {s["slice_key"]: s for s in want["slices"]}
    assert sorted(s.slice_key for s in got.slices) == sorted(want_slices)
    for s in got.slices:
        w = want_slices[s.slice_key]
        assert s.num_examples == w["num_examples"], s.slice_key
        assert s.metrics["accuracy"] == w["metrics"]["accuracy"], s.slice_key
        assert s.metrics["auc"] == pytest.approx(
            w["metrics"]["auc"], abs=AUC_TOL), s.slice_key


def test_reference_payload_predicts_raw_examples_through_the_port(
        ref_run, converted_payload):
    raw = ref_io.read_split(ref_run["CsvExampleGen"]["examples"], "eval")
    want = np.asarray(ref_load(ref_run["Trainer"]["model"]).predict(raw))
    loaded = load_exported_model(converted_payload, device="cpu")
    assert loaded.transform is not None
    got = loaded.predict(raw)
    assert got.shape == want.shape == (len(raw["fare"]),)
    np.testing.assert_allclose(got, want, **PRED_TOL)


def test_a_failing_device_evaluator_fails_the_transform_node(
        tmp_path, monkeypatch):
    def broken(node, args):
        raise RuntimeError("device evaluator broke")

    monkeypatch.setattr(port_graph, "_torch_stateless", broken)
    with _env(TAXI_TRAIN_STEPS="1"):
        result = LocalDagRunner(device="cpu").run(
            taxi_pipeline.create_pipeline(str(tmp_path)),
            raise_on_failure=False)
    transform = result.nodes["Transform"]
    assert transform.status == "FAILED"
    assert "device evaluator broke" in transform.error
    assert not port_io.split_names(os.path.join(
        str(tmp_path), "root", "Transform", "transformed_examples",
        str(transform.execution_id)))
    for node in ("Trainer", "Evaluator", "Pusher"):
        assert result.nodes[node].status == "FAILED"
        assert result.nodes[node].error == "upstream failure"


def test_runner_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="'cuda'.*CUDA is not available"):
        LocalDagRunner()


@pytest.mark.parametrize("kwargs,item", [
    ({"resume_from": "latest"}, "A22"),
    ({"from_nodes": ["Trainer"]}, "A22"),
    ({"lint": "error"}, "A20"),
])
def test_unported_runner_options_raise_naming_their_item(tmp_path, kwargs,
                                                         item):
    with pytest.raises(NotImplementedError, match=item):
        LocalDagRunner(device="cpu").run(
            taxi_pipeline.create_pipeline(str(tmp_path)), **kwargs)


@pytest.mark.parametrize("binary", ["inprocess", "http"])
def test_infra_validator_canaries_the_port_payload(port_run, tmp_path, binary):
    from tpu_pipelines_torch.components.infra_validator import InfraValidator
    from tpu_pipelines_torch.dsl.component import ExecutorContext
    from tpu_pipelines_torch.metadata.types import Artifact

    params = {k: p.default for k, p in InfraValidator.SPEC.parameters.items()}
    params["serving_binary"] = binary
    blessing = Artifact(type_name="InfraBlessing", uri=str(tmp_path))
    ctx = ExecutorContext(
        node_id="InfraValidator",
        inputs={
            "model": [Artifact("Model", port_run["Trainer"]["model"])],
            "examples": [Artifact("Examples",
                                  port_run["CsvExampleGen"]["examples"])],
        },
        outputs={"blessing": [blessing]},
        exec_properties=params,
        extras={"device": "cpu"},
    )
    props = InfraValidator.EXECUTOR(ctx)
    assert props["blessed"], props
    assert props["latency_p95_ms"] >= props["latency_p50_ms"] > 0
