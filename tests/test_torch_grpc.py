"""The port's gRPC surface (``serving/grpc_server.py``) against the JAX
package's, on the CPU, and transformed-example serving (``raw=False``).

  - The tensor codec gives the reference's bytes for every wire dtype and
    round-trips.
  - The reference's ``PredictionClient`` against the port's server answers
    as it does against the reference's server: the same tiny BERT weights
    (``tests/test_torch_serving.py``) exported by both packages, logits
    within that file's bf16 tolerance (5e-2 on logits of magnitude ~1),
    the same version, status, reload and error codes; the port's client
    gets the same answers from the reference's server.
  - On the port's taxi DAG (``tpu_pipelines_torch/examples/
    taxi_pipeline.py`` at 8 steps, CPU): a ``raw=False`` server answers
    REST and gRPC with ``LoadedModel.predict_transformed`` on the
    Transform's examples bit for bit, and those equal the raw server's
    replies on the same rows within 1e-5 (f32 forwards that order their
    sums differently); the InfraValidator blesses the payload over
    ``grpc`` and with ``raw_examples=False`` over every binary.
"""

import contextlib
import json
import os
import urllib.request

import grpc
import numpy as np
import pytest

import test_torch_serving as ts
from tpu_pipelines.serving import grpc_server as ref_grpc
from tpu_pipelines.serving.server import ModelServer as RefServer
from tpu_pipelines.trainer.export import export_model as jax_export_model
from tpu_pipelines_torch.serving import grpc_server as port_grpc
from tpu_pipelines_torch.serving.server import ModelServer

PRED_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arr", [
    np.arange(6, dtype=np.float32).reshape(2, 3) / 7,
    np.array([[1.5, -2.0]], np.float64),
    np.array([3, -4, 5], np.int32),
    np.array([[1 << 40]], np.int64),
    np.array([True, False, True]),
    np.array([["a", "bé"], ["", "c"]], dtype=object),
    np.array([0.25, 0.5], np.float16),
], ids=["f32", "f64", "i32", "i64", "bool", "str", "f16"])
def test_the_codec_round_trips_to_the_references_bytes(arr):
    port = port_grpc.array_to_tensor(arr)
    ref = ref_grpc.array_to_tensor(arr)
    assert port.SerializeToString() == ref.SerializeToString()
    back = port_grpc.tensor_to_array(port)
    np.testing.assert_array_equal(back, ref_grpc.tensor_to_array(ref))
    if arr.dtype != np.float16:  # f16 is widened to f32 on the wire
        np.testing.assert_array_equal(back, arr)


@contextlib.contextmanager
def _grpc(server, start):
    grpc_server, port = start(server)
    try:
        yield f"127.0.0.1:{port}"
    finally:
        grpc_server.stop(grace=1)
        server.stop()


@pytest.fixture(scope="module")
def payloads(tmp_path_factory):
    base = tmp_path_factory.mktemp("grpc")
    params = ts._flax_params(0)
    jax_export_model(serving_model_dir=str(base / "jax" / "1"), params=params,
                     module_file=ts.JAX_MODULE, hyperparameters=ts.HP)
    ts._port_payload(base / "port" / "1", seed=0)
    return str(base / "jax"), str(base / "port")


def _session(target, client_cls, batch):
    client = client_cls(target)
    try:
        preds, version = client.predict("bert", batch)
        out = {"preds": preds, "version": version,
               "status": client.model_status("bert"),
               "reload": client.reload("bert")}
        for name, call in (("unknown", lambda: client.predict("nope", batch)),
                           ("generate", lambda: client.generate("bert",
                                                                batch))):
            with pytest.raises(grpc.RpcError) as e:
                call()
            out[name] = e.value.code()
        return out
    finally:
        client.close()


def test_the_reference_client_gets_the_reference_servers_answers(payloads):
    jax_dir, port_dir = payloads
    batch = ts._batch(n=5, seed=4)
    got = {}
    with _grpc(RefServer("bert", jax_dir), ref_grpc.start_grpc_server) as t:
        got["ref"] = _session(t, ref_grpc.PredictionClient, batch)
        # The port's client on the reference's server.
        got["port_client"] = _session(t, port_grpc.PredictionClient, batch)
    with _grpc(ModelServer("bert", port_dir, device="cpu"),
               port_grpc.start_grpc_server) as t:
        got["port"] = _session(t, ref_grpc.PredictionClient, batch)
    for side in ("port", "port_client"):
        want = {k: v for k, v in got["ref"].items() if k != "preds"}
        assert {k: v for k, v in got[side].items() if k != "preds"} == want
    np.testing.assert_allclose(got["port"]["preds"], got["ref"]["preds"],
                               **ts.BF16_TOL)
    np.testing.assert_array_equal(got["port_client"]["preds"],
                                  got["ref"]["preds"])
    assert got["port"]["version"] == "1"
    assert got["port"]["status"] == {"version": "1", "state": "AVAILABLE"}
    assert got["port"]["unknown"] == grpc.StatusCode.NOT_FOUND
    assert got["port"]["generate"] == grpc.StatusCode.FAILED_PRECONDITION


def test_generate_on_a_transformed_surface_is_refused_like_the_reference():
    """A ``raw=False`` server whose payload embeds a transform refuses
    ``:generate`` with the reference's message (the payload's generate
    would transform twice)."""
    from types import SimpleNamespace

    from tpu_pipelines.serving.server import GenerateUnsupported as RefErr
    from tpu_pipelines_torch.serving.server import GenerateUnsupported

    loaded = SimpleNamespace(generate=lambda b: b, transform=object())
    messages = {}
    for side, cls, err in (("ref", RefServer, RefErr),
                           ("port", ModelServer, GenerateUnsupported)):
        fake = SimpleNamespace(raw=False, model_name="m",
                               _current_loaded=lambda: loaded,
                               _current_model=lambda: loaded)
        with pytest.raises(err) as e:
            cls._generate_fn(fake)
        messages[side] = str(e.value)
    assert messages["port"] == messages["ref"]


# ------------------------------------------- transformed-example serving


@pytest.fixture(scope="module")
def taxi(tmp_path_factory):
    from tpu_pipelines_torch.examples import taxi_pipeline
    from tpu_pipelines_torch.orchestration import LocalDagRunner

    base = tmp_path_factory.mktemp("taxi")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TAXI_TRAIN_STEPS", "8")
        mp.setenv("TPP_TRACE", "0")
        # No fork beside the reference's threads: they can deadlock it.
        mp.setenv("TPP_DATA_POOL", "thread")
        result = LocalDagRunner(device="cpu").run(
            taxi_pipeline.create_pipeline(str(base)))
    return {node: {key: arts[0].uri for key, arts in nr.outputs.items()}
            for node, nr in result.nodes.items()}


def _first_rows(uri, n=6):
    from tpu_pipelines_torch.data import examples_io

    batch = next(examples_io.iter_column_chunks(uri, "eval", rows=n))
    return {k: v[:n] for k, v in batch.items()}


def _rest_predict(server, batch):
    port = server.start()
    rows = [{k: np.asarray(v[i]).tolist() for k, v in batch.items()}
            for i in range(len(next(iter(batch.values()))))]
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/taxi:predict",
        data=json.dumps({"instances": rows}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return np.asarray(json.load(r)["predictions"])


def test_a_transformed_surface_serves_predict_transformed(taxi):
    from tpu_pipelines_torch.trainer.export import load_exported_model

    model = taxi["Trainer"]["model"]
    transformed = _first_rows(taxi["Transform"]["transformed_examples"])
    raw = _first_rows(taxi["CsvExampleGen"]["examples"])
    loaded = load_exported_model(model, device="cpu")
    want = loaded.predict_transformed(transformed)
    replies = {}
    for surface in ("rest", "grpc"):
        server = ModelServer("taxi", model, raw=False, device="cpu")
        try:
            if surface == "rest":
                replies[surface] = _rest_predict(server, transformed)
            else:
                grpc_server, port = port_grpc.start_grpc_server(server)
                client = port_grpc.PredictionClient(f"127.0.0.1:{port}")
                try:
                    replies[surface] = client.predict("taxi", transformed)[0]
                finally:
                    client.close()
                    grpc_server.stop(grace=1)
        finally:
            server.stop()
    np.testing.assert_array_equal(replies["grpc"], want)
    np.testing.assert_allclose(replies["rest"], want, **PRED_TOL)
    raw_server = ModelServer("taxi", model, device="cpu")
    try:
        np.testing.assert_allclose(_rest_predict(raw_server, raw), want,
                                   **PRED_TOL)
    finally:
        raw_server.stop()


@pytest.mark.parametrize("binary, raw_examples", [
    ("grpc", True), ("inprocess", False), ("http", False), ("grpc", False),
])
def test_the_infra_validator_blesses_over_grpc_and_transformed_examples(
        taxi, tmp_path, binary, raw_examples):
    from tpu_pipelines_torch.components.infra_validator import InfraValidator
    from tpu_pipelines_torch.dsl.component import ExecutorContext
    from tpu_pipelines_torch.metadata.types import Artifact

    params = {k: p.default for k, p in InfraValidator.SPEC.parameters.items()}
    params["serving_binary"] = binary
    params["raw_examples"] = raw_examples
    examples = (taxi["CsvExampleGen"]["examples"] if raw_examples
                else taxi["Transform"]["transformed_examples"])
    ctx = ExecutorContext(
        node_id="InfraValidator",
        inputs={"model": [Artifact("Model", taxi["Trainer"]["model"])],
                "examples": [Artifact("Examples", examples)]},
        outputs={"blessing": [Artifact(type_name="InfraBlessing",
                                       uri=str(tmp_path))]},
        exec_properties=params,
        extras={"device": "cpu"},
    )
    props = InfraValidator.EXECUTOR(ctx)
    assert props["blessed"], props
    assert os.path.exists(os.path.join(str(tmp_path), "BLESSED"))
