"""Port serving: payload parity with the JAX package, ModelServer, CLI.

A tiny BERT (2 layers, d_model 64, 4 heads) initialised by JAX is exported
twice from the same weights: as a JAX payload (``tpu_pipelines.trainer.
export_model`` with the reference BERT module) and as a port payload
(converted state dict, the port's BERT module).  Both serve the same numpy
batch.  Tolerance 5e-2 on logits of magnitude ~1: bf16 compute, rounded at
different places by the two frameworks (see tests/test_torch_bert.py).
The port side runs on the CPU because the tests ask for it; without that
request the port refuses to run anywhere but on CUDA.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from tpu_pipelines.models.bert import build_bert_model as jax_build_bert
from tpu_pipelines.trainer.export import export_model as jax_export_model
from tpu_pipelines.trainer.export import (
    load_exported_model as jax_load_exported_model,
)
from tpu_pipelines_torch.models.convert import bert_state_dict_from_flax
from tpu_pipelines_torch.serving.server import ModelServer
from tpu_pipelines_torch.trainer.export import (
    FORMAT_VERSION,
    export_model,
    load_exported_model,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MODULE = os.path.join(REPO, "examples", "bert", "bert_trainer_module.py")
PORT_MODULE = os.path.join(
    REPO, "tpu_pipelines_torch", "examples", "bert_module.py"
)
HP = {
    "vocab_size": 64, "d_model": 64, "n_layers": 2, "n_heads": 4,
    "d_ff": 128, "max_len": 32, "dropout_rate": 0.0, "num_classes": 3,
    "attn_impl": "flash",
}
L = 16
BF16_TOL = dict(rtol=0, atol=5e-2)


def _batch(n=4, seed=0, with_mask=True):
    rng = np.random.default_rng(seed)
    ids = np.zeros((n, L), np.int32)
    for i in range(n):
        k = int(rng.integers(1, L + 1))
        ids[i, :k] = rng.integers(1, HP["vocab_size"], size=k)
    batch = {"input_ids": ids}
    if with_mask:
        batch["attention_mask"] = (ids > 0).astype(np.int32)
    return batch


def _flax_params(seed):
    model = jax_build_bert(HP)
    params = model.init(jax.random.key(seed), _batch())["params"]
    return jax.tree.map(np.asarray, params)


def _port_payload(path, seed=0):
    export_model(
        serving_model_dir=str(path),
        params=bert_state_dict_from_flax(_flax_params(seed)),
        module_file=PORT_MODULE,
        hyperparameters=HP,
    )
    return str(path)


@pytest.mark.parametrize("with_mask", [True, False])
def test_port_payload_predicts_like_jax_payload(tmp_path, with_mask):
    params = _flax_params(0)
    jax_dir = jax_export_model(
        serving_model_dir=str(tmp_path / "jax"), params=params,
        module_file=JAX_MODULE, hyperparameters=HP,
    )
    port_dir = export_model(
        serving_model_dir=str(tmp_path / "port"),
        params=bert_state_dict_from_flax(params),
        module_file=PORT_MODULE, hyperparameters=HP,
    )
    spec = json.load(open(os.path.join(port_dir, "model_spec.json")))
    assert spec["format"] == FORMAT_VERSION
    assert spec["dtype"] == "float32" and spec["has_transform"] is False
    assert spec["params_bytes"] == sum(
        np.asarray(x).nbytes for x in jax.tree.leaves(params)
    )
    batch = _batch(seed=1, with_mask=with_mask)
    want = np.asarray(jax_load_exported_model(jax_dir).predict(batch))
    loaded = load_exported_model(port_dir, device="cpu")
    assert loaded.dtype == "float32" and loaded.device.type == "cpu"
    assert loaded.params_bytes == spec["params_bytes"]
    got = loaded.predict(batch)
    assert isinstance(got, np.ndarray) and got.shape == (4, HP["num_classes"])
    np.testing.assert_allclose(got, want, **BF16_TOL)
    np.testing.assert_array_equal(loaded.predict_transformed(batch), got)


def test_load_defaults_to_cuda_and_raises_without_it(tmp_path, monkeypatch):
    payload = _port_payload(tmp_path / "p")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_exported_model(payload)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelServer("bert", payload)


def test_payload_with_transform_graph_is_refused(tmp_path):
    payload = _port_payload(tmp_path / "p")
    spec_path = os.path.join(payload, "model_spec.json")
    spec = json.load(open(spec_path))
    spec["has_transform"] = True
    json.dump(spec, open(spec_path, "w"))
    # The port serves transform payloads now; one that claims a graph but
    # carries none is refused at load.
    with pytest.raises(FileNotFoundError, match="transform_graph"):
        load_exported_model(payload, device="cpu")


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.status, resp.read().decode()


def _rows(batch):
    keys = list(batch)
    return [{k: batch[k][i].tolist() for k in keys}
            for i in range(len(batch[keys[0]]))]


def test_model_server_batches_concurrent_requests_and_reloads(tmp_path):
    base = tmp_path / "served" / "bert"
    _port_payload(base / "1", seed=0)
    server = ModelServer("bert", str(base), batching=True, max_batch_size=8,
                         device="cpu")
    try:
        port = server.start(port=0)
        root = f"http://127.0.0.1:{port}"
        predict_url = f"{root}/v1/models/bert:predict"
        direct = load_exported_model(str(base / "1"), device="cpu")
        requests = [_batch(n=1 + i % 2, seed=10 + i) for i in range(12)]
        results = [None] * len(requests)

        def call(i):
            results[i] = _post(predict_url, {"instances": _rows(requests[i])})

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        for batch, (code, reply) in zip(requests, results):
            assert code == 200
            np.testing.assert_allclose(
                np.asarray(reply["predictions"]), direct.predict(batch),
                **BF16_TOL,
            )
        code, reply = _post(
            predict_url, {"inputs": {k: v.tolist() for k, v in requests[0].items()}}
        )
        assert code == 200 and len(reply["predictions"]) == 1

        code, body = _get(f"{root}/healthz")
        health = json.loads(body)
        assert code == 200 and health["healthy"] and health["version"] == "1"
        assert health["device"] == "cpu" and health["batching"] is True
        code, body = _get(f"{root}/v1/models/bert")
        assert json.loads(body)["model_version_status"][0]["version"] == "1"
        code, text = _get(f"{root}/metrics")
        assert 'serving_requests_total{endpoint="predict",code="200"} 13' in text
        batches = float(re.search(r"^serving_batches_total (\S+)$", text, re.M)[1])
        assert 1 <= batches <= 13
        assert 'serving_model_info{model="bert",version="1"} 1' in text

        _port_payload(base / "2", seed=5)
        code, reply = _post(f"{root}/v1/models/bert:reload", {})
        assert code == 200 and reply["version"] == "2"
        v2 = load_exported_model(str(base / "2"), device="cpu")
        code, reply = _post(predict_url, {"instances": _rows(requests[0])})
        np.testing.assert_allclose(
            np.asarray(reply["predictions"]), v2.predict(requests[0]),
            **BF16_TOL,
        )
        assert server.version == "2"
    finally:
        server.stop()


def test_model_server_sheds_load_and_classifies_errors(tmp_path):
    payload = _port_payload(tmp_path / "p")
    server = ModelServer("bert", payload, max_queue_depth=1, device="cpu")
    try:
        url = f"http://127.0.0.1:{server.start(port=0)}/v1/models/bert:predict"
        server._admit("predict")           # one request in flight: at the bound
        try:
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(url, {"instances": _rows(_batch(n=1))})
            assert err.value.code == 429
            assert err.value.headers["Retry-After"] == "1"
        finally:
            server._release()
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(url, {"rows": []})
        assert err.value.code == 400
        assert _post(url, {"instances": []}) == (200, {"predictions": []})
        text = _get(url.replace("/v1/models/bert:predict", "/metrics"))[1]
        assert 'serving_load_shed_total{endpoint="predict"} 1' in text
    finally:
        server.stop()


def test_admission_slot_is_free_when_the_reply_arrives(tmp_path):
    """A client that sends its next request as soon as a reply arrives
    must not be shed: the handler releases its admission slot before the
    reply goes out (a release slowed by 0.2 s shows the order)."""
    payload = _port_payload(tmp_path / "p")
    server = ModelServer("bert", payload, max_queue_depth=1, device="cpu")
    release = server._release

    def slow_release():
        time.sleep(0.2)
        release()

    server._release = slow_release
    try:
        url = f"http://127.0.0.1:{server.start(port=0)}/v1/models/bert:predict"
        for body in ({"instances": []}, {"rows": []}, {"instances": []}):
            try:
                code = _post(url, body)[0]
            except urllib.error.HTTPError as e:
                code = e.code
            assert code == (400 if "rows" in body else 200)
    finally:
        server.stop()


def test_serving_cli_serves_a_version_dir_on_cpu(tmp_path):
    base = tmp_path / "served"
    _port_payload(base / "3")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_pipelines_torch.serving",
         "--model-name", "bert", "--base-dir", str(base), "--port", "0",
         "--host", "127.0.0.1", "--device", "cpu", "--batching",
         "--poll-seconds", "0.5"],
        cwd=REPO, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    try:
        port = None
        deadline = time.monotonic() + 60
        while port is None and time.monotonic() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            m = re.search(r"serving 'bert' \(version 3\) on 127\.0\.0\.1:(\d+)", line)
            if m:
                port = int(m[1])
        assert port is not None, "server never reported its port"
        code, reply = _post(
            f"http://127.0.0.1:{port}/v1/models/bert:predict",
            {"instances": _rows(_batch(n=2))},
        )
        assert code == 200 and np.asarray(reply["predictions"]).shape == (2, 3)
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            assert proc.wait(timeout=30) == 0
        finally:
            if proc.poll() is None:
                proc.kill()


def test_batcher_pads_to_buckets():
    from tpu_pipelines_torch.serving.batching import bucket_sizes, pad_to_bucket

    assert bucket_sizes(32) == [1, 2, 4, 8, 16, 32]
    assert bucket_sizes(24) == [1, 2, 4, 8, 16, 24]
    padded = pad_to_bucket({"x": np.arange(3)[:, None]}, 3, bucket_sizes(8))
    assert padded["x"][:, 0].tolist() == [0, 1, 2, 0]


def _batcher_groups(batcher_cls, scenario):
    """Drive one batcher through a scenario; returns the device calls as
    sorted (requests in the group, padded rows) pairs."""
    max_batch, timeout_s, rows, backlog = {
        # 6 one-row requests inside one long window: one group.
        "window": (16, 0.5, [1] * 6, False),
        # 2-row requests against a 4-row budget: the third opens a group.
        "budget": (4, 0.5, [2] * 3, False),
        # 5 requests queue behind a slow first step, their windows long
        # passed when it returns: each closes its group at once.
        "backlog": (16, 0.001, [1] * 6, True),
    }[scenario]
    release = threading.Event()
    calls = []

    def predict(batch):
        ids = batch["x"][:, 0]
        calls.append((len(set(ids.tolist())), len(ids)))
        if backlog and len(calls) == 1:
            assert release.wait(timeout=30)
        return batch["x"] * 10

    batcher = batcher_cls(predict, max_batch_size=max_batch,
                          batch_timeout_s=timeout_s)
    out = {}

    def submit(i):
        out[i] = batcher.submit({"x": np.full((rows[i], 1), i + 1)}, rows[i])

    try:
        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(len(rows))]
        deadline = time.monotonic() + 30
        if backlog:
            threads[0].start()
            while not calls and time.monotonic() < deadline:
                time.sleep(0.001)
            for t in threads[1:]:
                t.start()
            while (batcher._queue.qsize() < len(rows) - 1
                   and time.monotonic() < deadline):
                time.sleep(0.001)
            time.sleep(0.01)                 # every window has passed
            release.set()
        else:
            for t in threads:
                t.start()
        for t in threads:
            t.join(timeout=30)
        assert {i: v[:, 0].tolist() for i, v in out.items()} == {
            i: [10 * (i + 1)] * n for i, n in enumerate(rows)
        }
    finally:
        batcher.close()
    assert batcher.batches_run == len(calls)
    return sorted(calls)


@pytest.mark.parametrize("scenario", ["window", "budget", "backlog"])
def test_batcher_groups_requests_like_the_jax_batcher(scenario):
    """The port's RequestBatcher forms the same device batches as the
    reference's: same gather window, row budget and backlog policy."""
    from tpu_pipelines.serving.batching import RequestBatcher as JaxBatcher
    from tpu_pipelines_torch.serving.batching import RequestBatcher

    expected = {
        "window": [(6, 8)],
        "budget": [(1, 2), (2, 4)],
        "backlog": [(1, 1)] * 6,
    }[scenario]
    assert _batcher_groups(JaxBatcher, scenario) == expected
    assert _batcher_groups(RequestBatcher, scenario) == expected
