"""``:generate`` over HTTP on the port's ``ModelServer`` (CPU), against
the JAX package.

A tiny T5 payload (the weights of ``tests/torch_t5_tiny.py``, the
payload's bf16 compute, flash decode, beam 2) exported by both packages:
the port's replies must equal the JAX payload's beam search for the same
weights and inputs, token for token; generation ``params`` are 400s.  The
route's other cases, which need no JAX, are in
``tests/test_torch_generate_endpoint.py``.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

import torch_t5_tiny as tiny
from tpu_pipelines.trainer.export import export_model as jax_export_model
from tpu_pipelines.trainer.export import (
    load_exported_model as jax_load_exported_model,
)
from tpu_pipelines_torch.models.convert import t5_state_dict_from_flax
from tpu_pipelines_torch.serving.server import ModelServer
from tpu_pipelines_torch.trainer.export import export_model, load_exported_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_T5_MODULE = os.path.join(REPO, "examples", "t5", "t5_trainer_module.py")
PORT_T5_MODULE = os.path.join(REPO, "tpu_pipelines_torch", "examples",
                              "t5_module.py")
TINY = tiny.TINY


@pytest.fixture(scope="module")
def flax_params():
    return tiny.flax_params()


HP = {**TINY, "attn_impl": "flash", "beam_size": 2, "max_decode_len": 6,
      "eos_id": 3}


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def _post_code(url, payload):
    try:
        return _post(url, payload)[0]
    except urllib.error.HTTPError as e:
        return e.code


def test_generate_over_http_equals_the_jax_payloads_beam_search(
        tmp_path, flax_params):
    jax_dir = jax_export_model(
        serving_model_dir=str(tmp_path / "jax"), params=flax_params,
        module_file=JAX_T5_MODULE, hyperparameters=HP)
    base = tmp_path / "served" / "t5"
    export_model(serving_model_dir=str(base / "1"),
                 params=t5_state_dict_from_flax(flax_params),
                 module_file=PORT_T5_MODULE, hyperparameters=HP)
    rng = np.random.default_rng(5)
    requests = []
    # Three requests of one shape: the JAX payload compiles its beam search
    # once per shape (about 3 s each on the CPU).
    for _ in range(3):
        inputs = rng.integers(4, 48, size=(2, 6)).astype(np.int32)
        for row in inputs:
            row[int(rng.integers(2, 7)):] = 0
        requests.append({"inputs": inputs.tolist(),
                         "input_mask": (inputs > 0).astype(np.int32).tolist()})
    jax_loaded = jax_load_exported_model(jax_dir)
    want = [np.asarray(jax_loaded.generate(
        {k: np.asarray(v, np.int32) for k, v in r.items()})).tolist()
        for r in requests]

    loaded = load_exported_model(str(base / "1"), device="cpu")
    assert loaded.decode_fns.max_decode_len == 6
    assert loaded.decode_fns.eos_id == 3
    server = ModelServer("t5", str(base), device="cpu")
    try:
        url = f"http://127.0.0.1:{server.start(port=0)}/v1/models/t5"
        for request, expected in zip(requests, want):
            code, reply = _post(f"{url}:generate", {"inputs": request})
            assert code == 200 and reply["outputs"] == expected
        instances = [dict(zip(requests[1], row))
                     for row in zip(*requests[1].values())]
        assert _post(f"{url}:generate", {"instances": instances}) == (
            200, {"outputs": want[1]})
        assert _post(f"{url}:generate", {"instances": []}) == (
            200, {"outputs": []})
        assert _post(f"{url}:generate", {"instances": [], "params": {}}) == (
            200, {"outputs": []})
        # Generation params need the generative fleet: 400, as in the
        # reference without one.
        for params in ({"max_new_tokens": 2}, 3):
            assert _post_code(f"{url}:generate",
                              {"inputs": requests[0], "params": params}) == 400
        text = urllib.request.urlopen(
            url.replace("/v1/models/t5", "/metrics")).read().decode()
        # Three requests, the instances form and the two empty ones.
        assert 'serving_requests_total{endpoint="generate",code="200"} 6' in text
        assert 'serving_requests_total{endpoint="generate",code="400"} 2' in text
    finally:
        server.stop()
