"""The port's generative fleet (``model_type="generative"``) on the CPU.

A tiny T5 (the weights of ``tests/torch_t5_tiny.py``, JAX-initialised and
converted) is exported by both packages; ``:generate`` with generation
params through a 2-replica generative fleet of the port must return the
JAX fleet's greedy token streams exactly (integer ids; the per-step
logits agree within the tiny T5's decode tolerance, far from any argmax
tie at these sizes).  The other cases mirror the reference's
``tests/test_generative.py`` fleet tests on the port alone: token
admission (429 + Retry-After), engines drained and pruned across
versions, the environment knobs, a payload without a decode contract
refused at the canary, and a replica killed mid-decode whose streams are
recovered, identical, on its peer.

Every test closes what it starts: a fixture fails it if a thread it
started is still alive at its end.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import torch_t5_tiny as tiny
from tpu_pipelines_torch.models.convert import t5_state_dict_from_flax
from tpu_pipelines_torch.observability.metrics import MetricsRegistry
from tpu_pipelines_torch.serving.server import ModelServer
from tpu_pipelines_torch.testing import faults
from tpu_pipelines_torch.trainer.export import export_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_T5_MODULE = os.path.join(REPO, "examples", "t5", "t5_trainer_module.py")
PORT_T5_MODULE = os.path.join(REPO, "tpu_pipelines_torch", "examples",
                              "t5_module.py")
PORT_BERT_MODULE = os.path.join(REPO, "tpu_pipelines_torch", "examples",
                                "bert_module.py")
HP = {**tiny.TINY, "attn_impl": "dense", "beam_size": 1, "max_decode_len": 8,
      "eos_id": 3, "max_input_len": 8}


@pytest.fixture(autouse=True)
def no_leaked_threads():
    before = set(threading.enumerate())
    yield
    deadline = time.monotonic() + 10
    while True:
        leaked = [t for t in threading.enumerate()
                  if t not in before and t.is_alive()]
        if not leaked or time.monotonic() > deadline:
            break
        time.sleep(0.02)
    assert leaked == []


@pytest.fixture(scope="module")
def flax_params():
    return tiny.flax_params()


def _port_payload(base, version, flax_params, **hp):
    return export_model(
        serving_model_dir=str(base / str(version)),
        params=t5_state_dict_from_flax(flax_params),
        module_file=PORT_T5_MODULE, hyperparameters={**HP, **hp})


def _post(url, payload, timeout=60):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _requests():
    rng = np.random.default_rng(7)
    out = []
    for n_rows, budget in ((2, 8), (1, 5), (3, 8), (2, 3)):
        inputs = rng.integers(4, 48, size=(n_rows, 6)).astype(np.int32)
        for row in inputs:
            row[int(rng.integers(2, 7)):] = 0
        out.append({"inputs": {"inputs": inputs.tolist(),
                               "input_mask": (inputs > 0).astype(
                                   np.int32).tolist()},
                    "params": {"max_new_tokens": budget}})
    return out


def test_tiny_t5_generate_through_a_2_replica_fleet_equals_the_jax_fleet(
        tmp_path, flax_params, monkeypatch):
    from tpu_pipelines.serving import ModelServer as JaxServer
    from tpu_pipelines.trainer.export import export_model as jax_export_model

    monkeypatch.setenv("TPP_AOT_CACHE", str(tmp_path / "aot_cache"))
    jax_export_model(serving_model_dir=str(tmp_path / "jax" / "1"),
                     params=flax_params, module_file=JAX_T5_MODULE,
                     hyperparameters=HP)
    _port_payload(tmp_path / "port", 1, flax_params, attn_impl="flash")
    replies = {}
    for name, server in (
            ("jax", JaxServer("t5", str(tmp_path / "jax"),
                              model_type="generative", max_batch_size=2)),
            ("port", ModelServer("t5", str(tmp_path / "port"),
                                 model_type="generative", replicas=2,
                                 max_batch_size=2, device="cpu"))):
        try:
            url = f"http://127.0.0.1:{server.start()}/v1/models/t5:generate"
            replies[name] = [_post(url, r)[1]["outputs"] for r in _requests()]
            if name == "port":
                health = server.health()["fleet"]
                engines = [sorted(r._engines)
                           for r in server._fleet.pool.replicas]
        finally:
            server.stop()
    assert replies["port"] == replies["jax"]
    assert [len(o[0]) <= r["params"]["max_new_tokens"]
            for o, r in zip(replies["port"], _requests())] == [True] * 4
    assert health["model_type"] == "generative" and health["replicas"] == 2
    assert health["outstanding_decode_tokens"] == 0
    assert engines == [["1"], ["1"]]


def test_token_admission_answers_429_with_retry_after(tmp_path, flax_params):
    _port_payload(tmp_path / "m", 1, flax_params)
    server = ModelServer("t5", str(tmp_path / "m"), model_type="generative",
                         max_batch_size=1, max_queue_tokens=4, device="cpu")
    url = f"http://127.0.0.1:{server.start()}/v1/models/t5:generate"
    body = {"instances": [{"inputs": [5, 9, 17]}]}
    try:
        # One request over the engine's token bound: shed with 429.
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(url, {**body, "params": {"max_new_tokens": 8}})
        assert err.value.code == 429
        assert err.value.headers["Retry-After"] == "1"
        assert "overloaded" in json.load(err.value)["error"]
        code, out = _post(url, {**body, "params": {"max_new_tokens": 3}})
        assert code == 200 and 1 <= len(out["outputs"][0]) <= 3
        # A malformed generation param is its caller's 400.
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(url, {**body, "params": {"max_new_tokens": 0}})
        assert err.value.code == 400
        scrape = server.metrics.to_prometheus()
    finally:
        server.stop()
    assert 'serving_decode_shed_total{replica="0"} 1' in scrape


def test_engines_drain_and_prune_across_versions(tmp_path, flax_params):
    from tpu_pipelines_torch.serving.fleet import ServingFleet

    base = tmp_path / "m"
    d1 = _port_payload(base, 1, flax_params)
    d2 = _port_payload(base, 2, flax_params)
    fleet = ServingFleet("t5", str(base), replicas=1, max_versions=1,
                         model_type="generative", max_batch_size=2,
                         device="cpu")
    batch = {"inputs": np.asarray([[5, 9, 17, 4]], np.int32)}
    try:
        fleet.load_version(d1)
        replica = fleet.pool.replicas[0]
        assert set(replica._engines) == {"1"}
        first = fleet.generate_submit(batch, {"max_new_tokens": 6})
        fleet.load_version(d2)
        # Version 1 left residency; its idle engine goes at the next
        # request's prune, which decodes on version 2's engine.
        assert set(replica._engines) == {"1", "2"}
        second = fleet.generate_submit(batch, {"max_new_tokens": 6})
        assert set(replica._engines) == {"2"}
        np.testing.assert_array_equal(second, first)   # the same weights
        assert fleet.health()["outstanding_decode_tokens"] == 0
    finally:
        fleet.close()


def test_generative_env_knobs(tmp_path, flax_params, monkeypatch):
    _port_payload(tmp_path / "m", 1, flax_params)
    monkeypatch.setenv("TPP_SERVING_MODEL_TYPE", "generative")
    monkeypatch.setenv("TPP_SERVING_PAGE_SIZE", "4")
    monkeypatch.setenv("TPP_SERVING_MAX_TOKENS", "64")
    server = ModelServer("t5", str(tmp_path / "m"), max_batch_size=2,
                         device="cpu")
    try:
        assert server.model_type == "generative"
        assert server.decode_page_size == 4 and server.max_queue_tokens == 64
        assert server._fleet is not None and server._fleet.generative
        engine = server._fleet.pool.replicas[0]._engines["1"]
        assert engine.page_size == 4 and engine.max_queue_tokens == 64
        assert engine.kv_buckets == [4, 8]
    finally:
        server.stop()
    # The per-token SLO is read from the environment too, and reaches the
    # replicas' engines.
    monkeypatch.setenv("TPP_SERVING_SLO_MS_PER_TOKEN", "5")
    server = ModelServer("t5", str(tmp_path / "m"), max_batch_size=2,
                         device="cpu")
    try:
        assert server.slo_ms_per_token == 5.0
        engine = server._fleet.pool.replicas[0]._engines["1"]
        assert engine.slo_ms_per_token == 5.0
    finally:
        server.stop()


def test_a_payload_without_a_decode_contract_is_refused_at_the_canary(
        tmp_path, flax_params):
    from tpu_pipelines_torch.models.bert import build_bert_model, init_bert_weights
    from tpu_pipelines_torch.serving.fleet import CanaryRefused, ServingFleet

    base = tmp_path / "m"
    d1 = _port_payload(base, 1, flax_params)
    hp = {"vocab_size": 64, "d_model": 32, "n_layers": 1, "n_heads": 2,
          "d_ff": 64, "max_len": 16, "num_classes": 2, "attn_impl": "dense"}
    export_model(serving_model_dir=str(base / "2"),
                 params=init_bert_weights(
                     build_bert_model(hp),
                     __import__("torch").Generator().manual_seed(0)
                 ).state_dict(),
                 module_file=PORT_BERT_MODULE, hyperparameters=hp)
    fleet = ServingFleet("t5", str(base), replicas=1, model_type="generative",
                         max_batch_size=2, device="cpu")
    try:
        fleet.load_version(d1)
        with pytest.raises(CanaryRefused, match="make_decode_fns"):
            fleet.load_version(str(base / "2"))
        assert fleet.active_version == "1"
    finally:
        fleet.close()


def test_a_killed_replicas_streams_are_recovered_on_its_peer(tmp_path,
                                                            flax_params):
    """KILL_REPLICA mid-decode on a supervised generative fleet: the
    request's sequences are re-prefilled onto the surviving replica and
    come back equal to an undisturbed decode; the dead replica is ejected,
    rebuilt (its engine re-warmed) and serves again."""
    from tpu_pipelines_torch.serving.fleet import ServingFleet

    base = tmp_path / "m"
    d1 = _port_payload(base, 1, flax_params)
    reg = MetricsRegistry()
    fleet = ServingFleet("t5", str(base), replicas=2, max_versions=1,
                         model_type="generative", max_batch_size=2,
                         registry=reg, supervisor_interval_s=3600.0,
                         device="cpu")
    batch = {"inputs": np.asarray([[5, 9, 17, 4], [22, 8, 0, 0]], np.int32),
             "input_mask": np.asarray([[1, 1, 1, 1], [1, 1, 0, 0]], np.int32)}
    try:
        fleet.load_version(d1)
        clean = fleet.generate_submit(batch, {"max_new_tokens": 8})
        plan = faults.FaultPlan({faults.REPLICA_KEY: faults.NodeFault(
            faults.KILL_REPLICA)})
        with plan.activate():
            out = fleet.generate_submit(batch, {"max_new_tokens": 8})
            np.testing.assert_array_equal(out, clean)
            assert reg.get("serving_decode_sessions_recovered_total").get() >= 1
            killed = [e for _, e in plan.log if e.startswith("kill_replica:")]
            assert len(killed) == 1
            for _ in range(3):
                fleet.supervisor.probe_once()
            assert fleet.health()["replica_states"] == {"0": "healthy",
                                                        "1": "healthy"}
            for _ in range(4):
                np.testing.assert_array_equal(
                    fleet.generate_submit(batch, {"max_new_tokens": 8}), clean)
        assert fleet.health()["outstanding_decode_tokens"] == 0
    finally:
        fleet.close()
