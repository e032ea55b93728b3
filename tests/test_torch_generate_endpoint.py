"""The port's ``:generate`` route and generate hooks on the CPU, without
the JAX reference: a payload without a generate hook (BERT) answers 400,
concurrent whole-request decodes run one at a time, and the legacy
``make_generate_fn`` hook still gives ``LoadedModel.generate``.  Replies
against the JAX payload's beam search are in
``tests/test_torch_t5_serving.py``.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tpu_pipelines_torch.models import t5 as pt5
from tpu_pipelines_torch.models.bert import build_bert_model, init_bert_weights
from tpu_pipelines_torch.serving.server import ModelServer
from tpu_pipelines_torch.trainer.export import export_model, load_exported_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_T5_MODULE = os.path.join(REPO, "tpu_pipelines_torch", "examples",
                              "t5_module.py")
PORT_BERT_MODULE = os.path.join(REPO, "tpu_pipelines_torch", "examples",
                                "bert_module.py")
TINY = dict(vocab_size=48, d_model=16, n_layers=2, n_heads=2, head_dim=16,
            d_ff=32, dropout_rate=0.0)


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


def test_generate_on_a_payload_without_a_generate_hook_is_400(tmp_path):
    hp = {"vocab_size": 64, "d_model": 32, "n_layers": 1, "n_heads": 2,
          "d_ff": 64, "max_len": 16, "num_classes": 2, "attn_impl": "dense"}
    model = init_bert_weights(build_bert_model(hp),
                              torch.Generator().manual_seed(0))
    export_model(serving_model_dir=str(tmp_path / "1"),
                 params=model.state_dict(), module_file=PORT_BERT_MODULE,
                 hyperparameters=hp)
    assert load_exported_model(str(tmp_path / "1"), device="cpu").generate is None
    server = ModelServer("bert", str(tmp_path), device="cpu")
    try:
        url = f"http://127.0.0.1:{server.start(port=0)}/v1/models/bert:generate"
        assert _post_code(url, {"instances": [{"input_ids": [5, 6, 0]}]}) == 400
        assert _post_code(url, {"instances": []}) == 400
    finally:
        server.stop()


def test_whole_request_decodes_run_one_at_a_time(tmp_path):
    """Concurrent ``:generate`` requests reach the payload's decode one at a
    time (each is a host-driven loop; side by side they only contend for
    the interpreter lock)."""
    hp = {**TINY, "attn_impl": "dense", "beam_size": 1, "max_decode_len": 2}
    model = pt5.init_t5_weights(pt5.build_t5_model(hp),
                                torch.Generator().manual_seed(0))
    export_model(serving_model_dir=str(tmp_path / "1"),
                 params=model.state_dict(), module_file=PORT_T5_MODULE,
                 hyperparameters=hp)
    server = ModelServer("t5", str(tmp_path), device="cpu")
    active, most = [0], [0]
    lock = threading.Lock()

    def decode(batch):
        with lock:
            active[0] += 1
            most[0] = max(most[0], active[0])
        time.sleep(0.05)
        with lock:
            active[0] -= 1
        return np.zeros((len(batch["inputs"]), 2), np.int32)

    try:
        url = f"http://127.0.0.1:{server.start(port=0)}/v1/models/t5:generate"
        server._current_model().generate = decode
        body = {"inputs": {"inputs": [[5, 6, 7]]}}
        with ThreadPoolExecutor(4) as pool:
            replies = list(pool.map(lambda _: _post(url, body), range(8)))
    finally:
        server.stop()
    assert replies == [(200, {"outputs": [[0, 0]]})] * 8
    assert most[0] == 1


def test_legacy_make_generate_fn_hook_closes_over_the_params(tmp_path):
    """A module with the legacy ``make_generate_fn(model, params, hp)`` hook
    (and no ``make_generate_step``) still gets ``LoadedModel.generate``."""
    module = tmp_path / "legacy_t5.py"
    module.write_text(
        "import torch\n"
        "from tpu_pipelines_torch.examples.t5_module import build_model\n"
        "def make_generate_fn(model, params, hyperparameters):\n"
        "    scale = params['shared.weight'][0, 0]\n"
        "    def fn(batch):\n"
        "        n = len(batch['inputs'])\n"
        "        return torch.full((n, 2), 7) + 0 * scale\n"
        "    return fn\n")
    hp = {**TINY, "max_decode_len": 2}
    model = pt5.init_t5_weights(pt5.build_t5_model(hp),
                                torch.Generator().manual_seed(0))
    export_model(serving_model_dir=str(tmp_path / "1"),
                 params=model.state_dict(), module_file=str(module),
                 hyperparameters=hp)
    loaded = load_exported_model(str(tmp_path / "1"), device="cpu")
    out = loaded.generate({"inputs": np.array([[5, 6], [7, 8]], np.int32)})
    assert isinstance(out, np.ndarray) and out.tolist() == [[7, 7], [7, 7]]
    assert loaded.decode_fns is None
