"""The port's captured-step dispatch (``AotDispatch``, ``serving/aot.py``)
on the CPU, against the JAX package's.

The signature and the fallback accounting are exact ports: the same
inputs give the same tuples and counts.  On the CPU ``warm_loaded`` runs
the reference's legacy warm-up (one predict per bucket, nothing
installed), as the reference does for a payload it cannot compile ahead:
the same buckets, ``fallback_warm`` True.  The graphs themselves (one per
bucket on CUDA) are held against the eager step bit for bit in
``tests/test_torch_kernels_gpu.py``.
"""

import os

import numpy as np
import pytest
import torch

from tpu_pipelines.serving import aot as jax_aot
from tpu_pipelines.trainer.export import AotDispatch as JaxDispatch
from tpu_pipelines_torch.serving import aot
from tpu_pipelines_torch.trainer.export import (
    AotDispatch,
    export_model,
    load_exported_model,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_BERT_MODULE = os.path.join(REPO, "tpu_pipelines_torch", "examples",
                                "bert_module.py")
HP = {"vocab_size": 64, "d_model": 32, "n_layers": 1, "n_heads": 2,
      "d_ff": 64, "max_len": 16, "num_classes": 2, "attn_impl": "flash"}

BATCHES = [
    {"input_ids": np.zeros((4, 16), np.int64),
     "attention_mask": np.ones((4, 16), np.int32)},
    {"x": np.zeros((2, 3), np.float32), "label": np.arange(2)},
    {"tokens": np.asarray([b"a", b"bc"]), "w": np.zeros((1,), np.float64)},
    {"bool": np.ones((3, 1), bool)},
]


@pytest.mark.parametrize("batch", BATCHES)
def test_signature_equals_the_references(batch):
    assert AotDispatch.signature(batch) == JaxDispatch.signature(batch)
    # A tensor feature signs like the numpy array it holds.
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()
               if v.dtype.kind != "S"}
    numpy = {k: v for k, v in batch.items() if v.dtype.kind != "S"}
    assert AotDispatch.signature(tensors) == JaxDispatch.signature(numpy)


def test_record_fallback_counts_the_first_miss_per_signature_only():
    seen = {}
    for cls in (JaxDispatch, AotDispatch):
        d = cls()
        fired = []
        d.on_compile_after_warm = lambda: fired.append(1)
        for endpoint, batch in [("raw", BATCHES[0]), ("raw", BATCHES[0]),
                                ("transformed", BATCHES[0]),
                                ("raw", BATCHES[1]), ("raw", BATCHES[0])]:
            assert d.lookup(endpoint, batch) is None
            d.record_fallback(endpoint, batch)
        seen[cls.__name__ + cls.__module__] = (
            d.fallbacks, d.compiles_after_warm, len(fired))
    assert list(seen.values()) == [(5, 3, 3), (5, 3, 3)]


def _port_payload(path):
    from tpu_pipelines_torch.models.bert import build_bert_model, init_bert_weights

    model = init_bert_weights(build_bert_model(HP),
                              torch.Generator().manual_seed(0))
    export_model(serving_model_dir=str(path), params=model.state_dict(),
                 module_file=PORT_BERT_MODULE, hyperparameters=HP)
    return str(path)


class _Stub:
    """A payload without step handles: the reference's legacy warm path."""

    def __init__(self):
        self.calls = []
        self.aot = None

    def predict(self, batch):
        self.calls.append(len(batch["x"]))
        return np.asarray(batch["x"])

    predict_transformed = predict


@pytest.mark.parametrize("max_batch_size", [1, 6, 8])
def test_warm_loaded_on_the_cpu_returns_the_references_buckets(
        tmp_path, max_batch_size):
    batch = {"x": np.ones((3, 2), np.float32)}
    want = jax_aot.warm_loaded(_Stub(), batch, max_batch_size)
    stub = _Stub()
    got = aot.warm_loaded(stub, batch, max_batch_size)
    assert got["buckets"] == want["buckets"]
    assert got["fallback_warm"] is want["fallback_warm"] is True
    assert stub.calls == want["buckets"]
    for key in ("compiled", "cache_hits", "cached_to_disk"):
        assert got[key] == want[key] == 0

    loaded = load_exported_model(_port_payload(tmp_path / "1"), device="cpu")
    rows = {"input_ids": np.arange(1, 33).reshape(2, 16) % 60,
            "attention_mask": np.ones((2, 16), np.int64)}
    before = loaded.predict(rows)
    stats = aot.warm_loaded(loaded, rows, max_batch_size)
    assert stats["buckets"] == want["buckets"]
    assert stats["fallback_warm"] is True and stats["compiled"] == 0
    assert loaded.aot.entries == {}              # a passthrough on the CPU
    np.testing.assert_array_equal(loaded.predict(rows), before)
    assert loaded.aot.compiles_after_warm == 0


@pytest.mark.parametrize("missing", ["aot", "device_step"])
def test_warm_loaded_on_cuda_without_step_handles_raises(missing):
    """On CUDA the warm-up captures or raises: a loaded model without the
    table or the step a capture needs is refused before any predict runs
    (the check reads attributes only, so it runs without a card)."""
    stub = _Stub()
    stub.device = torch.device("cuda")
    stub.aot = None if missing == "aot" else AotDispatch()
    stub.device_step = None if missing == "device_step" else stub.predict
    with pytest.raises(RuntimeError, match=f"no '{missing}'"):
        aot.warm_loaded(stub, {"x": np.ones((3, 2), np.float32)}, 8)
    assert stub.calls == []


def test_dispatch_runs_an_installed_step_and_counts_a_miss(tmp_path):
    """An installed entry answers its signature (the replay's place on the
    card); a miss after warm-up runs the eager step and counts once."""
    loaded = load_exported_model(_port_payload(tmp_path / "1"), device="cpu")
    assert loaded.uri == str(tmp_path / "1")
    assert loaded.host_preprocess({"a": 1}) == {"a": 1}
    assert loaded.draft_decode_fns is None and loaded.draft_params is None
    rows = {"input_ids": np.arange(1, 33).reshape(2, 16) % 60,
            "attention_mask": np.ones((2, 16), np.int64)}
    eager = loaded.predict(rows)
    calls = []

    def step(params, batch):
        calls.append(AotDispatch.signature(batch))
        return loaded.device_step(params, batch)

    loaded.aot.install("raw", AotDispatch.signature(rows), step)
    np.testing.assert_array_equal(loaded.predict(rows), eager)
    assert calls == [AotDispatch.signature(rows)]
    other = {k: v[:1] for k, v in rows.items()}
    want = loaded.device_step(loaded.params, other).numpy()
    for _ in range(2):
        np.testing.assert_array_equal(loaded.predict(other), want)
    assert loaded.aot.compiles_after_warm == 1 and loaded.aot.fallbacks == 2
    # predict_transformed has its own endpoint: a miss there counts too.
    np.testing.assert_array_equal(loaded.predict_transformed(rows), eager)
    assert loaded.aot.compiles_after_warm == 2


def test_payload_fingerprint_and_cache_key_follow_the_reference(tmp_path):
    payload = _port_payload(tmp_path / "1")
    fp = aot.payload_fingerprint(payload)
    assert fp == jax_aot.payload_fingerprint(payload)
    assert aot.payload_fingerprint(_port_payload(tmp_path / "2")) == fp
    sig = AotDispatch.signature(BATCHES[0])
    key = aot.cache_key(fp, 4, "float32", "H100", "raw", sig)
    assert key == aot.cache_key(fp, 4, "float32", "H100", "raw", sig)
    assert key != aot.cache_key(fp, 8, "float32", "H100", "raw", sig)
