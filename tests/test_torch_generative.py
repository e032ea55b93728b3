"""The port's continuous-batching decode on the CPU: the decode contract's
step against the JAX package's, and the generative engine.

The tiny T5 of ``tests/torch_t5_tiny.py`` (2 + 2 layers, d_model 16, f32),
its flax params carried into the port by ``t5_state_dict_from_flax``.
``:generate`` over HTTP is in ``tests/test_torch_t5_serving.py``.

Tolerances: the contract's step, logits and cache leaves (rtol, atol) =
(2e-5, 2e-5), the JAX package's own decode tolerance.  Token streams are
compared exactly: the engine's against the port's isolated greedy decode
of each prompt (on the CPU the per-row math does not depend on the batch
or on the KV bucket it ran in).
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_t5_tiny as tiny
from tpu_pipelines.models import t5 as jt5
from tpu_pipelines_torch.models import t5 as pt5
from tpu_pipelines_torch.observability.metrics import MetricsRegistry
from tpu_pipelines_torch.serving.generative import (
    EngineOverloaded,
    GenerativeEngine,
    kv_bucket_sizes,
)

TINY = tiny.TINY
TOL = tiny.TOL
L = 8


@pytest.fixture(scope="module")
def flax_params():
    return tiny.flax_params()


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_continuous_step_matches_jax_at_a_kv_bucket(flax_params, attn_impl):
    """Prefill two prompts, then one step with per-row positions over the
    first ``kv`` cache positions (the engine's bucket slice)."""
    jfns = jt5.make_continuous_decode_fns(
        jt5.T5(**TINY, dtype=jnp.float32, attn_impl=attn_impl),
        max_decode_len=L, eos_id=1, max_input_len=6)
    model, params = tiny.port_model(flax_params, attn_impl)
    pfns = pt5.make_continuous_decode_fns(model, max_decode_len=L, eos_id=1,
                                          max_input_len=6)
    inputs = np.array([[5, 9, 3, 2, 0, 0], [11, 4, 8, 1, 2, 3]], np.int32)
    mask = (inputs > 0).astype(np.int32)
    jcache, jenc, jlogits0 = jax.jit(jfns.prefill)(flax_params, inputs, mask)
    with torch.no_grad():
        tcache, tenc, tlogits0 = pfns.prefill(
            params, torch.from_numpy(inputs), torch.from_numpy(mask))
    np.testing.assert_allclose(tlogits0.numpy(), np.asarray(jlogits0), **TOL)

    kv = 4
    pos = np.array([1, 3], np.int32)
    tok = np.array([7, 12], np.int32)
    jsub = jax.tree_util.tree_map_with_path(
        lambda p, x: x if "cached_enc" in jax.tree_util.keystr(p) else x[:, :kv],
        jcache)
    jnew, jlogits = jax.jit(jfns.step, static_argnums=6)(
        flax_params, jsub, tok, pos, jenc, mask, kv)
    # The port writes this step's K/V through [:, :kv] views of its cache.
    tsub = {n: x if "cached_enc" in n else x[:, :kv] for n, x in tcache.items()}
    with torch.no_grad():
        tnew, tlogits = pfns.step(params, tsub, torch.from_numpy(tok).long(),
                                  torch.from_numpy(pos).long(), tenc,
                                  torch.from_numpy(mask), kv)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    for name, value in tiny.flat(jnew).items():
        np.testing.assert_allclose(tnew[name].numpy(), value, **TOL,
                                   err_msg=name)
        if "cached_enc" not in name:
            assert tnew[name].data_ptr() == tcache[name].data_ptr()
            np.testing.assert_array_equal(tcache[name][:, :kv].numpy(),
                                          tnew[name].numpy())


def _isolated_greedy(model, params, prompts, eos_id):
    greedy = pt5.make_greedy_generate(model, max_decode_len=L, eos_id=eos_id)
    out = []
    for p in prompts:
        with torch.no_grad():
            toks, _ = greedy(params, torch.from_numpy(p[None]),
                             torch.ones((1, len(p)), dtype=torch.int32))
        row = toks[0].tolist()
        out.append(row[: row.index(eos_id) + 1] if eos_id in row else row)
    return out


@pytest.mark.parametrize("page_size", [0, 4])
def test_engine_streams_equal_isolated_greedy(flax_params, page_size):
    model, params = tiny.port_model(flax_params, "flash")
    fns = pt5.make_continuous_decode_fns(model, max_decode_len=L, eos_id=1,
                                         max_input_len=6)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, 40, size=(int(rng.integers(2, 7)),)).astype(
        np.int32) for _ in range(8)]
    want = _isolated_greedy(model, params, prompts, eos_id=1)
    registry = MetricsRegistry()
    engine = GenerativeEngine(fns, params, max_batch_size=4,
                              page_size=page_size, device="cpu",
                              registry=registry)
    try:
        engine.warm()
        assert engine.steps_run == 0 and engine.prefills_run == 0
        handles = []
        for i, p in enumerate(prompts):
            handles.append(engine.submit_nowait(p, max_new_tokens=L))
            if i % 3 == 0:
                time.sleep(0.01)
        got = [h.wait(60.0).tolist() for h in handles]
    finally:
        engine.close()
    assert got == want
    assert engine.compiles_after_warm == 0
    assert engine.prefills_run == len(prompts)
    assert engine.steps_run > 0 and engine.idle()
    assert engine.kv_buckets == ([L] if page_size == 0 else [4, 8])
    text = registry.to_prometheus()
    tokens = sum(len(g) - 1 for g in got)    # the first comes from prefill
    assert f'serving_decode_tokens_total{{replica="0"}} {tokens}' in text
    assert f'serving_decode_sequences_total{{replica="0"}} {len(prompts)}' in text


def test_kv_buckets_and_the_buckets_a_step_picks(flax_params):
    assert kv_bucket_sizes(32, 0) == [32]
    assert kv_bucket_sizes(32, 4) == [4, 8, 16, 32]
    assert kv_bucket_sizes(32, 64) == [32]
    assert kv_bucket_sizes(20, 8) == [8, 16, 20]
    with pytest.raises(ValueError):
        kv_bucket_sizes(0, 4)
    model, params = tiny.port_model(flax_params)
    # eos -1 never fires: the sequence runs its whole budget.
    fns = pt5.make_continuous_decode_fns(model, max_decode_len=L, eos_id=-1,
                                         max_input_len=6)
    engine = GenerativeEngine(fns, params, max_batch_size=4, page_size=2,
                              device="cpu")
    try:
        out = engine.submit(np.array([5, 9, 3]), max_new_tokens=4)
    finally:
        engine.close()
    assert len(out) == 4
    # Token i (i >= 1) is decoded at position i: kv buckets 2, 4, 4.
    assert engine._buckets_run == {(1, 2), (1, 4)}
    assert engine.steps_run == 3 and engine.compiles_after_warm == 0


def test_token_admission_refuses_past_max_queue_tokens(flax_params):
    model, params = tiny.port_model(flax_params)
    fns = pt5.make_continuous_decode_fns(model, max_decode_len=L, eos_id=-1,
                                         max_input_len=6)
    entered, release = threading.Event(), threading.Event()
    real_prefill = fns.prefill

    def held_prefill(p, ids, mask):
        entered.set()
        assert release.wait(30)
        return real_prefill(p, ids, mask)

    fns.prefill = held_prefill
    registry = MetricsRegistry()
    engine = GenerativeEngine(fns, params, max_batch_size=2,
                              max_queue_tokens=10, device="cpu",
                              registry=registry)
    try:
        first = engine.submit_nowait(np.array([5, 9]), max_new_tokens=8)
        assert entered.wait(30)           # the worker holds the first one
        second = engine.submit_nowait(np.array([4, 4]), max_new_tokens=8)
        assert engine.outstanding_tokens() == 8
        with pytest.raises(EngineOverloaded):
            engine.submit_nowait(np.array([6]), max_new_tokens=3)
        with pytest.raises(ValueError, match="max_new_tokens"):
            engine.submit_nowait(np.array([6]), max_new_tokens=L + 1)
        with pytest.raises(ValueError, match="input length"):
            engine.submit_nowait(np.arange(2, 9), max_new_tokens=2)
        release.set()
        assert len(first.wait(60)) == 8 and len(second.wait(60)) == 8
    finally:
        release.set()
        engine.close()
    assert 'serving_decode_shed_total{replica="0"} 1' in registry.to_prometheus()
    with pytest.raises(RuntimeError, match="closed"):
        engine.submit_nowait(np.array([5]))


@pytest.mark.parametrize("option, value", [
    ("prefix_cache_entries", 4),
    ("prefill_chunk_pages", 1),
    ("spec_tokens", 2),
    ("draft_fns", object()),
    ("slo_ms_per_token", 5.0),
    ("hard_deadline", True),
    ("fault_hook", lambda: None),
])
def test_deferred_engine_options_raise_naming_a8(flax_params, option, value):
    model, params = tiny.port_model(flax_params)
    fns = pt5.make_continuous_decode_fns(model, max_decode_len=L)
    with pytest.raises(NotImplementedError, match="A8"):
        GenerativeEngine(fns, params, device="cpu", **{option: value})


def test_engine_defaults_to_cuda_and_raises_without_it(flax_params,
                                                       monkeypatch):
    model, params = tiny.port_model(flax_params)
    fns = pt5.make_continuous_decode_fns(model, max_decode_len=L)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GenerativeEngine(fns, params)
