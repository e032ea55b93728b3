"""The generative engine's decode levers on the CPU, held against the JAX
package's engine: the prefix cache, chunked prefill, speculative decoding
(self-draft and a deliberately wrong draft) and per-token deadlines.

The tiny T5 of ``tests/torch_t5_tiny.py`` (2 + 2 layers, d_model 16, f32),
its flax params carried into the port.  The port's decode attention runs
through the flash-decode wrapper (its plain version on the CPU), the
reference's dense.  Tolerances: the verify window's logits against k
chained steps (rtol, atol) = (1e-5, 1e-5), the reference test's; against
the reference's verify logits (2e-5, 2e-5), the JAX package's decode
tolerance.  Token streams are compared exactly, the port's against the
reference engine's under the same levers and against the port's own
lever-off streams, at ``page_size=0`` (one KV bucket: the reference's
bitwise mode).
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_t5_tiny as tiny
from tpu_pipelines.models import t5 as jt5
from tpu_pipelines.observability.metrics import MetricsRegistry as RefRegistry
from tpu_pipelines.serving import generative as jgen
from tpu_pipelines_torch.models import t5 as pt5
from tpu_pipelines_torch.observability.metrics import MetricsRegistry
from tpu_pipelines_torch.serving import generative as pgen

L = 8
IN_LEN = 6
VERIFY_TOL = dict(rtol=1e-5, atol=1e-5)

LEVERS = {
    "off": {},
    "prefix_cache": {"prefix_cache_entries": 8},
    "chunked_prefill": {"prefill_chunk_pages": 1},
    "spec_self_draft": {"spec_tokens": 3},
    "loose_deadline": {"slo_ms_per_token": 60_000.0, "hard_deadline": True},
    "all": {"prefix_cache_entries": 8, "prefill_chunk_pages": 1,
            "spec_tokens": 2, "slo_ms_per_token": 60_000.0,
            "hard_deadline": True},
}


@pytest.fixture(scope="module")
def flax_params():
    return tiny.flax_params()


@pytest.fixture(scope="module")
def port(flax_params):
    model, params = tiny.port_model(flax_params, "flash")
    fns = pt5.make_continuous_decode_fns(model, max_decode_len=L, eos_id=1,
                                         max_input_len=IN_LEN)
    return model, params, fns


def _prompts(seed=3):
    """Five distinct prompts, then the first one twice more (prefix hits)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(2, 40, size=(5,)).astype(np.int32)
    return [shared] + [
        rng.integers(2, 40, size=(int(rng.integers(2, 7)),)).astype(np.int32)
        for _ in range(4)
    ] + [shared, shared]


def _run(engine, prompts):
    try:
        engine.warm()
        handles = [engine.submit_nowait(p, max_new_tokens=L) for p in prompts]
        return [[int(t) for t in h.wait(120.0)] for h in handles]
    finally:
        engine.close()


def _port_streams(port, prompts, **levers):
    _, params, fns = port
    engine = pgen.GenerativeEngine(fns, params, max_batch_size=4,
                                   device="cpu", **levers)
    return _run(engine, prompts), engine


@pytest.fixture(scope="module")
def port_off(port):
    return _port_streams(port, _prompts())[0]


def test_t5_verify_matches_chained_steps(flax_params, port):
    """The port's verify window (one decoder pass over k fed tokens) equals
    k chained single-token steps, and the reference's verify window."""
    _, params, fns = port
    jfns = jt5.make_continuous_decode_fns(
        tiny.jax_model(), max_decode_len=L, eos_id=1, max_input_len=IN_LEN)
    inputs = np.asarray([[5, 9, 12, 3, 0, 0]], np.int32)
    mask = np.asarray([[1, 1, 1, 1, 0, 0]], np.int32)
    with torch.no_grad():
        cache0, encoded, logits0 = fns.prefill(
            params, torch.from_numpy(inputs), torch.from_numpy(mask))
    t0 = int(logits0[0].argmax())
    k = 3
    cache = {n: x.clone() for n, x in cache0.items()}
    fed, step_logits = [t0], []
    with torch.no_grad():
        for j in range(k):
            cache, lg = fns.step(params, cache, torch.tensor([fed[-1]]),
                                 torch.tensor([j + 1]), encoded,
                                 torch.from_numpy(mask), L)
            step_logits.append(lg[0].numpy())
            fed.append(int(lg[0].argmax()))
        vcache = {n: x.clone() for n, x in cache0.items()}
        vcache, vlogits = fns.verify(params, vcache, torch.tensor([fed[:k]]),
                                     torch.tensor([1]), encoded,
                                     torch.from_numpy(mask), L)
    vlogits = vlogits[0].numpy()
    assert vlogits.shape == (k, step_logits[0].shape[-1])
    for j in range(k):
        np.testing.assert_allclose(vlogits[j], step_logits[j], **VERIFY_TOL)
        assert int(vlogits[j].argmax()) == int(step_logits[j].argmax())
    # The window's K/V landed where the chained steps put theirs.
    for name in cache:
        np.testing.assert_allclose(vcache[name].numpy(), cache[name].numpy(),
                                   **VERIFY_TOL, err_msg=name)
    jc, je, _ = jfns.prefill(flax_params, inputs, mask)
    _, jv = jfns.verify(flax_params, jc, jnp.asarray([fed[:k]], jnp.int32),
                        jnp.asarray([1], jnp.int32), je, mask, L)
    np.testing.assert_allclose(vlogits, np.asarray(jv)[0], **tiny.TOL)


@pytest.mark.parametrize("lever", sorted(LEVERS))
def test_each_lever_streams_equal_the_reference_engine(flax_params, port,
                                                       port_off, lever):
    prompts = _prompts()
    got, engine = _port_streams(port, prompts, **LEVERS[lever])
    jfns = jt5.make_continuous_decode_fns(
        tiny.jax_model(), max_decode_len=L, eos_id=1, max_input_len=IN_LEN)
    want = _run(jgen.GenerativeEngine(jfns, flax_params, max_batch_size=4,
                                      **LEVERS[lever]), prompts)
    assert got == want
    assert got == port_off
    assert engine.compiles_after_warm == 0
    if "prefix_cache_entries" in LEVERS[lever]:
        # Five distinct prompts miss, the two repeats hit.
        assert (engine._prefix.hits, engine._prefix.misses) == (2, 5)
    if "spec_tokens" in LEVERS[lever]:
        assert engine.spec_proposed > 0
    if "hard_deadline" in LEVERS[lever]:
        assert engine.evictions == 0


def test_self_draft_accepts_every_proposal(port, port_off):
    reg = MetricsRegistry()
    _, params, fns = port
    engine = pgen.GenerativeEngine(fns, params, max_batch_size=4,
                                   device="cpu", spec_tokens=4,
                                   registry=reg, replica="0")
    got = _run(engine, _prompts())
    assert got == port_off
    assert engine.spec_proposed > 0
    assert engine.spec_accepted == engine.spec_proposed
    proposed = reg.get("serving_decode_spec_proposed_total").labels("0").get()
    assert proposed == engine.spec_proposed
    assert reg.get("serving_decode_spec_accept_ratio").labels("0").get() == 1.0


def test_a_wrong_draft_still_gives_the_greedy_tokens(port, port_off):
    """A draft whose weights are perturbed proposes other tokens; every
    emitted token is still the target's greedy choice."""
    _, params, fns = port
    g = torch.Generator().manual_seed(0)
    draft_params = {
        n: t + 0.5 * torch.randn(t.shape, generator=g) if t.is_floating_point()
        else t
        for n, t in params.items()
    }
    engine = pgen.GenerativeEngine(fns, params, max_batch_size=4,
                                   device="cpu", spec_tokens=3,
                                   draft_params=draft_params)
    got = _run(engine, _prompts())
    assert got == port_off
    assert engine.spec_proposed > 0
    assert engine.spec_accepted < engine.spec_proposed


def test_the_accept_scrubs_rejected_kv(port):
    """The speculative accept sets both lanes' tokens and positions and
    zeroes every self-attention cache position at or past a row's new
    position; the cross-attention K/V are untouched."""
    _, params, fns = port
    engine = pgen.GenerativeEngine(fns, params, max_batch_size=4,
                                   device="cpu", spec_tokens=3)
    try:
        engine.warm()
        new_tok = np.array([7, 9, 0, 0], np.int64)
        new_pos = np.array([3, 5, 0, 8], np.int64)
        for lane in (engine._target, engine._draft):
            cache = lane.arena[0]
            with torch.inference_mode():  # the arena holds inference tensors
                for a in cache.values():
                    a.fill_(1.0)
                engine._sync_lane(lane, new_tok, new_pos)
            _, tok, pos, _, _, _ = lane.arena
            assert tok.tolist() == new_tok.tolist()
            assert pos.tolist() == new_pos.tolist()
            for name, a in cache.items():
                if "cached_enc" in name:
                    assert bool((a == 1).all()), name
                    continue
                for row, p in enumerate(new_pos):
                    assert bool((a[row, :p] == 1).all()), (name, row)
                    assert not a[row, p:].any(), (name, row)
    finally:
        engine.close()


def test_prefix_cache_keys_refcount_and_trim_match_the_reference():
    ops = [
        ("insert", [3, 5, 7, 0], [1, 1, 1, 0]), ("acquire", 0), ("acquire", 0),
        ("insert", [4, 4, 4, 4], [1, 1, 1, 1]),
        ("insert", [8, 8, 0, 0], [1, 1, 0, 0]),
        ("release", 0), ("insert", [8, 8, 9, 0], [1, 1, 0, 0]),
        ("release", 0), ("insert", [1, 2, 3, 4], [1, 1, 1, 1]),
    ]

    def play(cls):
        cache = cls(capacity=1, page=2)
        entries, states = [], []
        for op in ops:
            if op[0] == "insert":
                key, pages = cls.key_of(np.asarray(op[1], np.int64),
                                        np.asarray(op[2]), 2)
                entries.append(cache.insert(key, pages, tok0=len(entries),
                                            cache={}, encoded=None))
            elif op[0] == "acquire":
                cache.acquire(entries[op[1]])
            else:
                cache.release(entries[op[1]])
            states.append((
                sorted((e.key, e.pages, e.readers, e.tok0)
                       for e in cache._entries.values()),
                cache.pages_in_use(), len(cache)))
        return states

    assert play(pgen.PrefixCache) == play(jgen.PrefixCache)


def test_a_hard_deadline_evicts_with_generation_evicted(port):
    _, params, fns = port
    reg = MetricsRegistry()
    prompt = _prompts()[1]
    engine = pgen.GenerativeEngine(fns, params, max_batch_size=2,
                                   device="cpu", slo_ms_per_token=1e-6,
                                   hard_deadline=True, registry=reg,
                                   replica="0")
    try:
        engine.warm()
        h = engine.submit_nowait(prompt, max_new_tokens=L)
        with pytest.raises(pgen.GenerationEvicted, match="deadline"):
            h.wait(60.0)
        assert reg.get("serving_decode_evicted_total").labels("0").get() == 1
        assert engine.evictions == 1
        deadline = time.monotonic() + 5
        while not engine.idle() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert engine.idle()  # the slot was freed
    finally:
        engine.close()
    # The same SLO without hard_deadline only prices the deadline.
    engine2 = pgen.GenerativeEngine(fns, params, max_batch_size=2,
                                    device="cpu", slo_ms_per_token=1e-6)
    try:
        assert len(engine2.submit(prompt, max_new_tokens=L,
                                  timeout_s=60.0)) >= 1
        assert engine2.evictions == 0
    finally:
        engine2.close()


def test_the_decode_telemetry_families_are_the_references(port):
    """The port's engine registers the reference engine's metric families,
    with the same types and labels."""
    _, params, fns = port
    reg = MetricsRegistry()
    engine = pgen.GenerativeEngine(fns, params, device="cpu", registry=reg,
                                   replica="0")
    engine.close()
    ref = RefRegistry()
    jgen.DecodeTelemetry(ref, "0")

    def families(r):
        return {n: (p["type"], tuple(p["labels"]))
                for n, p in r.snapshot().items()}

    assert families(reg) == families(ref)


@pytest.mark.parametrize("levers", [{}, {"spec_tokens": 2,
                                         "prefix_cache_entries": 4}],
                         ids=["off", "spec_prefix"])
def test_decode_spans_match_the_reference_engine(flax_params, port, levers):
    """A traced sequence emits the reference engine's decode events: the
    same (kind, name) multiset per request, each a child of the request's
    root span."""
    from tpu_pipelines.observability import request_trace as ref_rt
    from tpu_pipelines_torch.observability import request_trace as port_rt

    _, params, fns = port
    jfns = jt5.make_continuous_decode_fns(
        tiny.jax_model(), max_decode_len=L, eos_id=1, max_input_len=IN_LEN)
    engines = {
        "ref": (ref_rt, lambda: jgen.GenerativeEngine(
            jfns, flax_params, max_batch_size=4, **levers)),
        "port": (port_rt, lambda: pgen.GenerativeEngine(
            fns, params, max_batch_size=4, device="cpu", **levers)),
    }
    prompts = _prompts()[:3] + _prompts()[:1]
    got = {}
    for side, (rt, make) in engines.items():
        tracer = rt.RequestTracer("all")
        engine = make()
        try:
            engine.warm()
            ctxs = [tracer.start("generate") for _ in prompts]
            # One at a time: the rounds a sequence rides depend on its
            # company, so each runs alone.
            for p, ctx in zip(prompts, ctxs):
                engine.submit_nowait(p, max_new_tokens=L, ctx=ctx).wait(120.0)
        finally:
            engine.close()
            tracer.close()
        events = tracer.events()
        got[side] = [sorted((e["ev"], e["name"]) for e in events
                            if e["trace"] == c.trace_id) for c in ctxs]
        assert all(e["parent"] == c.root_span for c in ctxs for e in events
                   if e["trace"] == c.trace_id)
    assert got["port"] == got["ref"]
    assert ("span", "decode") in got["port"][0]
    assert ("span", "decode.join") in got["port"][0]


def test_a_generative_fleet_with_every_lever_answers_as_the_jax_fleet(
        tmp_path, flax_params, monkeypatch):
    """``ModelServer(model_type="generative")`` with the prefix cache,
    chunked prefill, speculation and a per-token SLO passes the levers to
    its replicas' engines and answers ``:generate`` with the JAX fleet's
    streams under the same levers (the reference's server has no
    ``hard_deadline`` knob; the port's SLO is loose here)."""
    import test_torch_generative_fleet as tgf
    from tpu_pipelines.serving import ModelServer as JaxServer
    from tpu_pipelines.trainer.export import export_model as jax_export_model
    from tpu_pipelines_torch.serving.server import ModelServer

    monkeypatch.setenv("TPP_AOT_CACHE", str(tmp_path / "aot_cache"))
    jax_export_model(serving_model_dir=str(tmp_path / "jax" / "1"),
                     params=flax_params, module_file=tgf.JAX_T5_MODULE,
                     hyperparameters=tgf.HP)
    tgf._port_payload(tmp_path / "port", 1, flax_params, attn_impl="flash")
    levers = dict(prefix_cache_entries=16, prefill_chunk_pages=1,
                  spec_tokens=2, slo_ms_per_token=60_000.0)
    # The repeats hit the one replica's prefix cache.
    requests = tgf._requests() + tgf._requests()[:2]
    replies = {}
    for name, make in (
            ("jax", lambda: JaxServer("t5", str(tmp_path / "jax"),
                                      model_type="generative",
                                      max_batch_size=2, **levers)),
            ("port", lambda: ModelServer("t5", str(tmp_path / "port"),
                                         model_type="generative",
                                         max_batch_size=2, hard_deadline=True,
                                         device="cpu", **levers))):
        server = make()
        try:
            url = f"http://127.0.0.1:{server.start()}/v1/models/t5:generate"
            replies[name] = [tgf._post(url, r)[1]["outputs"] for r in requests]
            if name == "port":
                engines = [e for r in server._fleet.pool.replicas
                           for e in r._engines.values()]
        finally:
            server.stop()
    assert replies["port"] == replies["jax"]
    assert all(e.spec_tokens == 2 and e.hard_deadline and e._prefix
               for e in engines)
    assert sum(e.spec_proposed for e in engines) > 0
    assert sum(e._prefix.hits for e in engines) > 0
