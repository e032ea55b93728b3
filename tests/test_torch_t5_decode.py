"""The port's incremental T5 decode against the JAX package's.

The tiny T5 of ``tests/torch_t5_tiny.py``.  Scalar-position steps from an
empty cache and one vector-position step, under ``attn_impl`` dense and
flash: logits and every decode-cache leaf at (rtol, atol) = (2e-5, 2e-5),
the JAX package's own decode tolerance.  JAX's ``"flash"`` runs the Pallas
decode kernel in interpret mode, the port's its plain version on CPU
tensors.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import torch_t5_tiny as tiny
from tpu_pipelines.models import t5 as jt5
from tpu_pipelines_torch.models import t5 as pt5

TOL = tiny.TOL


@pytest.fixture(scope="module")
def flax_params():
    return tiny.flax_params()


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_incremental_decode_logits_and_caches_match(flax_params, attn_impl):
    """Scalar-position steps from an empty cache, then one vector-position
    step (rows at different positions, the engine's case): logits and
    every cache leaf against the JAX package's."""
    jm = tiny.jax_model(attn_impl)
    jdecode = jax.jit(functools.partial(
        jm.apply, method=jt5.T5.decode, mutable=["cache"]),
        static_argnames=("max_decode_len",))
    model, params = tiny.port_model(flax_params, attn_impl)
    inputs, mask, targets = tiny.batch(seed=2, tgt_len=3)
    max_len = 5
    encoded = jm.apply({"params": flax_params}, inputs, mask,
                       method=jt5.T5.encode)
    dec_in = np.pad(targets, ((0, 0), (1, 0)))[:, :-1]
    t_mask = torch.from_numpy(mask)
    with torch.no_grad():
        t_enc = pt5._apply(model, params, "encode", torch.from_numpy(inputs),
                           t_mask)
    np.testing.assert_allclose(t_enc.numpy(), np.asarray(encoded), **TOL)

    jcache, tcache = None, None
    for t in range(dec_in.shape[1]):
        variables = {"params": flax_params}
        if jcache is not None:
            variables["cache"] = jcache
        want, mut = jdecode(
            variables, dec_in[:, t:t + 1], encoded, enc_mask=mask,
            decode_pos=np.int32(t), max_decode_len=max_len)
        jcache = mut["cache"]
        with torch.no_grad():
            tcache, got = pt5._decode_one(
                model, params, tcache, torch.from_numpy(dec_in[:, t]), t_enc,
                t_mask, t, max_len)
        np.testing.assert_allclose(got.numpy(), np.asarray(want[:, 0]), **TOL)
    jflat = tiny.flat(jcache)
    assert sorted(jflat) == sorted(tcache)
    assert "decoder.layer_0.attn.cached_key" in tcache
    assert "decoder.layer_1.cross.cached_enc_value" in tcache
    for name, value in jflat.items():
        np.testing.assert_allclose(tcache[name].numpy(), value, **TOL,
                                   err_msg=name)

    # One step with per-row positions, from the JAX cache on both sides.
    pos = np.array([3, 1], np.int32)
    tok = np.array([7, 11], np.int32)
    want, mut = jdecode(
        {"params": flax_params, "cache": jcache}, tok[:, None], encoded,
        enc_mask=mask, decode_pos=pos, max_decode_len=max_len)
    tcache = {name: torch.from_numpy(value.copy())
              for name, value in jflat.items()}
    with torch.no_grad():
        logits = pt5._apply(
            model, params, "decode", torch.from_numpy(tok)[:, None], t_enc,
            enc_mask=t_mask, decode_pos=torch.from_numpy(pos).long(),
            max_decode_len=max_len, cache=tcache)
    np.testing.assert_allclose(logits[:, 0].numpy(), np.asarray(want[:, 0]),
                               **TOL)
    for name, value in tiny.flat(mut["cache"]).items():
        np.testing.assert_allclose(tcache[name].numpy(), value, **TOL,
                                   err_msg=name)
