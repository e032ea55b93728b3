"""The tiny T5 the port's T5 tests share (not a test module).

2 + 2 layers, d_model 16, 2 heads of 16, f32, initialised by JAX; its flax
params carried bit for bit into the port by ``t5_state_dict_from_flax``.
``TOL`` is the JAX package's own decode-parity tolerance, (rtol, atol) =
(2e-5, 2e-5): f32 math whose sums the two frameworks order differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpu_pipelines.models import t5 as jt5
from tpu_pipelines_torch.models import t5 as pt5
from tpu_pipelines_torch.models.convert import t5_state_dict_from_flax

TINY = dict(vocab_size=48, d_model=16, n_layers=2, n_heads=2, head_dim=16,
            d_ff=32, dropout_rate=0.0)
TOL = dict(rtol=2e-5, atol=2e-5)


def flax_params():
    model = jt5.T5(**TINY, dtype=jnp.float32)
    batch = {
        "inputs": np.arange(12, dtype=np.int32).reshape(2, 6) % 13 + 2,
        "targets": np.ones((2, 5), np.int32),
    }
    params = jax.jit(model.init)(jax.random.key(0), batch)["params"]
    return jax.tree.map(np.asarray, params)


def jax_model(attn_impl="dense"):
    return jt5.T5(**TINY, dtype=jnp.float32, attn_impl=attn_impl)


def port_model(params, attn_impl="dense"):
    """The port's T5 holding ``params``, and its state dict."""
    model = pt5.T5(**TINY, dtype=torch.float32, attn_impl=attn_impl).eval()
    model.load_state_dict(t5_state_dict_from_flax(params), strict=True)
    return model, dict(model.state_dict())


def batch(seed=1, b=2, enc_len=6, tgt_len=5):
    """(inputs with a padded last row, input_mask, targets), int32."""
    rng = np.random.default_rng(seed)
    inputs = rng.integers(2, 40, size=(b, enc_len)).astype(np.int32)
    inputs[-1, enc_len - 2:] = 0
    return inputs, (inputs > 0).astype(np.int32), rng.integers(
        2, 40, size=(b, tgt_len)).astype(np.int32)


def flat(tree, prefix=""):
    """A nested params or cache tree as {"a.b.c": numpy array}."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        if hasattr(value, "items"):
            out.update(flat(value, name))
        else:
            out[name] = np.asarray(value)
    return out
