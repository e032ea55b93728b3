"""Port parity: the taxi wide-and-deep model, PyTorch vs JAX, on the CPU.

The flax params are initialised by JAX, converted with
``taxi_state_dict_from_flax`` and loaded strictly into the port's module;
both sides then run the same numpy batches (the Transform's output
columns, made from a seed).

Tolerances:
  - logits: 1e-6 — both compute every product in f32 and differ only in
    the order of the sums of three small layers;
  - 20 Adam steps of the taxi loss (sigmoid cross-entropy, lr 1e-3) from
    the same weights on the same batches, against ``optax.adam``: losses
    and final weights within 1e-5 — per step the gradients differ by f32
    sum order and the two update formulas round differently
    (``m_hat / (sqrt(v_hat) + eps)`` against ``(m / bc1) / (sqrt(v) /
    sqrt(bc2) + eps)``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from tpu_pipelines.models import taxi as jax_taxi
from tpu_pipelines_torch.examples import taxi_module
from tpu_pipelines_torch.models import taxi as port_taxi
from tpu_pipelines_torch.models.convert import taxi_state_dict_from_flax

LOGIT_TOL = dict(rtol=1e-6, atol=1e-6)
TRAIN_TOL = dict(rtol=1e-5, atol=1e-5)
HP = dict(port_taxi.DEFAULT_HPARAMS)


def _batch(rng, n=32):
    return {
        "miles_z": rng.normal(size=n).astype(np.float32),
        "fare_01": rng.uniform(size=n).astype(np.float32),
        "log_fare_z": rng.normal(size=n).astype(np.float32),
        "tip_ratio": rng.uniform(size=n).astype(np.float32),
        "company_id": rng.integers(0, 8, size=n).astype(np.int32),
        "hour_bucket": rng.integers(0, 4, size=n).astype(np.int32),
        "payment_onehot": np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)],
        "is_cash": rng.integers(0, 2, size=n).astype(np.float32),
        "label_big_tip": rng.integers(0, 2, size=n).astype(np.float32),
    }


def _models(seed=0):
    rng = np.random.default_rng(seed)
    batch = _batch(rng)
    jmodel = jax_taxi.build_taxi_model(HP)
    params = jmodel.init(jax.random.PRNGKey(seed), batch)["params"]
    params = jax.tree.map(np.asarray, params)
    pmodel = port_taxi.build_taxi_model(HP)
    pmodel.load_state_dict(taxi_state_dict_from_flax(params), strict=True)
    return jmodel, params, pmodel


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_wide_and_deep_logits_match_flax_with_converted_params():
    jmodel, params, pmodel = _models()
    rng = np.random.default_rng(1)
    for n in (1, 7, 64):
        batch = _batch(rng, n)
        want = np.asarray(jmodel.apply({"params": params}, batch))
        with torch.no_grad():
            got = pmodel(_tensors(batch)).numpy()
        assert got.shape == (n,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, **LOGIT_TOL)


def test_state_dict_layout_is_the_documented_one():
    _, params, pmodel = _models()
    sd = taxi_state_dict_from_flax(params)
    assert sorted(sd) == sorted(pmodel.state_dict())
    assert "embeds.embed_company_id.weight" in sd
    np.testing.assert_array_equal(
        sd["dense.dense_0.weight"].numpy(), params["dense_0"]["kernel"].T)


def test_twenty_adam_steps_match_optax():
    jmodel, params, pmodel = _models(seed=2)
    rng = np.random.default_rng(3)
    batches = [_batch(rng) for _ in range(20)]
    label = HP["label"]
    lr = HP["learning_rate"]

    def jloss(p, batch):
        logits = jmodel.apply({"params": p}, batch)
        labels = jnp.asarray(batch[label], jnp.float32)
        return optax.sigmoid_binary_cross_entropy(logits, labels).mean()

    opt = optax.adam(lr)
    state = opt.init(params)
    grad_fn = jax.jit(jax.value_and_grad(jloss))
    want_losses = []
    p = params
    for batch in batches:
        loss, grads = grad_fn(p, batch)
        updates, state = opt.update(grads, state, p)
        p = optax.apply_updates(p, updates)
        want_losses.append(float(loss))

    loss_fn = taxi_module.make_loss_fn(label)
    optimizer = taxi_module.adam(lr)(pmodel.parameters())
    got_losses = []
    for batch in batches:
        loss, metrics = loss_fn(pmodel, _tensors(batch), None)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        got_losses.append(float(loss.detach()))
        assert 0.0 <= float(metrics["accuracy"]) <= 1.0

    np.testing.assert_allclose(got_losses, want_losses, **TRAIN_TOL)
    final = taxi_state_dict_from_flax(jax.tree.map(np.asarray, p))
    for name, t in pmodel.state_dict().items():
        np.testing.assert_allclose(t.numpy(), final[name].numpy(),
                                   err_msg=name, **TRAIN_TOL)
