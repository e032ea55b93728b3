"""Port parity of the vision models on the CPU: ``tpu_pipelines_torch.models``
``resnet`` and ``mnist`` against the JAX package's, and the port's
``train_loop`` with model state against the reference's.

Weights: flax variables of the reference geometry (ResNet width 8, 7
classes; the MNIST CNN at its defaults) filled by numpy from a seed (BatchNorm
scales, biases and running statistics away from their init values, so every
branch and statistic shows), carried to the port by ``models/convert.py``.
Inputs: NHWC images from numpy, a batch of 2.

  - ResNet-18 and ResNet-50 forwards at 32x32 (the stem pads 2 and 3, the
    max-pool 0 and 1) and 33x33 (3 and 3; 1 and 1), in ``eval()`` and
    ``train()`` mode, f32 and bf16 compute, with every BatchNorm's running
    buffers after a ``train()`` forward against the reference's mutated
    ``batch_stats`` (momentum 0.9, biased f32 variance: at the last stage of
    a 32x32 input a channel holds 2 values, where the unbiased variance is
    twice the biased one, which ``test_batch_stats_use_the_biased_variance``
    holds within 1e-5).  f32 eval: within 1e-5 of the largest logit
    (measured <= 9.1e-7: XLA's and oneDNN's convolutions differ in the
    order of their sums only).  f32 train: within 2e-3 (measured <= 6.8e-4)
    and the buffers within 1e-3 relative plus 2e-3 (measured <= 5.1e-4):
    at a batch of 2 the deepest BatchNorms normalize 2 values a channel,
    and where they nearly coincide ``E[x^2] - E[x]^2`` cancels, so sum-order
    differences of 1e-7 grow a thousandfold.  bf16: each conv and
    BatchNorm output rounds to bf16 on both sides, a sum order that
    differs flips a rounding now and then, and train-mode BatchNorm
    amplifies a flip the same way; the bound is the reference's own
    rounding: the port's logits (and, at most over all buffers, its
    statistics) sit within 1.5 x the distance between the reference's bf16
    and f32 results on the same weights and input (measured <= 0.66 x for
    the logits and 1.13 x for the statistics);
  - the MNIST CNN's forward (f32, within 1e-5 of the largest logit);
  - parameter counts equal the reference's (ResNet-50 at 1000 classes: 25-26
    M) and the init mirrors flax's;
  - three ``train_loop(has_model_state=True)`` steps of an f32 ResNet-18
    (SGD-Nesterov, as ``examples/resnet_module.py`` builds it; batches of 8
    at 64x64, so the last stage normalizes 32 values a channel) against the
    reference's ``train_loop`` on the same batches from the converted
    weights: losses within 1e-5 relative, parameters within 1e-4 of each
    tensor's largest value, running statistics within 1e-4 relative plus
    1e-5 (measured <= 1e-6, 3.9e-6 and 2.2e-6 relative: f32 sum orders
    through 3 steps); a checkpoint restore brings the running statistics
    back bit for bit; eval reads the running averages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from tpu_pipelines.models import mnist as ref_mnist
from tpu_pipelines.models import resnet as ref_resnet
from tpu_pipelines.trainer import TrainLoopConfig as RefTrainLoopConfig
from tpu_pipelines.trainer import train_loop as ref_train_loop
from tpu_pipelines_torch.examples import resnet_module
from tpu_pipelines_torch.models import mnist, resnet
from tpu_pipelines_torch.models.convert import (
    mnist_state_dict_from_flax,
    resnet_state_dict_from_flax,
)
from tpu_pipelines_torch.trainer import TrainLoopConfig, train_loop

WIDTH, CLASSES, BATCH = 8, 7, 2
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
F32_TOL = {"eval": 1e-5, "train": 2e-3}
F32_STATS_TOL = dict(rtol=1e-3, atol=2e-3)
BF16_FLOOR = 1.5
_VARIABLES = {}


def _filled(shapes, seed):
    """numpy values for every leaf of a flax variables tree of shapes."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.2 * rng.normal(size=shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, size=shape).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _resnet_variables(depth, num_classes=CLASSES, width=WIDTH):
    key = (depth, num_classes, width)
    if key not in _VARIABLES:
        model = ref_resnet.ResNet(num_classes=num_classes, depth=depth,
                                  width=width, dtype=jnp.float32)
        shapes = jax.eval_shape(lambda: model.init(
            jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False))
        _VARIABLES[key] = _filled(shapes, depth)
    return _VARIABLES[key]


def _images(size, seed=0, n=BATCH):
    return np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(
        np.float32)


def _port_resnet(depth, dtype, variables):
    model = resnet.ResNet(num_classes=CLASSES, depth=depth, width=WIDTH,
                          dtype=dtype)
    model.load_state_dict(resnet_state_dict_from_flax(variables), strict=True)
    return model


def _ref_forward(depth, dtype, variables, x, mode):
    """The reference's logits and (train mode) its mutated statistics as
    port buffers."""
    ref = ref_resnet.ResNet(num_classes=CLASSES, depth=depth, width=WIDTH,
                            dtype=DTYPES[dtype][0])
    if mode == "eval":
        return np.asarray(ref.apply(variables, x, train=False)), {}
    logits, mutated = ref.apply(variables, x, train=True, mutable=["batch_stats"])
    state = resnet_state_dict_from_flax({"params": variables["params"], **mutated})
    return np.asarray(logits), {k: v.numpy() for k, v in state.items()
                                if k.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("size", [32, 33])
@pytest.mark.parametrize("depth", [18, 50])
def test_resnet_forward_and_batch_stats_match_flax(depth, size, dtype, mode):
    variables = _resnet_variables(depth)
    x = _images(size, seed=depth + size)
    port = _port_resnet(depth, DTYPES[dtype][1], variables).train(mode == "train")
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    state = {k: v.numpy() for k, v in port.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    want, want_state = _ref_forward(depth, dtype, variables, x, mode)
    assert got.shape == (BATCH, CLASSES) and got.dtype == np.float32
    if mode == "train":
        assert sorted(state) == sorted(want_state) and len(state) == 2 * sum(
            1 for m in port.modules() if isinstance(m, resnet.BatchNorm))
    scale = np.abs(want).max()
    if dtype == "f32":
        assert np.abs(got - want).max() <= F32_TOL[mode] * scale
        for k, v in state.items() if mode == "train" else ():
            np.testing.assert_allclose(v, want_state[k], **F32_STATS_TOL, err_msg=k)
        return
    # bf16: no further from the reference than its own bf16 rounding moves
    # it from its f32 result.
    want32, want32_state = _ref_forward(depth, "f32", variables, x, mode)
    floor = np.abs(want - want32).max()
    assert np.abs(got - want).max() <= BF16_FLOOR * floor + 1e-6 * scale
    if mode == "train":
        gap = lambda a, b: max(np.abs(a[k] - b[k]).max() for k in a)  # noqa: E731
        floor = gap(want_state, want32_state)
        assert gap(state, want_state) <= BF16_FLOOR * floor + 1e-6


def test_batch_stats_use_the_biased_variance_and_flax_momentum():
    """The last stage's BatchNorm at 32x32 sees BATCH values a channel: a
    torch-default update (unbiased variance, momentum 0.1 on the batch)
    would move running_var by n/(n-1) = 2x as much."""
    variables = _resnet_variables(18)
    port = _port_resnet(18, torch.float32, variables).train()
    bn = port.blocks.stage3_block1.bn1
    before = bn.running_var.clone()
    seen = {}
    bn.register_forward_hook(lambda m, inp, out: seen.setdefault("x", inp[0]))
    with torch.no_grad():
        port(torch.from_numpy(_images(32)))
    x = seen["x"].float()
    assert x.shape[0] * x.shape[2] * x.shape[3] == BATCH
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 * before + 0.1 * biased,
                               rtol=1e-5, atol=1e-6)
    unbiased = x.var(dim=(0, 2, 3), unbiased=True)
    assert torch.allclose(unbiased, 2 * biased)
    assert not torch.allclose(bn.running_var, 0.9 * before + 0.1 * unbiased,
                              rtol=1e-3)


def test_resnet_keeps_channels_last_and_pads_as_same():
    port = resnet.ResNet(num_classes=CLASSES, depth=18, width=WIDTH)
    outs = []
    for m in port.modules():
        if isinstance(m, resnet.Conv):
            m.register_forward_hook(lambda m, i, o: outs.append(o))
    with torch.no_grad():
        port(torch.from_numpy(_images(224, n=1)))
    assert all(o.is_contiguous(memory_format=torch.channels_last) for o in outs)
    assert outs[0].shape[2:] == (112, 112) and outs[-1].shape[2:] == (7, 7)
    assert resnet.same_pads(224, 7, 2) == (2, 3)
    assert resnet.same_pads(112, 3, 2) == (0, 1)
    assert resnet.same_pads(33, 7, 2) == (3, 3)
    assert resnet.same_pads(17, 3, 2) == (1, 1)


def test_mnist_forward_matches_flax():
    model = ref_mnist.MnistCNN()
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.key(0), jnp.zeros((1, 28, 28, 1))))
    params = _filled(shapes, 3)["params"]
    port = mnist.MnistCNN()
    port.load_state_dict(mnist_state_dict_from_flax(params), strict=True)
    x = np.random.default_rng(4).normal(size=(3, 28, 28, 1)).astype(np.float32)
    want = np.asarray(model.apply({"params": params}, x))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
        flat = port(torch.from_numpy(x[..., 0])).numpy()  # [batch, 28, 28]
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_array_equal(flat, got)
    # Dropout in train() mode draws from the caller's generator.
    port.train()
    draw = lambda s: port(torch.from_numpy(x),  # noqa: E731
                          generator=torch.Generator().manual_seed(s))
    with torch.no_grad():
        assert torch.equal(draw(1), draw(1)) and not torch.equal(draw(1), draw(2))
    with pytest.raises(ValueError, match="torch.Generator"):
        port(torch.from_numpy(x))


def _count(tree):
    return sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(tree))


def test_parameter_counts_and_init_mirror_flax():
    ref = ref_resnet.ResNet(num_classes=1000, depth=50, width=64)
    shapes = jax.eval_shape(lambda: ref.init(
        jax.random.key(0), jnp.zeros((1, 224, 224, 3)), train=False))
    port = resnet.build_resnet_model({})
    n = sum(p.numel() for p in port.parameters())
    assert 25e6 < n < 26e6 and n == _count(shapes["params"])
    assert sum(b.numel() for b in port.buffers()) == _count(shapes["batch_stats"])
    assert sum(p.numel() for p in mnist.build_mnist_model({}).parameters()) == \
        _count(jax.eval_shape(lambda: ref_mnist.MnistCNN().init(
            jax.random.key(0), jnp.zeros((1, 28, 28, 1))))["params"])
    # flax: zero scale on each block's last BatchNorm, LeCun-normal kernels
    # (drawn over the model just counted: a second ResNet-50 cost most of
    # this test's time on a loaded host).
    g = torch.Generator().manual_seed(0)
    port = resnet.init_resnet_weights(port, g)
    block = port.blocks.stage2_block3
    assert torch.count_nonzero(block.bn2.weight) == 0
    assert torch.equal(block.bn0.weight, torch.ones_like(block.bn0.weight))
    assert torch.equal(block.bn0.running_var, torch.ones_like(block.bn0.running_var))
    w = block.conv1.weight
    assert abs(w.std().item() - (1 / w[0].numel()) ** 0.5) < 0.02 * (1 / w[0].numel()) ** 0.5
    assert w.abs().max() <= 2 * (1 / w[0].numel()) ** 0.5 / 0.8796 + 1e-6
    assert torch.count_nonzero(port.head.bias) == 0


# ---- the train loop with model state

STEPS, LR, IMG = 3, 0.05, 64


def _labelled_batches():
    rng = np.random.default_rng(7)
    return [{"image": rng.normal(size=(8, IMG, IMG, 3)).astype(np.float32),
             "label": rng.integers(0, CLASSES, size=8).astype(np.int32)}
            for _ in range(STEPS)]


def _port_loop(variables, batches, steps=None, config=None, **kw):
    losses = []

    def init(generator, sample):
        return _port_resnet(18, torch.float32, variables)

    optimizers = []

    def optimizer(params):
        optimizers.append(resnet_module.sgd(LR)(params))
        return optimizers[-1]

    model, result = train_loop(
        loss_fn=resnet_module.loss_fn, init_params_fn=init,
        optimizer=optimizer, train_iter=iter(batches),
        config=TrainLoopConfig(train_steps=steps or len(batches), batch_size=8,
                               log_every=1, window_steps=2, **(config or {})),
        metrics_cb=lambda s, m: losses.append(m["loss"]),
        has_model_state=True, device="cpu", **kw)
    return model, result, losses


def test_train_loop_with_model_state_matches_the_reference():
    variables = _resnet_variables(18)
    batches = _labelled_batches()
    ref = ref_resnet.ResNet(num_classes=CLASSES, depth=18, width=WIDTH,
                            dtype=jnp.float32)

    def loss_fn(params, model_state, batch, rng):
        logits, mutated = ref.apply({"params": params, **model_state},
                                    batch["image"], train=True,
                                    mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(batch["label"], jnp.int32)).mean()
        return loss, ({}, mutated)

    want_losses = []
    (params, model_state), _ = ref_train_loop(
        loss_fn=loss_fn,
        init_params_fn=lambda rng, b: (variables["params"],
                                       {"batch_stats": variables["batch_stats"]}),
        optimizer=optax.sgd(LR, momentum=0.9, nesterov=True),
        train_iter=iter(batches),
        config=RefTrainLoopConfig(train_steps=STEPS, batch_size=8, log_every=1,
                                  window_steps=1),
        metrics_cb=lambda s, m: want_losses.append(m["loss"]),
        has_model_state=True,
    )
    want = resnet_state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": params, **model_state}))

    model, result, losses = _port_loop(variables, batches)
    assert result.steps_completed == STEPS
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
        else:
            scale = max(float(want[k].abs().max()), 1e-6)
            assert float((v - want[k]).abs().max()) <= 1e-4 * scale, k
    # Every step moved the statistics: the run's buffers are not the init's.
    init = resnet_state_dict_from_flax(variables)
    assert not torch.equal(got["bn_init.running_var"], init["bn_init.running_var"])


def test_checkpoint_restore_brings_the_running_statistics_back(tmp_path):
    variables = _resnet_variables(18)
    batches = _labelled_batches()
    full, _, _ = _port_loop(variables, batches)
    # Two steps with a checkpoint, then a run to STEPS that resumes from it.
    _port_loop(variables, batches[:2], checkpoint_dir=str(tmp_path),
               config={"checkpoint_every": 2})
    saved = torch.load(tmp_path / "ckpt_2.pt", weights_only=True)["model"]
    assert "bn_init.running_mean" in saved
    resumed, result, _ = _port_loop(variables, batches[2:], steps=STEPS,
                                    checkpoint_dir=str(tmp_path))
    assert result.resumed_from_step == 2
    state = resumed.state_dict()
    init = resnet_state_dict_from_flax(variables)
    for k, v in full.state_dict().items():
        assert torch.equal(state[k], v), k
    moved = [k for k in state if k.endswith("running_var")
             and not torch.equal(state[k], init[k])]
    assert len(moved) == len([k for k in state if k.endswith("running_var")])


def test_eval_reads_the_running_averages():
    variables = _resnet_variables(18)
    port = _port_resnet(18, torch.float32, variables)
    x = torch.from_numpy(_images(32))
    batch = {"image": x, "label": torch.zeros(BATCH, dtype=torch.long)}
    with torch.no_grad():
        eval_loss, _ = resnet_module.loss_fn(port.eval(), batch, None)
        before = port.bn_init.running_mean.clone()
        train_loss, _ = resnet_module.loss_fn(port.train(), batch, None)
    assert not torch.equal(port.bn_init.running_mean, before)
    assert abs(eval_loss.item() - train_loss.item()) > 1e-3
    want = F.cross_entropy(torch.tensor(np.asarray(
        ref_resnet.ResNet(num_classes=CLASSES, depth=18, width=WIDTH,
                          dtype=jnp.float32).apply(variables, x.numpy(), train=False))),
        batch["label"])
    assert abs(eval_loss.item() - want.item()) <= 1e-4 * abs(want.item())
