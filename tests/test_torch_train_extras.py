"""Port parity: the train loop's extras (profile, TensorBoard, counted
FLOPs and MFU, the stall watchdog) against the reference.

  - ``profile_dir`` forces ``window_steps`` to 1 and writes one Chrome
    trace of steps ``[profile_from, profile_to)``: its optimizer steps are
    exactly those steps;
  - ``tensorboard_dir``: the port's event files (``summary_writer.py``) and
    the reference's (clu, tf2 tensor summaries) after the same tiny-BERT
    run under SGD, both read with ``event_accumulator``, hold the same
    tags at the same steps, values within a relative 1e-5 (the loss
    trajectories' tolerance in ``test_torch_train_loop.py``: f32 sum orders);
  - the counted FLOPs of one tiny-BERT step are equal under "flash" and
    "dense" attention, and equal to the closed form (3x the forward's
    products: each product's backward is two of its size), so the plain
    version's products are not counted twice on the CPU; ``mfu`` follows
    the reference's formula given a peak;
  - the count sees only its own thread's attention;
  - the count moves no BatchNorm buffer and no optimizer state, on a
    Linear/BatchNorm model and on ResNet-18;
  - train loops take side streams from a free list: one after another
    they reuse one, at once they hold one each;
  - the stall watchdog fires once per stall and re-arms on a heartbeat,
    as the reference's does; ``status()`` is the reference's payload, an
    alert lands as a ``health/watchdog_alert`` instant in the active run
    trace, and the runner's ``/healthz`` serves the open monitors.
"""

import json
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_bert import (
    TINY,
    _batch,
    _jax_f32_classifier,
    _numpy_tree,
    _port_f32_classifier,
)
from tpu_pipelines.observability.health import HealthMonitor as RefMonitor
from tpu_pipelines.trainer import TrainLoopConfig as JaxTrainLoopConfig
from tpu_pipelines.trainer import train_loop as jax_train_loop
from tpu_pipelines_torch.examples import bert_module
from tpu_pipelines_torch.models.convert import bert_state_dict_from_flax
from tpu_pipelines_torch.observability import trace as obs
from tpu_pipelines_torch.observability.health import HealthMonitor, open_monitors
from tpu_pipelines_torch.trainer import TrainLoopConfig, train_loop
from tpu_pipelines_torch.trainer.train_loop import count_step_flops

STEPS, LR = 6, 0.1
TB_RTOL = 1e-5


def _labelled(batch, seed):
    rng = np.random.default_rng(100 + seed)
    return {**batch, "label": rng.integers(0, TINY["num_classes"],
                                           size=len(batch["input_ids"])).astype(np.int32)}


def _batches(n=STEPS):
    return [_labelled(_batch(lengths=(16, 10, 5, 1, 16, 7, 3, 12), seed=s), s)
            for s in range(n)]


def _jax_params():
    jmodel = _jax_f32_classifier("dense")
    return jmodel, _numpy_tree(
        jmodel.init(jax.random.key(1), {k: v for k, v in _batch().items()})["params"])


def _port_run(config, batches=None, attn="dense", **kw):
    _, params = _jax_params()
    batches = batches or _batches()

    def init(generator, sample):
        model = _port_f32_classifier(attn)
        model.load_state_dict(bert_state_dict_from_flax(params), strict=True)
        return model

    return train_loop(
        loss_fn=bert_module.loss_fn, init_params_fn=init,
        optimizer=lambda ps: torch.optim.SGD(ps, lr=LR),
        train_iter=iter(batches), eval_iter_fn=lambda: iter(batches[:2]),
        config=TrainLoopConfig(train_steps=len(batches), batch_size=8,
                               **config),
        device="cpu", **kw)


def test_profile_dir_forces_window_one_and_traces_the_chosen_steps(tmp_path):
    _, result = _port_run({"log_every": 2, "window_steps": 3,
                           "profile_dir": str(tmp_path / "prof"),
                           "profile_from": 1, "profile_to": 4})
    assert result.window_steps == 1
    assert os.listdir(tmp_path / "prof") == ["train_steps_1-4.pt.trace.json"]
    events = json.load(open(tmp_path / "prof" / "train_steps_1-4.pt.trace.json"))
    names = [e.get("name", "") for e in events["traceEvents"]]
    assert sum(n.startswith("Optimizer.step#SGD.step") for n in names) == 3
    assert any(n == "aten::addmm" for n in names)


def _jax_loss(model, params, batch):
    """``bert_module.loss_fn``'s loss and accuracy, in JAX."""
    logits = model.apply({"params": params},
                         {k: batch[k] for k in ("input_ids", "attention_mask")})
    labels = jnp.asarray(batch["label"], jnp.int32)
    loss = optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
    return loss, {"accuracy": jnp.mean(jnp.argmax(logits, -1) == labels)}


def _read_events(logdir):
    from tensorboard.backend.event_processing import event_accumulator as ea
    from tensorboard.util import tensor_util

    acc = ea.EventAccumulator(logdir, size_guidance={ea.SCALARS: 0, ea.TENSORS: 0})
    acc.Reload()
    out = {}
    for tag in acc.Tags()["scalars"]:
        out[tag] = [(e.step, float(e.value)) for e in acc.Scalars(tag)]
    for tag in acc.Tags()["tensors"]:
        out[tag] = [(e.step, float(tensor_util.make_ndarray(e.tensor_proto)))
                    for e in acc.Tensors(tag)]
    return out


def test_tensorboard_scalars_match_the_references(tmp_path):
    batches = _batches()
    jmodel, params = _jax_params()
    jax_train_loop(
        loss_fn=lambda p, b, rng: _jax_loss(jmodel, p, b),
        init_params_fn=lambda rng, b: params,
        optimizer=optax.sgd(LR), train_iter=iter(batches),
        eval_iter_fn=lambda: iter(batches[:2]),
        config=JaxTrainLoopConfig(train_steps=STEPS, batch_size=8,
                                  log_every=2, window_steps=2,
                                  tensorboard_dir=str(tmp_path / "ref")),
    )
    _port_run({"log_every": 2, "window_steps": 2,
               "tensorboard_dir": str(tmp_path / "port")})
    want, got = _read_events(str(tmp_path / "ref")), _read_events(str(tmp_path / "port"))
    assert sorted(got) == sorted(want) and "loss" in got and "eval_loss" in got
    for tag, points in want.items():
        assert [s for s, _ in got[tag]] == [s for s, _ in points], tag
        np.testing.assert_allclose([v for _, v in got[tag]],
                                   [v for _, v in points], rtol=TB_RTOL,
                                   err_msg=tag)


def _closed_form(batch):
    b, l = batch["input_ids"].shape
    d, ff, layers = TINY["d_model"], TINY["d_ff"], TINY["n_layers"]
    t = b * l
    forward = layers * (4 * 2 * t * d * d + 2 * 2 * t * d * ff
                        + 2 * 2 * b * l * l * d)
    forward += 2 * b * d * d + 2 * b * d * TINY["num_classes"]  # pooler, head
    return 3 * forward


def test_counted_flops_equal_under_flash_and_dense_and_the_closed_form():
    batch = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    counts = {}
    for attn in ("flash", "dense"):
        model = _port_f32_classifier(attn)
        counts[attn] = count_step_flops(model, bert_module.loss_fn, batch)
    assert counts["flash"] == counts["dense"] == _closed_form(_batches(1)[0])


def test_the_count_sees_its_own_threads_attention_only():
    """The attention operators are counted by the counting thread's mode:
    a forward and backward on another thread meanwhile add nothing."""
    from torch.utils.flop_counter import FlopCounterMode

    from tpu_pipelines_torch.ops.flash_attention import flash_attention

    b, l, h, d = 2, 8, 2, 16
    rng = np.random.default_rng(0)

    def step():
        q, k, v = (torch.tensor(rng.normal(size=(b, l, h, d)), dtype=torch.float32,
                                requires_grad=True) for _ in range(3))
        flash_attention(q, k, v).sum().backward()

    with FlopCounterMode(display=False) as counter:
        other = threading.Thread(target=step)
        other.start()
        other.join()
        assert counter.get_total_flops() == 0
        step()
    # forward 4·B·H·L²·D, backward 8·B·H·L²·D (the sum's backward is no
    # product)
    assert counter.get_total_flops() == 12 * b * h * l * l * d


def test_mfu_follows_the_reference_formula_given_a_peak():
    _, result = _port_run({"log_every": 2, "window_steps": 2,
                           "collect_cost_analysis": True,
                           "peak_flops_per_chip": 1e9})
    assert result.cost_analysis_source == "counted"
    assert result.cost_analysis_flops_per_step == _closed_form(_batches(1)[0])
    device_s = result.window_phase_seconds["device_compute"]
    steps = STEPS - 2                       # after the first window
    want = result.cost_analysis_flops_per_step * steps / device_s / 1e9
    assert result.mfu == pytest.approx(round(want, 4), abs=1e-4 + 1e-3 * want)
    _, plain = _port_run({"log_every": 2, "window_steps": 2})
    assert plain.mfu is None and plain.cost_analysis_flops_per_step is None


class _BnNet(torch.nn.Module):
    """Linear -> BatchNorm -> Linear: a model with running statistics."""

    def __init__(self):
        super().__init__()
        self.a = torch.nn.Linear(6, 16)
        self.bn = torch.nn.BatchNorm1d(16)
        self.b = torch.nn.Linear(16, 4)

    def forward(self, x):
        return self.b(torch.relu(self.bn(self.a(x))))


def _bn_loss(model, batch, generator):
    logits = model(batch["x"])
    return torch.nn.functional.cross_entropy(logits, batch["y"].long()), {}


# ResNet-18 at 64x64 images: every stride-2 convolution reads at least 2x2
# pixels.  At 8x8 images the last stages' stride-2 convolutions read 1x1,
# where PyTorch 2.13's CPU bf16 conv2d weight gradient (3x3 kernel, stride
# 2, padding 1) returns uninitialised values (ROADMAP.md C).
RESNET18 = {"num_classes": 4, "depth": 18, "width": 8}
RESNET18_IMAGE = 64


def _bn_case(name, rng):
    if name == "linear_bn":
        batches = [{"x": rng.normal(size=(8, 6)).astype(np.float32),
                    "y": rng.integers(0, 4, 8).astype(np.int32)} for _ in range(4)]
        return (_bn_loss, lambda g, s: (torch.manual_seed(0), _BnNet())[1],
                batches)
    from tpu_pipelines_torch.examples.resnet_module import loss_fn
    from tpu_pipelines_torch.models.resnet import (
        build_resnet_model,
        init_resnet_weights,
    )

    size = RESNET18_IMAGE
    batches = [{"image": rng.normal(size=(8, size, size, 3)).astype(np.float32),
                "label": rng.integers(0, 4, 8).astype(np.int32)} for _ in range(4)]
    return (loss_fn,
            lambda g, s: init_resnet_weights(build_resnet_model(RESNET18), g),
            batches)


@pytest.mark.parametrize("name", ["linear_bn", "resnet18"])
def test_the_count_moves_no_buffer_and_no_optimizer_state(name):
    runs = {}
    for count in (False, True):
        optimizers = []
        loss_fn, init, batches = _bn_case(name, np.random.default_rng(0))

        def opt(ps):
            optimizers.append(torch.optim.SGD(ps, lr=0.1 if name == "linear_bn"
                                              else 1e-3, momentum=0.9,
                                              nesterov=name != "linear_bn"))
            return optimizers[-1]

        model, result = train_loop(
            loss_fn=loss_fn, init_params_fn=init,
            optimizer=opt, train_iter=iter(batches),
            config=TrainLoopConfig(train_steps=4, batch_size=8, log_every=2,
                                   window_steps=2,
                                   collect_cost_analysis=count),
            has_model_state=True, device="cpu")
        runs[count] = (model.state_dict(), optimizers[0].state_dict(), result)
    (sd0, opt0, _), (sd1, opt1, result) = runs[False], runs[True]
    if name == "linear_bn":
        # Forward 2·8·(6·16 + 16·4); the backward's weight gradients and
        # the second layer's input gradient (the input needs none).
        assert result.cost_analysis_flops_per_step == (
            2 * 8 * (6 * 16 + 16 * 4) * 2 + 2 * 8 * 16 * 4)
        assert sd1["bn.num_batches_tracked"] == 4
    else:
        assert result.cost_analysis_flops_per_step > 0
        # Four steps of lr 1e-3 move no kernel far from its initialiser's
        # range (|w| <= 2 std = 2 / (0.8796 sqrt(fan_in)) < 0.81, fan_in
        # >= 8).
        assert np.isfinite(result.final_metrics["loss"])
        assert max(float(v.abs().max()) for k, v in sd1.items()
                   if k.endswith("weight") and v.dim() >= 2) < 1.0
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
    for i, s in opt0["state"].items():
        for k, v in s.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(opt1["state"][i][k]))


def test_side_streams_are_reused_in_turn_and_never_shared(monkeypatch):
    """A loop takes a free side stream and gives it back: runs one after
    another reuse one stream, runs at once hold one each."""
    import importlib

    tl = importlib.import_module("tpu_pipelines_torch.trainer.train_loop")

    made = []

    def stream(device):
        made.append(object())
        return made[-1]

    monkeypatch.setattr(torch.cuda, "Stream", stream)
    monkeypatch.setattr(tl, "_free_side_streams", {})
    dev = torch.device("cuda", 0)
    a, b = tl._take_side_stream(dev), tl._take_side_stream(dev)
    assert a is not b
    tl._give_back_side_stream(dev, a)
    tl._give_back_side_stream(dev, b)
    for _ in range(3):
        c = tl._take_side_stream(dev)
        tl._give_back_side_stream(dev, c)
    assert c in (a, b) and len(made) == 2
    assert tl._take_side_stream(torch.device("cpu")) is None

    # Many threads taking and giving back at once: no stream is ever held
    # by two of them, and no more are made than were held at once.
    holders, errors, lock = {}, [], threading.Lock()

    def churn():
        for _ in range(200):
            s = tl._take_side_stream(dev)
            with lock:
                if id(s) in holders:
                    errors.append(s)
                holders[id(s)] = s
            with lock:
                del holders[id(s)]
            tl._give_back_side_stream(dev, s)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=churn) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and len(made) <= 16 + 2


def _drive(monitor, alerts):
    """Beat, stall 0.35 s, beat (re-arms), stall again: two stalls."""
    monitor.heartbeat(1, loss=1.0)
    time.sleep(0.35)
    alerts.append([a["kind"] for a in monitor.alerts])
    monitor.heartbeat(2, loss=1.0)
    time.sleep(0.35)
    alerts.append([a["kind"] for a in monitor.alerts])
    monitor.close()


def test_stall_watchdog_fires_once_and_rearms_as_the_reference():
    seen = {}
    for side, cls in (("ref", RefMonitor), ("port", HealthMonitor)):
        fired = []
        monitor = cls(f"m-{side}", stall_timeout_s=0.1,
                      on_alert=lambda k, d: fired.append(k))
        states = []
        _drive(monitor, states)
        seen[side] = (states, fired)
    assert seen["port"] == seen["ref"]
    assert seen["port"][0] == [["stall"], ["stall", "stall"]]


def test_no_timeout_starts_no_thread_and_env_sets_one(monkeypatch):
    monitor = HealthMonitor("quiet", stall_timeout_s=0)
    monitor.heartbeat(1)
    assert monitor._thread is None
    monitor.close()
    monkeypatch.setenv("TPP_STALL_TIMEOUT_S", "2.5")
    # Closed after: an open monitor stays in the process's /healthz list
    # (open_monitors) for every later test.
    for cls in (HealthMonitor, RefMonitor):
        env = cls("env")
        assert env.stall_timeout_s == 2.5
        env.close()


def test_status_alert_instant_and_the_runs_healthz(tmp_path):
    from tpu_pipelines_torch.orchestration.local_runner import _RunTelemetry

    recorder = obs.TraceRecorder(str(tmp_path / "run"), "run-1")
    with obs.activate(recorder):
        port = HealthMonitor("status-port", stall_timeout_s=30)
        ref = RefMonitor("status-ref", stall_timeout_s=30)
        for m in (port, ref):
            m.heartbeat(3, loss=float("nan"))
        health = _RunTelemetry("p", "run-1")._health()
        assert sorted(port.status()) == sorted(ref.status())
        assert port.status()["nan_seen"] and not port.status()["healthy"]
        assert port in open_monitors()
        assert not health["healthy"]
        assert [m["monitor"] for m in health["monitors"]].count("status-port") == 1
        port.close()
        ref.close()
    recorder.close()
    assert port not in open_monitors()
    events = [json.loads(l) for l in open(recorder.events_path)]
    alerts = [e for e in events if e.get("name") == "watchdog_alert"]
    assert len(alerts) == 1 and alerts[0]["cat"] == "health"
    assert alerts[0]["args"]["kind"] == "nan" and alerts[0]["args"]["step"] == 3
