"""Port parity and contracts of the training slice, on the CPU.

  - one step's gradients of a tiny BERT (the ``TINY`` geometry of
    tests/test_torch_bert.py, f32, dropout 0, flash attention: the JAX side
    runs its Pallas backward kernels in interpret mode) agree with
    ``jax.grad`` of the reference loss, weights converted from the flax
    init.  Tolerance 1e-4 relative plus 1e-6 absolute: every product is f32
    on both sides and they differ in the order of sums through two layers
    and the head (measured <= 2.7e-7 absolute, 0.11 of the tolerance); a
    key projection's bias has a zero gradient up to rounding (softmax
    ignores a per-row constant), which the absolute term covers;
  - ``torch.optim.AdamW`` as the port's ``adamw`` configures it tracks
    ``optax.adamw`` over 5 steps on the same params and gradients (the same
    update rule; f32 rounding only, a few ulps of params of magnitude
    <= 2 over 5 steps: 1e-6 relative plus 1e-6 absolute);
  - the port's ``train_loop`` under SGD agrees with the reference
    ``train_loop`` from the same converted init and batches on every step's
    loss (f32, dense attention; the reference sums gradients over an
    8-device CPU mesh: 1e-5 relative);
  - the window contract of tests/test_train_window.py, on a toy model with
    a dropout site so the per-step generator matters;
  - the data-parallel fields (A5) run and take effect in one process (a
    mesh of one); ``batch_partition`` alone is refused, naming A6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import os

import pytest
import torch
from torch import nn

from test_torch_bert import (
    TINY,
    _batch,
    _jax_f32_classifier,
    _numpy_tree,
    _port_f32_classifier,
)
from tpu_pipelines.trainer import TrainLoopConfig as JaxTrainLoopConfig
from tpu_pipelines.trainer import train_loop as jax_train_loop
from tpu_pipelines_torch.examples import bert_module
from tpu_pipelines_torch.models.convert import bert_state_dict_from_flax
from tpu_pipelines_torch.models.transformer import Dropout
from tpu_pipelines_torch.observability.metrics import default_registry
from tpu_pipelines_torch.parallel.mesh import make_mesh
from tpu_pipelines_torch.trainer import TrainLoopConfig, train_loop
from tpu_pipelines_torch.trainer.data_parallel import DataParallel
from tpu_pipelines_torch.trainer.train_loop import (
    _checkpoints,
    _read_progress_step,
    _write_progress,
    step_generator,
)

GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _labelled(batch, seed):
    labels = np.random.default_rng(seed).integers(
        0, TINY["num_classes"], len(batch["input_ids"]))
    return {**batch, "label": labels.astype(np.int32)}


def _features(batch):
    return {k: v for k, v in batch.items() if k != "label"}


def _jax_loss(model, params, batch):
    logits = model.apply({"params": params}, _features(batch))
    return optax.softmax_cross_entropy_with_integer_labels(
        logits, jnp.asarray(batch["label"], jnp.int32)
    ).mean()


def test_tiny_bert_flash_gradients_match_jax_grad():
    batch = _labelled(_batch(), seed=0)
    jmodel = _jax_f32_classifier("flash")
    params = _numpy_tree(jmodel.init(jax.random.key(0), _features(batch))["params"])
    want_loss, grads = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(jmodel, p, batch)
    ))(params)
    want = bert_state_dict_from_flax(_numpy_tree(grads))

    port = _port_f32_classifier("flash")
    port.load_state_dict(bert_state_dict_from_flax(params), strict=True)
    port.train()
    loss, metrics = bert_module.loss_fn(
        port, {k: torch.from_numpy(v) for k, v in batch.items()}, None
    )
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-6)
    assert 0.0 <= float(metrics["accuracy"]) <= 1.0
    names = [n for n, _ in port.named_parameters()]
    assert set(names) == set(want)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_adamw_tracks_optax_adamw():
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (3,), (2, 2, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    lr = 1e-2

    opt = optax.adamw(lr)
    jparams = [jnp.asarray(p) for p in params]
    state = opt.init(jparams)
    tparams = [nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    topt = bert_module.adamw(lr)(tparams)
    for g in grads:
        updates, state = opt.update([jnp.asarray(x) for x in g], state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, x in zip(tparams, g):
            p.grad = torch.from_numpy(x.copy())
        topt.step()
    for a, b in zip(tparams, jparams):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-6, atol=1e-6)
    assert topt.defaults["weight_decay"] == 1e-4
    assert not topt.defaults["fused"]


def test_train_loop_under_sgd_matches_reference_loss_trajectory():
    steps, lr = 4, 0.1
    batches = [_labelled(_batch(lengths=(16, 10, 5, 1, 16, 7, 3, 12), seed=s), s)
               for s in range(steps)]
    hp = {**TINY, "attn_impl": "dense"}
    jmodel = _jax_f32_classifier("dense")
    params = _numpy_tree(
        jmodel.init(jax.random.key(1), _features(batches[0]))["params"]
    )

    want = []
    jax_train_loop(
        loss_fn=lambda p, b, rng: (_jax_loss(jmodel, p, b), {}),
        init_params_fn=lambda rng, b: params,
        optimizer=optax.sgd(lr),
        train_iter=iter(batches),
        config=JaxTrainLoopConfig(train_steps=steps, batch_size=8,
                                  log_every=1, window_steps=1),
        metrics_cb=lambda s, m: want.append(m["loss"]),
    )

    def init(generator, sample):
        model = _port_f32_classifier(hp["attn_impl"])
        model.load_state_dict(bert_state_dict_from_flax(params), strict=True)
        return model

    got = []
    _, result = train_loop(
        loss_fn=bert_module.loss_fn,
        init_params_fn=init,
        optimizer=lambda ps: torch.optim.SGD(ps, lr=lr),
        train_iter=iter(batches),
        config=TrainLoopConfig(train_steps=steps, batch_size=8, log_every=1,
                               window_steps=2),
        metrics_cb=lambda s, m: got.append(m["loss"]),
        device="cpu",
    )
    assert result.steps_completed == steps and len(got) == steps
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ---- the window contract, on a toy regression with a dropout site

BATCH = 32


class _Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(2))
        self.b = nn.Parameter(torch.zeros(()))
        self.dropout = Dropout(0.25)

    def forward(self, x, generator=None):
        return self.dropout(x, generator) @ self.w + self.b


def _toy_batches(n, batch=BATCH, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.normal(size=(batch, 2)).astype(np.float32)
        y = (x @ np.array([3.0, -2.0], np.float32) + 1.0).astype(np.float32)
        out.append({"x": x, "y": y})
    return out


def _toy_loss(model, b, generator):
    pred = model(b["x"], generator)
    return ((pred - b["y"]) ** 2).mean(), {"w_norm": (model.w ** 2).sum()}


def _toy_init(generator, sample):
    return _Toy()


def _adam(params):
    return torch.optim.Adam(params, lr=0.05)


def _run(window_steps, steps=24, log_every=4, batches=None, **kw):
    hist = []
    config = dict(train_steps=steps, batch_size=BATCH, log_every=log_every,
                  window_steps=window_steps)
    config.update(kw.pop("config", {}))
    model, result = train_loop(
        loss_fn=_toy_loss,
        init_params_fn=_toy_init,
        optimizer=_adam,
        train_iter=iter(batches if batches is not None else _toy_batches(steps)),
        config=TrainLoopConfig(**config),
        metrics_cb=lambda s, m: hist.append((s, m.get("loss"), m.get("w_norm"))),
        device="cpu",
        **kw,
    )
    return model, result, hist


def _same_params(a, b):
    return all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))


def test_windowed_matches_per_step_bitwise():
    m1, r1, h1 = _run(1)
    mw, rw, hw = _run(8)
    assert r1.window_steps == 1 and rw.window_steps == 8
    assert _same_params(m1, mw)
    assert h1 == hw and len(h1) == 24 // 4
    assert r1.final_metrics == rw.final_metrics
    assert rw.steps_completed == 24
    assert set(rw.window_phase_seconds) == {
        "infeed_wait", "device_compute", "device_collective", "host"}
    assert rw.anchor_windows >= 1


def test_window_defaults_to_log_every_and_env_overrides(monkeypatch):
    _, r_default, _ = _run(None, steps=12, log_every=4)
    assert r_default.window_steps == 4
    monkeypatch.setenv("TPP_WINDOW_STEPS", "6")
    _, r_env, _ = _run(None, steps=12, log_every=4)
    assert r_env.window_steps == 6
    _, r_explicit, _ = _run(3, steps=12, log_every=4)
    assert r_explicit.window_steps == 3
    monkeypatch.delenv("TPP_WINDOW_STEPS")
    _, r_bench, _ = _run(None, steps=6, log_every=0)
    assert r_bench.window_steps == 1


def test_partial_tail_and_iterator_exhaustion():
    # 10 steps at window 4 -> windows of 4, 4, 2; an iterator that dies
    # mid-window (6 batches for 8 scheduled steps) stops cleanly.
    _, r, _ = _run(4, steps=10, log_every=0)
    assert r.steps_completed == 10
    _, r, _ = _run(4, steps=8, log_every=0, batches=_toy_batches(6))
    assert r.steps_completed == 6


def test_nan_mid_window_fires_watchdog_at_boundary():
    fired = []
    batches = _toy_batches(16, batch=8)
    batches[10] = {**batches[10], "y": batches[10]["y"] * np.nan}
    _run(8, steps=16, log_every=0, batches=batches,
         config={"health_alert_cb": lambda k, d: fired.append((k, d))})
    nan_alerts = [d for k, d in fired if k == "nan"]
    assert nan_alerts, fired
    # Batch 10 is step 11: the rebuilt per-step series names it.
    assert "step 11" in nan_alerts[0]


def test_telemetry_gauges_publish_at_window_cadence():
    _, r, _ = _run(6, steps=18, log_every=6)
    reg = default_registry()
    assert reg.gauge("train_steps_total").get() == 18
    assert reg.gauge("train_examples_per_sec").get() > 0
    assert reg.gauge("train_step_seconds").get() > 0
    assert reg.gauge("train_host_input_wait_seconds_total").get() >= 0
    assert r.anchor_windows == 2  # 3 windows; the first absorbs warm-up
    assert r.anchored_examples_per_sec_per_chip > 0


def test_eval_and_checkpoint_land_on_exact_boundaries(tmp_path):
    eval_at = []
    ckpt = tmp_path / "ckpts"
    train_loop(
        loss_fn=_toy_loss,
        init_params_fn=_toy_init,
        optimizer=_adam,
        train_iter=iter(_toy_batches(12)),
        config=TrainLoopConfig(
            train_steps=12, batch_size=BATCH, log_every=0, window_steps=8,
            eval_every=6, eval_steps=1, checkpoint_every=5,
            keep_checkpoints=2,
        ),
        eval_iter_fn=lambda: iter(_toy_batches(2, seed=9)),
        checkpoint_dir=str(ckpt),
        metrics_cb=lambda s, m: eval_at.append(s) if any(
            k.startswith("eval_") for k in m) else None,
        device="cpu",
    )
    assert eval_at == [6, 12]
    # Saves at 5, 10 and the final 12; the newest two are kept.
    assert sorted(p.name for p in ckpt.glob("ckpt_*.pt")) == [
        "ckpt_10.pt", "ckpt_12.pt"]
    assert _read_progress_step(str(ckpt)) == 12


def test_checkpoint_then_resume_continues_the_same_run(tmp_path):
    ckpt = str(tmp_path / "ckpts")
    batches = _toy_batches(32)
    config = {"checkpoint_every": 8}
    whole, _, _ = _run(8, steps=32, log_every=8, batches=batches, config=config)

    # Interrupted: the iterator ends at step 16 of 32; the save at the
    # step-16 boundary is durable when train_loop returns.
    _, r1, _ = _run(8, steps=32, log_every=8, batches=batches[:16],
                    config=config, checkpoint_dir=ckpt)
    assert r1.steps_completed == 16
    # Resume from it with the rest of the data: the same trajectory,
    # bitwise (optimizer state restored, each step's dropout generator
    # derived from the seed and the step).
    resumed, r2, _ = _run(8, steps=32, log_every=8, batches=batches[16:],
                          config=config, checkpoint_dir=ckpt)
    assert r2.resumed_from_step == 16 and r2.steps_completed == 32
    assert r2.replayed_steps == 0
    assert _same_params(whole, resumed)
    assert sorted(_checkpoints(ckpt)) == [16, 24, 32]


def test_resume_reports_replayed_steps(tmp_path):
    ckpt = str(tmp_path / "ckpts")
    _run(4, steps=8, log_every=0, config={"checkpoint_every": 4},
         checkpoint_dir=ckpt)
    # The progress marker says 12 steps ran, the newest checkpoint is 8.
    _write_progress(ckpt, 12)
    _, r, _ = _run(4, steps=12, log_every=0, config={"checkpoint_every": 4},
                   checkpoint_dir=ckpt)
    assert r.resumed_from_step == 8 and r.replayed_steps == 4


def test_dropout_generator_is_required_in_training_and_seeds_by_step():
    model = _Toy().train()
    x = torch.ones(4, 2)
    with pytest.raises(ValueError, match="torch.Generator"):
        model(x)
    assert torch.equal(model.eval()(x), x @ model.w + model.b)
    g = step_generator
    draw = lambda s: torch.rand(8, generator=g(0, s, "cpu"))
    assert torch.equal(draw(3), draw(3))
    assert not torch.equal(draw(3), draw(4))


@pytest.mark.parametrize(
    "field,value,item",
    [
        ("mesh_config", {"data": 2}, "A5"),
        ("param_partition", {}, "A5"),
        ("batch_partition", {"x": None}, "A5"),
        ("dp_collective", "ordered", "A5"),
        ("collective_buckets", 4, "A5"),
        ("dp_grad_blocks", 2, "A5"),
        ("grad_accum_steps", 2, "A5"),
        ("profile_dir", "/tmp/profile", "A11"),
        ("tensorboard_dir", "/tmp/tb", "A11"),
        ("collect_cost_analysis", True, "A11"),
        ("peak_flops_per_chip", 989e12, "A11"),
    ],
)
def test_unported_config_field_raises(field, value, item, tmp_path,
                                     monkeypatch):
    """A5's and A11's fields were refused, naming their item, until they
    were ported: each must now run and take effect
    (tests/test_torch_dp_window.py holds A5's to the reference over several
    processes, tests/test_torch_train_extras.py A11's).  In one process a
    mesh of two does not cover it (the reference's error), on any axis
    (tensor and pipeline parallelism, A6b, run over several processes in
    tests/test_torch_tensor_parallel.py and
    tests/test_torch_pipeline_parallel.py).  ``batch_partition`` (sequence-partitioned
    inputs, A6a) runs in the implicit mode (held over several processes by
    tests/test_torch_seq_parallel.py) and raises the reference's errors for
    an explicit mode and for a key the batch lacks."""
    if item == "A5":
        if field == "batch_partition":
            with pytest.raises(ValueError, match="rides the implicit"):
                _run(1, steps=2, log_every=0,
                     config={field: value, "dp_collective": "ordered"})
            with pytest.raises(ValueError, match=r"keys \['z'\] not in batch"):
                _run(1, steps=2, log_every=0, config={field: {"z": None}})
            _, result, _ = _run(1, steps=2, log_every=0, config={field: value})
            assert result.steps_completed == 2
            return
        if field == "mesh_config":
            with pytest.raises(ValueError, match="does not cover 1 devices"):
                _run(1, steps=2, log_every=0, config={field: value})
            for axis in ("model", "pipe"):
                with pytest.raises(ValueError, match="does not cover 1 devices"):
                    _run(1, steps=2, log_every=0,
                         config={field: {"data": 1, axis: 2}})
                _, result, _ = _run(1, steps=2, log_every=0,
                                    config={field: {"data": 1, axis: 1}})
                assert result.steps_completed == 2
            return
        mode = {"param_partition": "fsdp", "collective_buckets": "psum_bucketed",
                "dp_grad_blocks": "ordered"}.get(field, "ordered")
        calls, buckets = [0], []
        attach = DataParallel.attach

        def counting_attach(self, model):
            attach(self, model)
            buckets.append(len(self._bucket_params))

        monkeypatch.setattr(DataParallel, "attach", counting_attach)

        def loss_fn(*args):
            calls[0] += 1
            return _toy_loss(*args)

        _, result = train_loop(
            loss_fn=loss_fn, init_params_fn=_toy_init, optimizer=_adam,
            train_iter=iter(_toy_batches(4)), device="cpu",
            config=TrainLoopConfig(train_steps=4, batch_size=BATCH,
                                   log_every=0, window_steps=2,
                                   **{"dp_collective": mode, field: value}))
        assert result.steps_completed == 4 and result.dp_collective == mode
        # The effect: forwards a step (blocks x micro-batches), buckets.
        per_step = {"dp_grad_blocks": 2, "grad_accum_steps": 2}.get(field, 1)
        assert calls[0] == 4 * per_step
        assert buckets == ([2] if field == "collective_buckets" else [0])
        return
    if field.endswith("_dir"):
        value = str(tmp_path / field)
    config = TrainLoopConfig(train_steps=8, batch_size=BATCH, log_every=2,
                             window_steps=4,
                             **{"collect_cost_analysis": True, field: value})
    _, result = train_loop(
        loss_fn=lambda m, b, g: (((m(b["x"])[:, 0] - b["y"]) ** 2).mean(), {}),
        init_params_fn=lambda g, s: nn.Linear(2, 1), optimizer=_adam,
        train_iter=iter(_toy_batches(8)), config=config, device="cpu")
    assert result.steps_completed == 8
    # The linear layer's product and its weight gradient: 2 x 2·B·2·1.
    assert result.cost_analysis_flops_per_step == 2 * 2 * BATCH * 2
    assert result.cost_analysis_source == "counted"
    if field == "profile_dir":
        assert result.window_steps == 1
        assert os.listdir(value) == ["train_steps_2-5.pt.trace.json"]
    elif field == "tensorboard_dir":
        assert os.listdir(value)[0].startswith("events.out.tfevents.")
    elif field == "peak_flops_per_chip":
        assert result.mfu is not None  # 64 FLOPs a step: rounds to 0


def test_unported_arguments_and_missing_cuda_raise():
    # has_model_state is ported (the module's buffers are its state): a
    # model without a floating-point buffer cannot hold any.
    with pytest.raises(ValueError, match="no floating-point buffer"):
        _run(1, steps=2, log_every=0, has_model_state=True)
    # A mesh is ported (A5, A6a, A6b): one of two processes does not cover
    # a run of one, on any axis.
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        _run(1, steps=2, log_every=0, mesh=make_mesh({"data": 2}, device="cpu"))
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        _run(1, steps=2, log_every=0, mesh=make_mesh({"data": 1, "seq": 2}, device="cpu"))
    for axis in ("model", "pipe"):
        with pytest.raises(ValueError, match="does not cover 1 devices"):
            _run(1, steps=2, log_every=0,
                 mesh=make_mesh({"data": 1, axis: 2}, device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="'cuda'"):
            train_loop(
                loss_fn=_toy_loss, init_params_fn=_toy_init, optimizer=_adam,
                train_iter=iter(_toy_batches(2)),
                config=TrainLoopConfig(train_steps=2),
            )
