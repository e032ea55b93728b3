"""The captured training window's bookkeeping, on the CPU.

On CUDA the port's ``train_loop`` captures its step into a CUDA graph per
batch signature and replays it; nothing can capture here, so these tests
hold what the CPU can reach:

  - the launch tally of ``ops/flash_attention.py``, driven through its own
    interface: while a capture records, launches go into the tally and the
    counters stay as they are; each replay credits the tally once; a
    capture with no tally open raises;
  - the signature table: ``batch_signature`` keys a batch of tensors as
    the reference's ``AotDispatch.signature`` keys the same arrays;
  - the compile accounting: a batch signature first seen after the first
    window is a compile after warm-up (``TrainResult.compiles_after_warm``,
    ``train_compiles_after_warm_total``, ``train_compile_seconds_total``
    under ``when="steady"``), and a run of one shape counts none;
  - the loop's own dropout generator, re-seeded per step, draws what
    ``step_generator(seed, step)`` draws: the loop equals a hand-written
    eager loop bit for bit.
"""

import numpy as np
import pytest
import torch
from torch import nn

from tpu_pipelines.trainer.export import AotDispatch
from tpu_pipelines_torch.models.transformer import Dropout
from tpu_pipelines_torch.observability.metrics import default_registry
from tpu_pipelines_torch.ops import flash_attention as fa
from tpu_pipelines_torch.trainer import TrainLoopConfig, train_loop
from tpu_pipelines_torch.trainer.train_loop import batch_signature, step_generator


@pytest.fixture
def counters():
    """The flash-attention counters, restored after the test."""
    saved = {name: getattr(fa, name) for name in fa.COUNTERS}
    yield
    for name, value in saved.items():
        setattr(fa, name, value)


def _counts():
    return {name: getattr(fa, name) for name in fa.COUNTERS}


def test_captured_launches_go_to_the_tally_and_are_credited_per_replay(counters):
    before = _counts()
    with fa.launch_tally() as tally:
        for name in ("launches", "dvec_launches", "dq_launches", "dkv_launches"):
            for _ in range(3):                 # three layers' launches
                fa._count(name, capturing=True)
        assert _counts() == before             # a capture launches nothing
    assert tally == {"launches": 3, "dvec_launches": 3, "dq_launches": 3,
                     "dkv_launches": 3, "decode_launches": 0}
    fa.credit(tally)
    fa.credit(tally, replays=4)
    after = _counts()
    for name in ("launches", "dvec_launches", "dq_launches", "dkv_launches"):
        assert after[name] == before[name] + 15
    assert after["decode_launches"] == before["decode_launches"]
    fa._count("decode_launches", capturing=False)   # an eager launch
    assert fa.decode_launches == before["decode_launches"] + 1


def test_a_capture_without_a_tally_raises_and_tallies_do_not_nest(counters):
    before = _counts()
    with pytest.raises(RuntimeError, match="no launch tally open"):
        fa._count("launches", capturing=True)
    assert _counts() == before
    with fa.launch_tally():
        with pytest.raises(RuntimeError, match="already open"):
            with fa.launch_tally():
                pass
    with fa.launch_tally() as tally:           # closed again after the error
        fa._count("dq_launches", capturing=True)
    assert tally["dq_launches"] == 1 and _counts() == before


def _batch(batch=8, length=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(1, 50, (batch, length)).astype(np.int32),
            "attention_mask": np.ones((batch, length), np.int32),
            "label": rng.integers(0, 2, batch).astype(np.int64)}


def _signature(batch):
    return batch_signature({k: torch.from_numpy(v) for k, v in batch.items()})


def test_batch_signature_matches_the_references_aot_key():
    batch = _batch()
    assert _signature(batch) == AotDispatch.signature(batch)
    assert _signature(_batch(seed=1)) == _signature(batch)
    assert _signature(_batch(batch=4)) != _signature(batch)
    assert _signature({**batch, "label": batch["label"].astype(np.int32)}) \
        != _signature(batch)


# ---- the loop, on a toy regression with a dropout site

class _Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(2))
        self.b = nn.Parameter(torch.zeros(()))
        self.dropout = Dropout(0.25)

    def forward(self, x, generator=None):
        return self.dropout(x, generator) @ self.w + self.b


def _toy_batches(sizes, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        x = rng.normal(size=(n, 2)).astype(np.float32)
        y = (x @ np.array([3.0, -2.0], np.float32) + 1.0).astype(np.float32)
        out.append({"x": x, "y": y})
    return out


def _toy_loss(model, b, generator):
    pred = model(b["x"], generator)
    return ((pred - b["y"]) ** 2).mean(), {"w_norm": (model.w ** 2).sum()}


def _run(batches, window_steps, seed=0):
    losses = []
    model, result = train_loop(
        loss_fn=_toy_loss,
        init_params_fn=lambda generator, sample: _Toy(),
        optimizer=lambda params: torch.optim.Adam(params, lr=0.05),
        train_iter=iter(batches),
        config=TrainLoopConfig(train_steps=len(batches), batch_size=32,
                               log_every=1, window_steps=window_steps,
                               seed=seed),
        metrics_cb=lambda s, m: losses.append(m["loss"]),
        device="cpu",
    )
    return model, result, losses


def _compile_metrics():
    """(train_compiles_after_warm_total, train_compile_seconds_total by
    when); zeros before the first loop run registers them."""
    reg = default_registry()
    count, seconds = (reg.get("train_compiles_after_warm_total"),
                      reg.get("train_compile_seconds_total"))
    return (0.0 if count is None else count.get(),
            {when: 0.0 if seconds is None else seconds.labels(when).get()
             for when in ("warmup", "steady")})


@pytest.mark.parametrize(
    "sizes,window_steps,want",
    [
        ([32] * 8, 4, 0),                  # one shape: no compile after warm
        ([32] * 8, 1, 0),                  # ... also on the per-step path
        ([32] * 8 + [16], 4, 1),           # a smaller tail batch, own window
        ([32] * 4 + [16] * 4, 4, 1),       # a new shape for a whole window
        ([32, 32, 32, 32, 16], 1, 1),      # the per-step path's tail batch
        ([16] + [32] * 7, 1, 1),           # the first window holds one step
        ([32] * 8 + [16, 24], 1, 2),       # two new shapes, two captures
    ],
)
def test_a_new_batch_signature_after_the_first_window_is_a_compile_after_warm(
        sizes, window_steps, want):
    count0, seconds0 = _compile_metrics()
    _, result, losses = _run(_toy_batches(sizes), window_steps)
    count1, seconds1 = _compile_metrics()
    assert result.steps_completed == len(sizes) and len(losses) == len(sizes)
    assert np.all(np.isfinite(losses))
    assert result.compiles_after_warm == want
    assert count1 - count0 == want
    # The CPU captures nothing, so no capture seconds accrue; the series
    # exists for both phases.
    assert seconds1 == seconds0


def test_the_loop_draws_each_steps_dropout_masks_from_its_step_seed():
    batches = _toy_batches([32] * 6)
    model, _, losses = _run(batches, 3, seed=7)

    torch.manual_seed(123)    # the loop never reads the global stream
    want = _Toy().train()
    opt = torch.optim.Adam(want.parameters(), lr=0.05)
    want_losses = []
    for s, b in enumerate(batches):
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        loss, _ = _toy_loss(want, batch, step_generator(7, s, "cpu"))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        want_losses.append(float(loss.detach()))
    assert losses == want_losses
    assert all(torch.equal(a, b) for a, b in
               zip(model.parameters(), want.parameters()))
    _, _, reseeded = _run(batches, 3, seed=8)
    assert reseeded != losses
