"""The port's goodput algebra against ``ml_goodput_measurement``'s own.

``tpu_pipelines_torch/trainer/goodput.py`` computes goodput and badput
with its own copy of the library's algebra.  The reference's wrapper
cannot be the oracle: it passes ``logger=`` to a library that takes
``cloud_logger=``, so its recorder never starts (ROADMAP.md C).  The
oracle here is the library's ``GoodputCalculator`` itself, fed the same
entry list through a duck-typed ``cloud_logger``.  Cases: a clean run, a
run with a data-loading stall, a resumed run with replayed steps and the
restart's recovery gap, and the entries of a real ``train_loop`` run on
the CPU.  Goodput and every badput kind must agree to 1e-9 (percent; the
same float sums in another order), and the last productive step exactly.
"""

import json

import numpy as np
import pytest
import torch
from ml_goodput_measurement.src import goodput as lib

from tpu_pipelines_torch.trainer import goodput as gp
from tpu_pipelines_torch.trainer.goodput import GoodputTracker, job_goodput
from tpu_pipelines_torch.trainer.train_loop import TrainLoopConfig, train_loop

TOL = 1e-9
JOB = "train_loop"


class _Logger:
    """The calculator's side of the library's ``_CloudLogger``."""

    def __init__(self, entries):
        self.entries = list(entries)

    def write_cloud_logging_entry(self, entry):
        self.entries.append(entry)

    def read_cloud_logging_entries(self, start_time=None, end_time=None,
                                   last_entry_info=None):
        return list(self.entries), None


def _library(entries):
    calc = lib.GoodputCalculator(JOB, "local", cloud_logger=_Logger(entries))
    pct, badput, last_step = calc.get_job_goodput(include_badput_breakdown=True)
    flat = {}
    for kind, value in badput.items():
        if isinstance(value, dict):
            value = sum(value.values())
        flat[kind.name.lower()] = float(value)
    return float(pct), flat, int(last_step)


class _Clock:
    def __init__(self, t0=1_800_000_000.0):
        self.t = t0
        self.entries = []

    def add(self, key, dt=0.0, **extra):
        self.t += dt
        self.entries.append({gp.JOB_NAME: JOB, **extra, key: self.t})


def _run(clock, *, steps, step_s, first_step_s, first_step=0, load_s=0.2,
         stall_at=None, stall_s=0.0, end=True):
    clock.add(gp.JOB_START_TIME, 0.01)
    clock.add(gp.TPU_INIT_START_TIME, 0.0)
    clock.add(gp.TPU_INIT_END_TIME, 1.5)
    clock.add(gp.DATA_LOADING_START_TIME, 0.0)
    clock.add(gp.DATA_LOADING_END_TIME, load_s)
    clock.add(gp.TRAINING_PREP_START_TIME, 0.0)
    clock.add(gp.TRAINING_PREP_END_TIME, 0.7)
    for s in range(first_step, first_step + steps):
        if s % 4 == 0:          # one window's data load every 4 steps
            wait = stall_s if s == stall_at else 0.001
            clock.add(gp.DATA_LOADING_START_TIME, 0.0)
            clock.add(gp.DATA_LOADING_END_TIME, wait)
        # The first step (its capture included) runs first_step_s.
        dt = first_step_s if s == first_step + 1 else step_s
        clock.add(gp.STEP_START_TIME, dt if s > first_step else 0.0,
                  **{gp.STEP_COUNT: s})
    if end:
        clock.add(gp.JOB_END_TIME, step_s)


def _clean():
    c = _Clock()
    _run(c, steps=20, step_s=0.05, first_step_s=2.5)
    return c.entries


def _stall():
    c = _Clock()
    _run(c, steps=20, step_s=0.05, first_step_s=2.5, stall_at=8, stall_s=3.0)
    return c.entries


def _resumed():
    c = _Clock()
    _run(c, steps=14, step_s=0.05, first_step_s=2.5, end=False)
    c.t += 20.0                  # the crash and the restart's delay
    # The restart resumes from the checkpoint at step 8: steps 8..13 are
    # replayed.
    _run(c, steps=12, step_s=0.05, first_step_s=1.8, first_step=8)
    return c.entries


@pytest.mark.parametrize("name,make", [("clean", _clean), ("stall", _stall),
                                       ("resumed", _resumed)])
def test_algebra_matches_the_library(name, make):
    entries = make()
    want_pct, want_badput, want_step = _library(entries)
    got_pct, got_badput, got_step = job_goodput(entries)
    assert abs(got_pct - want_pct) <= TOL
    assert got_step == want_step
    for kind, value in want_badput.items():
        assert abs(got_badput.get(kind, 0.0) - value) <= TOL, (name, kind)
    assert set(got_badput) <= set(want_badput)
    if name == "stall":
        assert got_badput[gp.DATA_LOADING_ASYNC] > 0
    if name == "resumed":
        assert got_badput[gp.WASTED_PROGRESS] > 0
        assert got_badput[gp.INFRASTRUCTURE_RECOVERY] > 0
    assert got_badput[gp.PROGRAM_STARTUP] > 0


def _toy_run(tmp_path, steps=12, window=4):
    rng = np.random.default_rng(0)
    batches = [{"x": rng.normal(size=(8, 3)).astype(np.float32),
                "y": rng.normal(size=(8,)).astype(np.float32)}
               for _ in range(steps)]
    return train_loop(
        loss_fn=lambda m, b, g: (((m(b["x"])[:, 0] - b["y"]) ** 2).mean(), {}),
        init_params_fn=lambda g, s: torch.nn.Linear(3, 1),
        optimizer=lambda p: torch.optim.SGD(p, lr=0.1),
        train_iter=iter(batches),
        config=TrainLoopConfig(train_steps=steps, batch_size=8, log_every=4,
                               window_steps=window),
        checkpoint_dir=str(tmp_path / "run"), device="cpu")


def test_train_loop_reports_the_tracker_and_mirrors_its_entries(tmp_path):
    _, result = _toy_run(tmp_path)
    assert result.goodput_source == "goodput_tracker"
    assert 0.0 < result.goodput <= 1.0
    assert set(result.badput) <= set(gp.BADPUT_KINDS)
    assert result.goodput_post_compile > 0.0       # the proxy, beside it
    lines = [json.loads(l) for l in
             open(tmp_path / "run" / "goodput_log.jsonl")]
    keys = [next(k for k in e if k not in (gp.JOB_NAME, gp.STEP_COUNT))
            for e in lines]
    assert keys[0] == gp.JOB_START_TIME and keys[-1] == gp.JOB_END_TIME
    assert [e[gp.STEP_COUNT] for e in lines if gp.STEP_COUNT in e] == list(range(12))
    # The library reads the mirrored entries to the same figure.
    want_pct, want_badput, _ = _library(lines)
    got_pct, got_badput, _ = job_goodput(lines)
    assert abs(got_pct - want_pct) <= TOL
    for kind, value in want_badput.items():
        assert abs(got_badput.get(kind, 0.0) - value) <= TOL, kind
    assert result.goodput == round(got_pct / 100, 4)


def test_summary_shape_and_empty_tracker():
    t = GoodputTracker("t")
    assert t.summary() == {}                       # no job start
    for call in (t.job_start, t.tpu_init_start, t.tpu_init_end,
                 t.data_loading_start, t.data_loading_end,
                 t.training_prep_start, t.training_prep_end):
        call()
    for s in range(3):
        t.step_start(s)
    t.job_end()
    summary = t.summary()
    assert sorted(summary) == ["badput", "goodput", "last_step"]
    assert 0.0 <= summary["goodput"] <= 1.0 and summary["last_step"] == 2
    assert all(v > 0 for v in summary["badput"].values())


def test_the_mirror_counts_a_failed_write_and_gives_up_after_a_retry(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    t = GoodputTracker("t", jsonl_path=str(blocker / "sub" / "log.jsonl"),
                       mirror_retry_backoff_s=0.0)
    t.job_start()
    t.job_end()
    t.job_end()
    assert len(t.entries) == 3 and t._mirror_dead
