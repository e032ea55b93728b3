"""The train loop's checkpoints written off its thread
(``tpu_pipelines_torch/trainer/train_loop.py`` ``_AsyncCheckpointSaver``,
the port of the reference's saver of the same name), on a tiny BERT on the
CPU (2 layers, width 32, dropout 0.1, AdamW).

Every comparison is exact (``torch.equal``): a checkpoint is a copy of
the state at its step, so the asynchronous file must hold the same bits
as the synchronous save at that step, and a run resumed from it the same
bits as one resumed from the synchronous file.
"""

import functools
import importlib
import os
import threading

import numpy as np
import pytest
import torch

from tpu_pipelines_torch.examples import bert_module
from tpu_pipelines_torch.trainer import TrainLoopConfig, train_loop

# The module, not the function the package exports under the same name.
tl = importlib.import_module("tpu_pipelines_torch.trainer.train_loop")

HP = {"vocab_size": 64, "d_model": 32, "n_layers": 2, "n_heads": 2,
      "d_ff": 64, "max_len": 16, "dropout_rate": 0.1, "num_classes": 2,
      "attn_impl": "dense"}
BATCH = 4


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lengths = rng.integers(3, 17, BATCH)
        mask = (np.arange(16)[None, :] < lengths[:, None]).astype(np.int32)
        ids = rng.integers(1, HP["vocab_size"], (BATCH, 16)) * mask
        out.append({"input_ids": ids.astype(np.int32), "attention_mask": mask,
                    "label": (ids[:, 0] % 2).astype(np.int32)})
    return out


def _train(ckpt_dir, steps=8, every=2, keep=3, batches=None, window=2):
    return train_loop(
        loss_fn=bert_module.loss_fn,
        init_params_fn=functools.partial(bert_module.init_params_fn,
                                         hyperparameters=HP),
        optimizer=bert_module.adamw(1e-3),
        train_iter=iter(batches if batches is not None else _batches(steps)),
        config=TrainLoopConfig(train_steps=steps, batch_size=BATCH,
                               log_every=0, window_steps=window, seed=1,
                               checkpoint_every=every, keep_checkpoints=keep),
        checkpoint_dir=str(ckpt_dir),
        device="cpu",
    )


def _saver_threads():
    return [t for t in threading.enumerate() if t.name == "tpp-async-ckpt"]


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _assert_same_checkpoint(a, b):
    assert a["step"] == b["step"]
    assert list(a["model"]) == list(b["model"])
    for name in a["model"]:
        assert torch.equal(a["model"][name], b["model"][name]), name
    assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]
    assert sorted(a["optimizer"]["state"]) == sorted(b["optimizer"]["state"])
    for i, state in a["optimizer"]["state"].items():
        other = b["optimizer"]["state"][i]
        assert sorted(state) == sorted(other)
        for key, value in state.items():
            assert torch.equal(torch.as_tensor(value),
                               torch.as_tensor(other[key])), (i, key)


class _SyncSaver:
    """The synchronous save the loop made before, behind the saver's
    interface."""

    def __init__(self, checkpoint_dir, keep, device, dp=None, write=True):
        self.checkpoint_dir, self.keep = checkpoint_dir, keep

    def save(self, state):
        tl._save_checkpoint(self.checkpoint_dir, state, self.keep)

    def join(self):
        pass

    fence = join


def test_each_async_checkpoint_equals_the_synchronous_save_at_its_step(
        tmp_path, monkeypatch):
    sync_dir = tmp_path / "sync"
    real = tl._AsyncCheckpointSaver

    class Both(real):
        """Saves synchronously into ``sync_dir`` at the moment the
        asynchronous save snapshots."""

        def save(self, state):
            tl._save_checkpoint(str(sync_dir), state, 0)
            super().save(state)

    monkeypatch.setattr(tl, "_AsyncCheckpointSaver", Both)
    _train(tmp_path / "async", steps=8, every=2, keep=0)
    async_files = tl._checkpoints(str(tmp_path / "async"))
    assert sorted(async_files) == [2, 4, 6, 8]
    for step, path in async_files.items():
        _assert_same_checkpoint(_load(path),
                                _load(sync_dir / f"ckpt_{step}.pt"))
    assert not _saver_threads()


def test_the_final_checkpoint_is_on_disk_when_the_loop_returns(tmp_path):
    written = []
    real_write = tl._write_checkpoint

    def slow_write(*args, **kwargs):
        threading.Event().wait(0.2)   # the thread is still writing at exit
        real_write(*args, **kwargs)
        written.append(args[1]["step"])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tl, "_write_checkpoint", slow_write)
        _train(tmp_path, steps=5, every=0)
    assert written == [5]
    assert sorted(tl._checkpoints(str(tmp_path))) == [5]
    assert _load(tmp_path / "ckpt_5.pt")["step"] == 5
    assert not _saver_threads()


@pytest.mark.parametrize("keep", [1, 2, 3])
def test_pruning_keeps_keep_checkpoints(tmp_path, keep):
    _train(tmp_path, steps=8, every=2, keep=keep)
    assert sorted(tl._checkpoints(str(tmp_path))) == [2, 4, 6, 8][-keep:]
    assert not _saver_threads()


def test_a_save_error_surfaces_at_the_next_fence(tmp_path):
    saver = tl._AsyncCheckpointSaver(str(tmp_path), 3, torch.device("cpu"))
    model = torch.nn.Linear(2, 2)
    state = tl.TrainState(step=1, model=model,
                          optimizer=torch.optim.SGD(model.parameters(), 0.1),
                          seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tl, "_write_checkpoint",
                   lambda *a, **k: (_ for _ in ()).throw(OSError("disk full")))
        saver.save(state)
        with pytest.raises(OSError, match="disk full"):
            saver.fence()
    saver.fence()  # the error was raised once; nothing is pending
    state.step = 2
    saver.save(state)
    saver.fence()
    assert sorted(tl._checkpoints(str(tmp_path))) == [2]
    assert [r["step"] for r in saver.saves] == [1, 2]
    assert saver.saves[0]["write_s"] is None and saver.saves[1]["write_s"] > 0
    assert not _saver_threads()


@pytest.mark.parametrize("failing_step", [2, 8])
def test_a_save_error_raises_from_train_loop_and_leaves_no_thread(
        tmp_path, failing_step):
    real_write = tl._write_checkpoint

    def write(checkpoint_dir, payload, keep):
        if payload["step"] == failing_step:
            raise OSError(f"cannot write step {failing_step}")
        real_write(checkpoint_dir, payload, keep)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tl, "_write_checkpoint", write)
        with pytest.raises(OSError, match=f"cannot write step {failing_step}"):
            _train(tmp_path, steps=8, every=2)
    assert not _saver_threads()


def test_the_snapshot_is_taken_at_save_not_when_the_thread_writes(tmp_path):
    """The thread writes after the loop has moved on; the file still holds
    the state of the step the save was called at."""
    release = threading.Event()
    real_write = tl._write_checkpoint

    def held_write(*args, **kwargs):
        release.wait(5)
        real_write(*args, **kwargs)

    model = torch.nn.Linear(2, 2)
    opt = torch.optim.SGD(model.parameters(), 0.1)
    state = tl.TrainState(step=3, model=model, optimizer=opt, seed=0)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    saver = tl._AsyncCheckpointSaver(str(tmp_path), 3, torch.device("cpu"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tl, "_write_checkpoint", held_write)
        saver.save(state)
        with torch.no_grad():
            model.weight.add_(1.0)   # the loop's next step
        release.set()
        saver.fence()
    saved = _load(tmp_path / "ckpt_3.pt")["model"]
    assert all(torch.equal(saved[k], want[k]) for k in want)
    assert not torch.equal(saved["weight"], model.weight)


def test_a_resume_from_an_async_checkpoint_equals_one_from_a_sync_checkpoint(
        tmp_path, monkeypatch):
    batches = _batches(8, seed=3)
    # Four steps each way, then four more resumed from the step-4 file.
    _train(tmp_path / "async", steps=4, every=2, batches=batches[:4])
    with monkeypatch.context() as mp:
        mp.setattr(tl, "_AsyncCheckpointSaver", _SyncSaver)
        _train(tmp_path / "sync", steps=4, every=2, batches=batches[:4])
    _assert_same_checkpoint(_load(tmp_path / "async" / "ckpt_4.pt"),
                            _load(tmp_path / "sync" / "ckpt_4.pt"))
    model_a, result_a = _train(tmp_path / "async", steps=8, every=2,
                               batches=batches[4:])
    with monkeypatch.context() as mp:
        mp.setattr(tl, "_AsyncCheckpointSaver", _SyncSaver)
        model_s, result_s = _train(tmp_path / "sync", steps=8, every=2,
                                   batches=batches[4:])
    assert result_a.resumed_from_step == result_s.resumed_from_step == 4
    for (name, a), b in zip(model_a.state_dict().items(),
                            model_s.state_dict().values()):
        assert torch.equal(a, b), name
    _assert_same_checkpoint(_load(tmp_path / "async" / "ckpt_8.pt"),
                            _load(tmp_path / "sync" / "ckpt_8.pt"))
    assert not _saver_threads()
    assert os.path.exists(tmp_path / "async" / "window_progress.json")
