"""Port parity: the windowed infeed, PyTorch port vs the JAX package.

The port's ``data/input_pipeline.py`` keeps its own copy of the
reference's ``_prefetched`` and ``windowed_infeed``.  Both run here on the
same numpy batches made from a seed, with ``stage`` the identity, and must
give the same window lengths and the same stacked arrays, bit for bit
(both are ``np.stack`` of the same arrays): at full windows, with a
schedule whose last window is shorter, with a source that ends mid-window,
and with a source that raises (re-raised at the consumer's position).  A
consumer that breaks off leaves no producer thread behind.  On the CPU
the port's ``WindowStager`` is the plain stack as tensors.
"""

import itertools
import threading
import time

import numpy as np
import pytest
import torch

from tpu_pipelines.data import input_pipeline as ref
from tpu_pipelines_torch.data import input_pipeline as port


def _batches(n, seed=0, batch=4, length=6):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 100, (batch, length)).astype(np.int32),
             "weight": rng.normal(size=(batch,)).astype(np.float32)}
            for _ in range(n)]


def _windows(module, batches, lengths, prefetch):
    return list(module.windowed_infeed(iter(batches), iter(lengths),
                                       lambda stacked: stacked, prefetch))


def _assert_same_windows(got, want):
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            assert np.array_equal(g[k], w[k]), k


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize(
    "n_batches,lengths,want_lengths",
    [
        (12, [4, 4, 4], [4, 4, 4]),        # full windows
        (10, [4, 4, 2], [4, 4, 2]),        # the schedule's short last window
        (10, [4, 4, 4, 4], [4, 4, 2]),     # the source ends mid-window
        (8, [4, 4, 4], [4, 4]),            # ... and exactly at a boundary
        (5, [1, 1, 1, 1, 1, 1], [1] * 5),  # the per-step schedule
    ],
)
def test_windows_match_the_reference(n_batches, lengths, want_lengths, prefetch):
    batches = _batches(n_batches, seed=n_batches)
    want = _windows(ref, batches, lengths, prefetch)
    got = _windows(port, batches, lengths, prefetch)
    assert [n for n, _ in want] == want_lengths
    _assert_same_windows(got, want)
    first = np.stack([b["input_ids"] for b in batches[:want_lengths[0]]])
    assert np.array_equal(got[0][1]["input_ids"], first)


def _raising(batches, after):
    for i, b in enumerate(batches):
        if i == after:
            raise ValueError(f"source failed at batch {after}")
        yield b


@pytest.mark.parametrize("module", [ref, port], ids=["reference", "port"])
def test_prefetched_reraises_at_the_consumers_position(module):
    batches = _batches(6, seed=3)
    got = []
    with pytest.raises(ValueError, match="source failed at batch 4"):
        for item in module._prefetched(_raising(batches, 4), depth=2):
            got.append(item)
    assert len(got) == 4
    assert all(g is b for g, b in zip(got, batches))


def test_windowed_infeed_reraises_after_the_same_windows():
    batches = _batches(9, seed=4)
    seen = {}
    for name, module in (("reference", ref), ("port", port)):
        windows = []
        with pytest.raises(ValueError, match="source failed at batch 7"):
            for item in module.windowed_infeed(_raising(batches, 7),
                                               iter([2] * 5),
                                               lambda stacked: stacked):
                windows.append(item)
        seen[name] = windows
    assert [n for n, _ in seen["port"]] == [2, 2]
    _assert_same_windows(seen["port"], seen["reference"])


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "tpp-prefetch" and t.is_alive()]


def test_no_producer_thread_left_after_the_consumer_breaks():
    before = len(_prefetch_threads())
    endless = ({"x": np.full((2,), i, np.int64)} for i in itertools.count())
    infeed = port.windowed_infeed(endless, itertools.repeat(3),
                                  lambda stacked: stacked)
    got = [next(infeed) for _ in range(3)]
    assert [int(w["x"][0, 0]) for _, w in got] == [0, 3, 6]
    assert len(_prefetch_threads()) == before + 1
    infeed.close()
    deadline = time.monotonic() + 5.0
    while len(_prefetch_threads()) > before and time.monotonic() < deadline:
        time.sleep(0.02)
    assert len(_prefetch_threads()) == before


def test_window_stager_on_the_cpu_is_the_plain_stack():
    batches = _batches(3, seed=5)
    (n, staged), = _windows(port, batches, [3], 0)
    window = port.WindowStager("cpu")(staged)
    assert n == 3 and window.event is None and window.host is None
    window.wait()
    for k, v in staged.items():
        t = window.tensors[k]
        assert t.device.type == "cpu" and t.dtype == torch.from_numpy(v).dtype
        assert np.array_equal(t.numpy(), v)
    step1 = window.step(1)
    assert np.array_equal(step1["input_ids"].numpy(), batches[1]["input_ids"])
    window.release()
