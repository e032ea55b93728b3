"""Metric federation and the metrics-history ring, the port's against the
JAX package's, on the CPU.

The files on disk are the reference's format in both packages, so each
package reads what the other wrote: a federation snapshot published by one
is merged by the other's ``FederatedRegistry`` into the same exposition
(the ``federation_source_age_seconds`` values, which read the clock, are
left out of the comparison), and a history ring appended by one gives the
other the same entries, series, run deltas, rehydrated registry and
headline.  Numbers are compared exactly: both sides carry the same f64
values through JSON.

With every knob unset nothing is written: no spool, no ring, no file.
"""

import os
import re

import numpy as np
import pytest
import torch
from torch import nn

from tpu_pipelines.observability import federation as ref_fed
from tpu_pipelines.observability import metrics_history as ref_hist
from tpu_pipelines.observability.metrics import MetricsRegistry as RefRegistry
from tpu_pipelines_torch.observability import federation as port_fed
from tpu_pipelines_torch.observability import metrics_history as port_hist
from tpu_pipelines_torch.observability.metrics import MetricsRegistry
from tpu_pipelines_torch.trainer.train_loop import TrainLoopConfig, train_loop

SIDES = {
    "ref": (ref_fed, ref_hist, RefRegistry),
    "port": (port_fed, port_hist, MetricsRegistry),
}
KNOBS = ("TPP_FEDERATION_DIR", "TPP_METRICS_HISTORY",
         "TPP_METRICS_HISTORY_KEEP", "TPP_FED_REPLICA", "TPP_TENANT")


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)


def _fill(reg, scale=1.0):
    reg.counter("train_steps_total_c", "steps", labels=("phase",)).labels(
        "fit").inc(3 * scale)
    reg.counter("train_window_time_seconds", "phases",
                labels=("phase",)).labels("infeed_wait").inc(0.25 * scale)
    reg.counter("train_window_time_seconds", "phases",
                labels=("phase",)).labels("device_compute").inc(0.75 * scale)
    reg.gauge("train_mfu", "mfu").set(0.4 * scale)
    reg.gauge("train_steps_total", "steps").set(12 * scale)
    reg.counter("train_compiles_after_warm_total", "compiles").inc(0)
    reg.gauge("device_memory_peak_bytes", "peak",
              labels=("device",)).labels("0").set(2048 * scale)
    h = reg.histogram("serving_request_latency_seconds", "latency",
                      labels=("endpoint",))
    for v in (0.001, 0.004, 0.02 * scale):
        h.labels("predict").observe(v)
    return reg


_AGE = re.compile(r"^federation_source_age_seconds\{.*$", re.M)


def _exposition(fed, spool):
    text = fed.FederatedRegistry(
        None, spool_dir=spool, labels={"host": "h", "replica": "",
                                       "tenant": ""}).to_prometheus()
    return _AGE.sub("", text)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_snapshot_one_package_publishes_the_other_merges(tmp_path, writer):
    fed, _, registry = SIDES[writer]
    spool = str(tmp_path / "spool")
    for i, (replica, tenant) in enumerate((("0", "a"), ("1", "b"))):
        path = fed.publish_registry(
            _fill(registry(), scale=i + 1), spool_dir=spool,
            source=f"replica-{i}",
            labels={"host": "h", "replica": replica, "tenant": tenant})
        assert os.path.isfile(path)
    texts = {side: _exposition(SIDES[side][0], spool) for side in SIDES}
    assert texts["port"] == texts["ref"]
    assert 'train_mfu{host="h",replica="1",tenant="b"} 0.8' in texts["port"]
    assert "federation_sources 2" in texts["port"]


def test_the_codec_and_the_delta_match_the_reference():
    base = _fill(MetricsRegistry()).snapshot()
    later = _fill(_fill(MetricsRegistry()), scale=2.0).snapshot()
    for fed in (ref_fed, port_fed):
        assert fed.decode_snapshot(fed.encode_snapshot(later)) == later
    assert port_fed.encode_snapshot(later) == ref_fed.encode_snapshot(later)
    assert (port_fed.delta_snapshot(later, base)
            == ref_fed.delta_snapshot(later, base))


def test_a_local_registry_is_merged_once(tmp_path, monkeypatch):
    """A process that publishes its registry and serves the federated
    scrape counts itself once (the writer stamp), as the reference does."""
    monkeypatch.setenv("TPP_FEDERATION_DIR", str(tmp_path / "spool"))
    reg = _fill(MetricsRegistry())
    port_fed.publish_registry(reg, source="me")
    snap = port_fed.FederatedRegistry(reg).snapshot()
    series = snap["train_steps_total_c"]["series"]
    assert sum(series.values()) == 3.0
    assert snap["federation_sources"]["series"][()] == 1.0


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_history_ring_one_package_writes_the_other_reads(tmp_path, writer,
                                                          monkeypatch):
    monkeypatch.setenv("TPP_METRICS_HISTORY", "1")
    monkeypatch.setenv("TPP_METRICS_HISTORY_KEEP", "3")
    _, hist, registry = SIDES[writer]
    root = str(tmp_path / "root")
    ring = hist.MetricsHistory.from_env(root)
    for run, scale in (("run-a", 1.0), ("run-b", 3.0)):
        for step in range(4):
            ring.append(_fill(registry(), scale=scale + step), run, step=step,
                        labels={"version": "1"})
    got = {}
    for side, (_, h, _) in SIDES.items():
        r = h.MetricsHistory.for_pipeline_root(root)
        entries = r.entries("run-b")
        got[side] = {
            "runs": r.runs(),
            "seqs": [(e["seq"], e["step"], e["labels"]) for e in entries],
            "snapshots": [e["snapshot"] for e in entries],
            "series": [(row["step"], row["value"]) for row in r.series(
                "run-a", "train_window_time_seconds",
                labels={"phase": "infeed_wait"})],
            "delta": r.run_delta("run-a", "run-b"),
            "headline": r.headline("run-b"),
            "merged": r.merged_registry("run-a").to_prometheus(),
        }
    assert got["port"] == got["ref"]
    port = got["port"]
    assert port["runs"] == ["run-a", "run-b"]
    assert [s for s, _, _ in port["seqs"]] == [1, 2, 3]  # keep=3
    assert port["headline"]["infeed_wait_share"] == pytest.approx(0.25)
    assert port["headline"]["mfu"] == pytest.approx(0.4 * 6)
    assert port["headline"]["device_memory_peak_bytes"] == 2048 * 6


class _Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(2))

    def forward(self, x, generator=None):
        return x @ self.w


def _train(pipeline_root):
    rng = np.random.default_rng(0)
    batches = [{"x": rng.normal(size=(8, 2)).astype(np.float32),
                "y": rng.normal(size=(8,)).astype(np.float32)}
               for _ in range(8)]
    return train_loop(
        loss_fn=lambda m, b, g: (((m(b["x"], g) - b["y"]) ** 2).mean(), {}),
        init_params_fn=lambda g, s: _Toy(),
        optimizer=lambda p: torch.optim.SGD(p, lr=0.1),
        train_iter=iter(batches),
        config=TrainLoopConfig(train_steps=8, batch_size=8, log_every=4,
                               window_steps=4, pipeline_root=pipeline_root,
                               run_id="r1"),
        device="cpu",
    )


def test_the_train_loop_publishes_only_when_asked(tmp_path, monkeypatch):
    root = str(tmp_path / "root")
    spool = str(tmp_path / "spool")
    _train(root)
    assert not os.path.exists(os.path.join(root, ".runs"))
    assert not os.path.exists(spool)

    monkeypatch.setenv("TPP_METRICS_HISTORY", "1")
    monkeypatch.setenv("TPP_FEDERATION_DIR", spool)
    _train(root)
    ring = ref_hist.MetricsHistory.for_pipeline_root(root)
    assert ring.runs() == ["r1"]
    headline = ring.headline("r1")
    assert headline["steps"] == 8.0
    assert "infeed_wait_share" in headline
    sources = ref_fed.FederatedRegistry(None, spool_dir=spool).sources()
    assert [s["source"] for s in sources] == [f"trainer-p0-{os.getpid()}"]


def test_with_every_knob_unset_nothing_is_written(tmp_path):
    reg = _fill(MetricsRegistry())
    assert port_fed.federation_dir() is None
    assert port_fed.publish_registry(reg) is None
    port_fed.note_fork_baseline(reg)
    assert port_fed.publish_fork_delta(reg) is None
    assert port_hist.MetricsHistory.from_env(str(tmp_path)) is None
    assert os.listdir(tmp_path) == []


def _count_shard(task):
    from tpu_pipelines_torch.observability.metrics import default_registry

    default_registry().counter("fed_test_shards_total", "shards").inc()
    return task


def test_fork_pool_workers_publish_their_own_deltas(tmp_path, monkeypatch):
    """A fork-pool child publishes what it counted since the fork, not the
    counts it inherited from the parent."""
    from tpu_pipelines_torch.data import shard_plan
    from tpu_pipelines_torch.observability.metrics import default_registry

    spool = str(tmp_path / "spool")
    monkeypatch.setenv("TPP_FEDERATION_DIR", spool)
    monkeypatch.setenv("TPP_DATA_POOL", "process")
    default_registry().counter("fed_test_shards_total", "shards").inc(100)
    res = shard_plan.map_shards_resilient(_count_shard, list(range(4)),
                                          workers=2)
    assert res.results == [0, 1, 2, 3]
    merged = ref_fed.FederatedRegistry(None, spool_dir=spool).snapshot()
    assert sum(merged["fed_test_shards_total"]["series"].values()) == 4.0


def test_the_controllers_window_telemetry_reads_the_ring_as_the_reference(
        tmp_path, monkeypatch):
    """Each package's ``ContinuousController._window_telemetry`` reads two
    window runs' headlines from a ring the port wrote, and flags the same
    regressions of the second against the first."""
    from types import SimpleNamespace

    from tpu_pipelines.continuous.controller import (
        ContinuousController as RefController,
    )
    from tpu_pipelines_torch.continuous.controller import ContinuousController

    monkeypatch.setenv("TPP_METRICS_HISTORY", "1")
    root = str(tmp_path / "root")
    ring = port_hist.MetricsHistory.from_env(root)
    fast = MetricsRegistry()
    fast.counter("train_window_time_seconds", "phases",
                 labels=("phase",)).labels("infeed_wait").inc(0.1)
    fast.counter("train_window_time_seconds", "phases",
                 labels=("phase",)).labels("device_compute").inc(0.9)
    fast.gauge("train_steps_total", "steps").set(10)
    slow = MetricsRegistry()
    slow.counter("train_window_time_seconds", "phases",
                 labels=("phase",)).labels("infeed_wait").inc(0.6)
    slow.counter("train_window_time_seconds", "phases",
                 labels=("phase",)).labels("device_compute").inc(0.4)
    slow.gauge("train_steps_total", "steps").set(10)
    ring.append(fast, "w1", step=10)
    ring.append(slow, "w2", step=10)
    got = {}
    for side, cls in (("ref", RefController), ("port", ContinuousController)):
        fake = SimpleNamespace(_last_window_telemetry=None)
        got[side] = [cls._window_telemetry(fake, root, run)
                     for run in ("w1", "w2", "missing")]
        assert cls._window_telemetry(fake, "", "w1") == (None, [])
    assert got["port"] == got["ref"]
    (first, no_flags), (second, flags), missing = got["port"]
    assert no_flags == [] and flags and missing == (None, [])
    assert second["infeed_wait_share"] == pytest.approx(0.6)
