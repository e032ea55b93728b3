"""The port's live drift plane (``observability/drift.py``) against the
reference's (``tests/test_drift.py``): the same offers into a sampler of
each package give windows whose statistics equal each other's and the
batch statistics of the same rows (``to_json`` exactly), the same scores
and the same alerts; the credit sampler's exact rate, a wedged queue that
never blocks, the ``min_samples`` guard, the fleet's attribution and
training-statistics baseline (read from the payload spec the Pusher
stamps), no sampler when off, and the CLI's ``drift`` report (the same
parse and text as the reference on the same scrape).
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pyarrow as pa
import pytest

from tpu_pipelines.data.statistics import compute_split_statistics as ref_stats
from tpu_pipelines.observability import drift as ref_drift
from tpu_pipelines.observability.metrics import MetricsRegistry as RefRegistry
from tpu_pipelines_torch.data.examples_io import Table
from tpu_pipelines_torch.data.statistics import (
    SplitStatsAccumulator,
    save_statistics,
)
from tpu_pipelines_torch.observability import drift
from tpu_pipelines_torch.observability.metrics import MetricsRegistry


def _batch(rng, n, loc=0.0, cat=("a", "b")):
    return {
        "x": rng.normal(loc, 1.0, n),
        "cat": np.asarray([cat[i % len(cat)] for i in range(n)], dtype=object),
    }


def _port_stats(split, columns):
    acc = SplitStatsAccumulator(split)
    acc.update(Table({k: (np.asarray(v, dtype="U") if np.asarray(v).dtype == object
                          else v) for k, v in columns.items()}))
    return acc.finalize()


def _samplers(**kw):
    kw.setdefault("sample_rate", 1.0)
    kw.setdefault("window_s", 3600.0)
    port = drift.TrafficSampler("m", registry=MetricsRegistry(), **kw)
    ref = ref_drift.TrafficSampler("m", registry=RefRegistry(), **kw)
    return port, ref


def _window_view(w):
    return {
        "version": w.version, "index": w.index, "sampled": w.sampled,
        "scores": [(s.feature, s.kind, s.distance, s.threshold, s.breached)
                   for s in w.scores],
        "prediction_scores": w.prediction_scores,
        "statistics": w.statistics.to_json(),
        "json": w.to_json(),
    }


# ------------------------------------------- streaming == batch identity


def test_window_stats_equal_batch_statistics_and_the_reference():
    rng = np.random.default_rng(7)
    batch = _batch(rng, 256)
    preds = rng.normal(size=256)
    port, ref = _samplers()
    assert port.offer("1", batch, preds) is True
    assert ref.offer("1", batch, preds) is True
    port.drain()
    ref.drain()
    (pw,), (rw,) = port.close_window(), ref.close_window()
    assert pw.sampled == rw.sampled == 256
    want = ref_stats("serving", pa.table(ref_drift.batch_to_columns(batch)))
    assert pw.statistics.to_json() == want.to_json()
    assert _window_view(pw) == _window_view(rw)


def test_chunked_offers_fold_as_the_reference():
    rng = np.random.default_rng(11)
    chunks = [_batch(rng, n) for n in (40, 90, 30)]
    port, ref = _samplers()
    for c in chunks:
        p = rng.normal(size=len(c["x"]))
        port.offer("1", c, p)
        ref.offer("1", c, p)
    port.drain()
    ref.drain()
    (pw,), (rw,) = port.close_window(), ref.close_window()
    assert pw.sampled == 160
    assert _window_view(pw) == _window_view(rw)


# ------------------------------------------------ critical-path contract


def test_deterministic_credit_sampler_hits_exact_rate():
    port, ref = _samplers(sample_rate=0.25)
    taken = [sum(s.offer("1", {"x": np.ones(2)}, np.ones(2))
                 for _ in range(100)) for s in (port, ref)]
    assert taken == [25, 25]
    assert port.registry.get("serving_monitor_sampled_total").labels(
        "m").get() == 25


def test_wedged_queue_drops_and_never_blocks():
    port, _ = _samplers(queue_max=1)
    t0 = time.monotonic()
    results = [port.offer("1", {"x": np.ones(4)}, np.ones(4))
               for _ in range(400)]
    assert time.monotonic() - t0 < 5.0
    assert results[0] is True and not any(results[1:])
    reg = port.registry
    assert reg.get("serving_monitor_dropped_total").labels("m").get() == 399
    assert reg.get("serving_monitor_sampled_total").labels("m").get() == 1


# ------------------------------------------------------- window scoring


def test_shifted_window_alerts_control_stays_quiet():
    """Control traffic from the training distribution scores clean; a
    shifted window breaches skew (vs the training baseline) and drift (vs
    the previous window), in both packages alike."""
    rng = np.random.default_rng(3)
    train = _batch(rng, 4000)
    base_port = _port_stats("train", drift.batch_to_columns(train))
    base_ref = ref_stats("train", pa.table(ref_drift.batch_to_columns(train)))
    assert base_port.to_json() == base_ref.to_json()
    alerts = ([], [])
    wins = ([], [])
    port = drift.TrafficSampler(
        "m", sample_rate=1.0, window_s=3600.0, registry=MetricsRegistry(),
        baseline_for=lambda v: (base_port, "mem://baseline"),
        on_alert=alerts[0].append, on_window=wins[0].append)
    ref = ref_drift.TrafficSampler(
        "m", sample_rate=1.0, window_s=3600.0, registry=RefRegistry(),
        baseline_for=lambda v: (base_ref, "mem://baseline"),
        on_alert=alerts[1].append, on_window=wins[1].append)
    n = 2000
    for batch, preds in ((_batch(rng, n), rng.normal(size=n)),
                         (_batch(rng, n, loc=5.0, cat=("a",)),
                          rng.normal(5.0, 1.0, n))):
        for s in (port, ref):
            s.offer("1", batch, preds)
            s.drain()
            s.close_window()
    assert [_window_view(w) for w in wins[0]] == [
        _window_view(w) for w in wins[1]]
    assert alerts[0] == alerts[1]
    control, shifted = wins[0]
    assert control.baseline_uri == "mem://baseline"
    assert control.alerts == []
    kinds = {sc.kind for sc in shifted.scores if sc.breached}
    assert {"skew_js", "drift_js"} <= kinds
    assert {"skew_linf", "drift_linf"} & kinds
    assert shifted.prediction_scores["mean_shift"] > 3.0
    assert {a["kind"] for a in alerts[0]} == {"skew", "drift"}
    assert all(a["slo"] == "drift" for a in alerts[0])
    scrape = port.registry.to_prometheus()
    report = drift.parse_drift_scrape(scrape)
    assert report == ref_drift.parse_drift_scrape(scrape)
    assert report["alerts_total"] == 2
    assert report["max_skew"] > drift.DEFAULT_DRIFT_THRESHOLD
    assert report["coverage_ratio"] == 1.0
    assert drift.format_drift_report(report) == \
        ref_drift.format_drift_report(report)


def test_min_samples_guard_suppresses_thin_window_alerts():
    rng = np.random.default_rng(5)
    base = _port_stats("train", drift.batch_to_columns(_batch(rng, 2000)))
    alerts = []
    s = drift.TrafficSampler("m", sample_rate=1.0, window_s=3600.0,
                             registry=MetricsRegistry(),
                             baseline_for=lambda v: base, min_samples=20,
                             on_alert=alerts.append)
    s.offer("1", _batch(rng, 5, loc=50.0, cat=("z",)), np.ones(5))
    s.drain()
    win = s.close_window()[0]
    assert win.sampled == 5
    assert any(sc.breached for sc in win.scores)      # scored...
    assert alerts == []                               # ...but no page


def test_text_and_null_columns_fold_as_the_reference():
    """The serving shapes the BERT payloads get: a text column (an object
    array of strings, one None) and an int label; the wide 2-D columns
    are skipped in both."""
    batch = {
        "text": np.asarray(["great film", None, "dull", "dull"], dtype=object),
        "label": np.asarray([1, 0, 0, 1]),
        "input_ids": np.zeros((4, 8), np.int64),
    }
    preds = np.asarray([[0.1, 0.9], [0.8, 0.2], [0.7, 0.3], [0.4, 0.6]])
    port, ref = _samplers()
    for s in (port, ref):
        s.offer("1", batch, preds)
        s.drain()
    (pw,), (rw,) = port.close_window(), ref.close_window()
    assert _window_view(pw) == _window_view(rw)
    assert set(pw.statistics.features) == {"text", "label"}


# ------------------------------------------------------ fleet wiring


class FakeLoaded:
    def __init__(self, scale, spec=None):
        self.scale = scale
        self.spec = spec or {}
        self.generate = None
        self.transform = None

    def predict(self, batch):
        return np.asarray(batch["x"], np.float64) * self.scale

    predict_transformed = predict


def _fake_payload(base, version):
    vdir = base / str(version)
    vdir.mkdir(parents=True)
    return str(vdir)


def test_fleet_sampler_attribution_baseline_and_breach_policy(tmp_path):
    from tpu_pipelines_torch.serving.fleet import ServingFleet

    rng = np.random.default_rng(13)
    stats_uri = str(tmp_path / "stats")
    save_statistics(stats_uri, {"train": _port_stats(
        "train", {"x": rng.normal(size=500)})})
    base = tmp_path / "m"
    d1, d2 = _fake_payload(base, 1), _fake_payload(base, 2)
    reg = MetricsRegistry()
    fleet = ServingFleet(
        "m", str(base), replicas=1, max_versions=2,
        loader=lambda d: FakeLoaded(
            1.0, {"training_statistics_uri": stats_uri}),
        monitor_sample_rate=1.0, monitor_window_s=3600.0, registry=reg,
        device="cpu")
    try:
        assert fleet.sampler is not None
        wins = []
        fleet.sampler.on_window = wins.append
        fleet.load_version(d1)
        assert fleet.submit({"x": np.arange(8.0)}, 8).shape == (8,)
        deadline = time.monotonic() + 10
        while (reg.get("serving_monitor_sampled_total").labels("m").get() < 1
               and time.monotonic() < deadline):
            time.sleep(0.01)
        fleet.load_version(d2)
        fleet.submit({"x": np.arange(4.0)}, 4)
        assert fleet.health()["drift"]["sample_rate"] == 1.0
        assert fleet.on_slo_breach({"slo": "drift"}) is False
        assert fleet.active_version == "2"
    finally:
        fleet.close()
    assert {w.version for w in wins} == {"1", "2"}
    for w in wins:
        assert w.baseline_uri == stats_uri
        assert any(sc.kind.startswith("skew") for sc in w.scores)
    assert not any("tpp-drift-sampler" in t.name for t in threading.enumerate())


def test_fleet_and_server_without_monitor_have_no_sampler(tmp_path, monkeypatch):
    from tpu_pipelines_torch.serving.fleet import ServingFleet
    from tpu_pipelines_torch.serving.server import ModelServer

    base = tmp_path / "m"
    d1 = _fake_payload(base, 1)
    reg = MetricsRegistry()
    fleet = ServingFleet("m", str(base), replicas=1, max_versions=2,
                         loader=lambda d: FakeLoaded(1.0), registry=reg,
                         device="cpu")
    try:
        fleet.load_version(d1)
        fleet.submit({"x": np.arange(3.0)}, 3)
        assert fleet.sampler is None and "drift" not in fleet.health()
        scrape = reg.to_prometheus()
        assert "serving_monitor" not in scrape and "serving_drift" not in scrape
    finally:
        fleet.close()
    # The environment turns it on, and makes a single server a fleet.
    monkeypatch.setattr(
        "tpu_pipelines_torch.serving.fleet.versions._default_loader",
        lambda d, device=None: FakeLoaded(1.0))
    monkeypatch.setenv("TPP_SERVING_MONITOR_SAMPLE", "0.5")
    monkeypatch.setenv("TPP_SERVING_MONITOR_WINDOW_S", "30")
    server = ModelServer("m", str(base), device="cpu")
    try:
        assert server._fleet is not None and server.slo_monitor is None
        assert server._fleet.sampler.sample_rate == 0.5
        assert server._fleet.sampler.window_s == 30.0
    finally:
        server.stop()


def test_cli_drift_report_json_and_alert_gate(monkeypatch, capsys):
    from tpu_pipelines.__main__ import main as ref_main
    from tpu_pipelines_torch.__main__ import main

    reg = MetricsRegistry()
    s = drift.TrafficSampler("m", sample_rate=1.0, window_s=3600.0,
                             registry=reg)
    rng = np.random.default_rng(2)
    for loc in (0.0, 4.0):
        s.offer("1", _batch(rng, 200, loc=loc), rng.normal(loc, 1, 200))
        s.drain()
        s.close_window()
    scrape = reg.to_prometheus()

    class _Resp:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def read(self):
            return scrape.encode()

    urls = []

    def fake_urlopen(url, timeout=10):
        urls.append(url)
        return _Resp()

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    url = "http://127.0.0.1:1/v1/models/m"
    outs = {}
    for name, fn in (("port", main), ("ref", ref_main)):
        assert fn(["drift", "--url", url]) == 0
        text = capsys.readouterr().out
        assert fn(["drift", "--url", url, "--json"]) == 0
        outs[name] = (text, json.loads(capsys.readouterr().out))
        assert fn(["drift", "--url", url, "--fail-on-alert"]) == 3
        capsys.readouterr()
    assert urls[0] == "http://127.0.0.1:1/metrics"
    assert outs["port"] == outs["ref"]
    assert "drift_js" in outs["port"][0]
    assert outs["port"][1]["alerts_total"] >= 1

    def broken(url, timeout=10):
        raise OSError("connection refused")

    monkeypatch.setattr(urllib.request, "urlopen", broken)
    assert main(["drift", "--url", url]) == 1
    capsys.readouterr()
