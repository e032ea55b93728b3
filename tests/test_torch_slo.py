"""The port's ``SLOMonitor`` and the fleet's probation rollback against the
reference's (``tests/test_request_trace.py`` "SLO monitor"): the same
registry events fed to both monitors give the same ``evaluate()`` tables
(burn rates compared exactly: the same float operations in the same
order), the same breaches and the same published series; the probation
rollback with quarantine and clear, and the expired probation, run the
same sequence on a CPU fleet of each package (stub payloads through the
version manager's loader seam) with the same outcome at every step.
"""

import os
import threading
import time

import numpy as np
import pytest

from tpu_pipelines.observability.metrics import MetricsRegistry as RefRegistry
from tpu_pipelines.observability.slo import SLOMonitor as RefMonitor
from tpu_pipelines_torch.observability.metrics import MetricsRegistry
from tpu_pipelines_torch.observability.slo import SLOMonitor


@pytest.fixture(autouse=True)
def no_leaked_threads():
    before = set(threading.enumerate())
    yield
    deadline = time.monotonic() + 10
    while True:
        leaked = [t for t in threading.enumerate()
                  if t not in before and t.is_alive()]
        if not leaked or time.monotonic() > deadline:
            break
        time.sleep(0.02)
    assert leaked == []


class _Pair:
    """One registry and monitor of each package, fed the same events."""

    def __init__(self, **kw):
        self.regs = (MetricsRegistry(), RefRegistry())
        self.breaches = ([], [])
        self.mons = (
            SLOMonitor(self.regs[0], on_breach=self.breaches[0].append, **kw),
            RefMonitor(self.regs[1], on_breach=self.breaches[1].append, **kw),
        )

    def latency(self, value, n=1):
        for reg in self.regs:
            h = reg.histogram("serving_request_latency_seconds", "",
                              labels=("endpoint",)).labels("predict")
            for _ in range(n):
                h.observe(value)

    def requests(self, code, n, endpoint="predict"):
        for reg in self.regs:
            reg.counter("serving_requests_total", "",
                        labels=("endpoint", "code")).labels(
                endpoint, str(code)).inc(n)

    def counter(self, name, n, labels=("replica",), values=("0",)):
        for reg in self.regs:
            reg.counter(name, "", labels=labels).labels(*values).inc(n)

    def gauge(self, name, value, labels, values):
        for reg in self.regs:
            reg.gauge(name, "", labels=labels).labels(*values).set(value)

    def evaluate(self, now):
        got, want = (m.evaluate(now=now) for m in self.mons)
        assert got == want
        return got

    def series(self, name, *values):
        got, want = (reg.get(name).labels(*values).get() for reg in self.regs)
        assert got == want
        return got


def test_slo_monitor_burn_rate_table():
    p = _Pair(slo_p99_s=0.1, min_events=10)
    p.evaluate(0.0)                            # baseline snapshot
    p.latency(0.01, 100)                       # all within SLO
    res = p.evaluate(60.0)
    assert res["windows"][60.0]["burn"]["latency_p99"] == 0.0
    assert not res["breaches"]
    # 30 of 100 over the SLO: bad fraction 0.3 / budget 0.01 = burn 30 on
    # both fast windows: a breach, the gauges published, the counter up.
    p.latency(0.01, 70)
    p.latency(1.0, 30)
    res = p.evaluate(120.0)
    assert res["windows"][60.0]["burn"]["latency_p99"] == pytest.approx(30.0)
    assert [b["slo"] for b in res["breaches"]] == ["latency_p99"]
    assert p.breaches[0] == p.breaches[1]
    assert p.breaches[0][0]["trigger"] == "fast"
    assert p.series("serving_slo_breaches_total", "latency_p99") == 1
    assert p.series("serving_slo_burn_rate", "60", "latency_p99") == \
        pytest.approx(30.0, abs=0.1)
    # Edge-triggered: still burning, no re-fire.
    p.latency(1.0, 50)
    assert not p.evaluate(180.0)["breaches"]
    # Cooled below half the threshold in every window: re-armed, and a
    # new burn episode fires again.
    p.latency(0.01, 4000)
    p.evaluate(2400.0)
    p.evaluate(4200.0)
    p.latency(1.0, 30)
    p.latency(0.01, 70)
    res = p.evaluate(4260.0)
    assert [b["slo"] for b in res["breaches"]] == ["latency_p99"]


def test_slo_monitor_5xx_and_shed_and_compiles():
    p = _Pair(min_events=10)
    p.evaluate(0.0)
    p.requests(200, 95)
    p.requests(500, 5)                         # 5% 5xx / 0.1% budget = 50
    res = p.evaluate(60.0)
    assert res["windows"][60.0]["burn"]["errors_5xx"] == pytest.approx(50.0)
    assert "errors_5xx" in [b["slo"] for b in res["breaches"]]
    p.counter("serving_load_shed_total", 20, labels=("endpoint",),
              values=("predict",))
    p.requests(200, 100)
    res = p.evaluate(90.0)
    assert res["windows"][60.0]["burn"]["shed"] > 0
    # Captures after warm-up: budget zero, any delta breaches.
    p.counter("serving_decode_compiles_after_warm_total", 1)
    res = p.evaluate(120.0)
    assert "compiles_after_warm" in [b["slo"] for b in res["breaches"]]
    # Scrape and management endpoints never consume request budget.
    before = p.mons[0]._collect()["req_total"]
    p.requests(200, 1000, endpoint="metrics")
    assert p.mons[0]._collect()["req_total"] == before
    assert p.mons[1]._collect()["req_total"] == before


def test_slo_monitor_min_events_guard():
    """A handful of slow requests in a quiet window must not page."""
    p = _Pair(slo_p99_s=0.1, min_events=20)
    p.evaluate(0.0)
    p.latency(5.0, 5)                          # 100% bad, but 5 events
    res = p.evaluate(60.0)
    assert "latency_p99" not in res["windows"][60.0]["burn"]
    assert not res["breaches"]


def test_slo_monitor_drift_kind_and_start_stop():
    p = _Pair(min_events=20, drift_threshold=0.3)
    p.evaluate(0.0)
    p.counter("serving_monitor_sampled_total", 50, labels=("model",),
              values=("m",))
    p.gauge("serving_drift_distance", 0.6, ("model", "feature", "kind"),
            ("m", "x", "skew_js"))
    res = p.evaluate(60.0)
    assert res["windows"][60.0]["burn"]["drift"] == pytest.approx(28.8)
    assert [b["slo"] for b in res["breaches"]] == ["drift"]
    # The thread runs evaluate() on its interval and stops.
    mon = SLOMonitor(MetricsRegistry())
    mon.start(0.01)
    time.sleep(0.05)
    mon.stop()
    assert mon._snaps


# ---------------------------------------------------- probation rollback


class FakeLoaded:
    """A stand-in payload: predict scales the 'x' feature."""

    def __init__(self, scale):
        self.scale = scale
        self.generate = None
        self.transform = None

    def predict(self, batch):
        return np.asarray(batch["x"], np.float64) * self.scale

    predict_transformed = predict


def _fake_payload(base, version, scale):
    vdir = base / str(version)
    vdir.mkdir(parents=True)
    (vdir / "scale.txt").write_text(str(scale))
    return str(vdir)


def _fake_loader(version_dir, device=None):
    with open(os.path.join(version_dir, "scale.txt")) as f:
        return FakeLoaded(float(f.read()))


def _server_cls(pkg, monkeypatch):
    root = "tpu_pipelines_torch" if pkg == "port" else "tpu_pipelines"
    monkeypatch.setattr(f"{root}.serving.fleet.versions._default_loader",
                        _fake_loader)
    if pkg == "port":
        from tpu_pipelines_torch.serving.fleet.versions import CanaryRefused
        from tpu_pipelines_torch.serving.server import ModelServer

        return (lambda *a, **kw: ModelServer(*a, device="cpu", **kw)), CanaryRefused
    from tpu_pipelines.serving.fleet.versions import CanaryRefused
    from tpu_pipelines.serving.server import ModelServer

    return ModelServer, CanaryRefused


def _probation_flow(pkg, tmp_path, monkeypatch):
    server_cls, refused = _server_cls(pkg, monkeypatch)
    base = tmp_path / pkg / "m"
    _fake_payload(base, 1, 1.0)
    server = server_cls("m", str(base), replicas=2, max_versions=2,
                        slo_p99_ms=100.0,
                        slo_monitor_interval_s=3600.0,  # wired, not started
                        swap_probation_s=300.0)
    mon, fleet = server.slo_monitor, server._fleet
    steps = []
    try:
        server.predict({"instances": [{"x": [1.0]}]})    # the canary batch
        mon.evaluate(now=0.0)
        _fake_payload(base, 2, 5.0)
        steps.append(server.reload())
        lat = server.metrics.histogram(
            "serving_request_latency_seconds", "", labels=("endpoint",)
        ).labels("predict")
        for _ in range(60):
            lat.observe(0.01)
        for _ in range(40):
            lat.observe(1.0)
        res = mon.evaluate(now=60.0)
        steps.append([b["slo"] for b in res["breaches"]])
        steps.append(fleet.active_version)
        steps.append(server.metrics.get("serving_auto_rollbacks_total").get())
        steps.append(sorted(fleet.versions.quarantined()))
        steps.append(server.health()["fleet"].get("quarantined_versions"))
        steps.append(server.predict({"instances": [{"x": [2.0]}]}))
        with pytest.raises(refused, match="quarantined"):
            server.reload()
        steps.append(fleet.active_version)
        steps.append(fleet.clear_quarantine())
        steps.append(server.reload())
        steps.append(fleet.active_version)
        # A second breach episode after our own rollback + the re-push:
        # the re-push opened a new probation window, so it rolls again.
        steps.append(fleet.versions.last_swap()["rollback"])
    finally:
        server.stop()
    return steps


def test_probation_rollback_quarantine_and_clear(tmp_path, monkeypatch):
    port = _probation_flow("port", tmp_path, monkeypatch)
    assert port == _probation_flow("ref", tmp_path, monkeypatch)
    assert port == ["2", ["latency_p99"], "1", 1, ["2"], ["2"],
                    {"predictions": [[2.0]]}, "1", ["2"], "2", "2", False]


def _expired_flow(pkg, tmp_path, monkeypatch):
    root = "tpu_pipelines_torch" if pkg == "port" else "tpu_pipelines"
    import importlib

    fleet_cls = importlib.import_module(f"{root}.serving.fleet").ServingFleet
    kw = {"device": "cpu"} if pkg == "port" else {}
    base = tmp_path / pkg / "m"
    d1 = _fake_payload(base, 1, 1.0)
    d2 = _fake_payload(base, 2, 2.0)
    steps = []
    fleet = fleet_cls("m", str(base), replicas=1, max_versions=2,
                      loader=_fake_loader, swap_probation_s=0.05, **kw)
    try:
        fleet.load_version(d1)
        fleet.load_version(d2)
        time.sleep(0.1)                        # probation over
        steps += [fleet.on_slo_breach({"slo": "latency_p99"}),
                  fleet.active_version, fleet.versions.quarantined()]
    finally:
        fleet.close()
    fleet2 = fleet_cls("m2", str(base), replicas=1, max_versions=2,
                       loader=_fake_loader, swap_probation_s=300.0, **kw)
    try:
        fleet2.load_version(d1)
        steps.append(fleet2.on_slo_breach({"slo": "a"}))   # no swap yet
        fleet2.load_version(d2)
        steps += [fleet2.on_slo_breach({"slo": "drift"}),  # declined
                  fleet2.on_slo_breach({"slo": "a"}),      # rolls back
                  fleet2.active_version,
                  fleet2.on_slo_breach({"slo": "b"})]      # once only
    finally:
        fleet2.close()
    return steps


def test_probation_expired_no_rollback_and_once_only(tmp_path, monkeypatch):
    port = _expired_flow("port", tmp_path, monkeypatch)
    assert port == _expired_flow("ref", tmp_path, monkeypatch)
    assert port == [False, "2", {}, False, False, True, "1", False]


def test_probation_window_reads_the_environment(tmp_path, monkeypatch):
    from tpu_pipelines_torch.serving.fleet import ServingFleet

    _fake_payload(tmp_path, 1, 1.0)
    monkeypatch.setenv("TPP_SWAP_PROBATION_S", "7.5")
    fleet = ServingFleet("m", str(tmp_path), replicas=1, loader=_fake_loader,
                         device="cpu")
    try:
        assert fleet.swap_probation_s == 7.5
    finally:
        fleet.close()
    monkeypatch.delenv("TPP_SWAP_PROBATION_S")
    fleet = ServingFleet("m", str(tmp_path), replicas=1, loader=_fake_loader,
                         device="cpu")
    try:
        assert fleet.swap_probation_s == 120.0
    finally:
        fleet.close()


def test_a_device_error_on_the_new_version_rolls_back(tmp_path, monkeypatch):
    """The card path's fault, on the CPU: DEVICE_ERROR on every replica
    while the new version serves answers 5xx (500s, then 503s as the
    breakers open: the failover to the other replica fails as well), the
    5xx burn breaches inside probation, and the fleet rolls back to the
    boot version, which answers 200 once a breaker's half-open probe
    re-admits its replica."""
    from tpu_pipelines_torch.testing import faults

    server_cls, _ = _server_cls("port", monkeypatch)
    _fake_payload(tmp_path, 1, 1.0)
    server = server_cls("m", str(tmp_path), replicas=2, max_versions=2,
                        slo_p99_ms=100.0, slo_monitor_interval_s=3600.0,
                        swap_probation_s=300.0, supervisor_interval_s=0.05)
    mon, fleet = server.slo_monitor, server._fleet
    try:
        port = server.start(port=0)
        import json
        import urllib.error
        import urllib.request

        def post(x):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/models/m:predict",
                data=json.dumps({"instances": [{"x": [x]}]}).encode(),
                method="POST")
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    return r.status
            except urllib.error.HTTPError as e:
                return e.code

        assert post(1.0) == 200
        mon.evaluate(now=0.0)
        _fake_payload(tmp_path, 2, 2.0)
        assert server.reload() == "2"
        plan = faults.FaultPlan({
            faults.REPLICA_KEY: faults.NodeFault(faults.DEVICE_ERROR,
                                                 times=10**6)})
        with plan.activate():
            codes = [post(1.0) for _ in range(30)]
        # 500s, and 503s once the breakers open: every one a 5xx.
        assert codes and all(c >= 500 for c in codes)
        res = mon.evaluate(now=60.0)
        assert "errors_5xx" in [b["slo"] for b in res["breaches"]]
        assert fleet.active_version == "1"
        assert sorted(fleet.versions.quarantined()) == ["2"]
        deadline = time.monotonic() + 20
        while post(3.0) != 200:
            assert time.monotonic() < deadline, "no replica re-admitted"
            time.sleep(0.1)
    finally:
        server.stop()
