"""The port's serving fleet on the CPU, against the JAX package's fleet.

Most cases run the fleet's machinery (version leases, the canary gate,
router, per-replica batchers, supervisor, the REST surface) on a stub
payload through the version manager's loader seam, as the reference's
``tests/test_serving_fleet.py`` does; where the two packages share the
arithmetic (the SLO gather window, the router's pick, the version
manager's residency) both are driven through the same sequence and must
agree exactly (float equality: the same IEEE operations in the same
order).  The last case serves a tiny BERT (the weights of
``tests/test_torch_serving.py``, converted) through a 2-replica fleet of
each package: replies within that file's bf16 tolerance, atol 5e-2.

Every test closes what it starts: a fixture fails it if a thread it
started is still alive at its end.
"""

import json
import os
import re
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from tpu_pipelines_torch.observability.metrics import MetricsRegistry
from tpu_pipelines_torch.serving.server import ModelServer
from tpu_pipelines_torch.testing import faults
from tpu_pipelines_torch.trainer.export import AotDispatch


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


class FakeLoaded:
    """A stand-in payload: predict scales the 'x' feature by the payload's
    recorded scale (a NaN payload is the broken export the canary must
    catch)."""

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


@pytest.fixture
def fake_loader(monkeypatch):
    monkeypatch.setattr(
        "tpu_pipelines_torch.serving.fleet.versions._default_loader",
        _fake_loader)
    # The single-server path (server.py binds the name at import).
    monkeypatch.setattr(
        "tpu_pipelines_torch.serving.server.load_exported_model",
        _fake_loader)
    return _fake_loader


def _post(url, body=b"{}", timeout=30):
    req = urllib.request.Request(url, data=body)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


# ------------------------------------------------------- SLO gather window

@pytest.mark.parametrize("slo_s, steps", [
    (0.0, [0.02, 0.03]),          # unconfigured: the fixed window
    (0.2, []),                    # before the first step: the fixed window
    (0.2, [0.02]),                # the first step seeds the EWMA
    (0.2, [0.02] + [0.03] * 20),  # the window tracks the EWMA's drift
    (0.05, [0.01, 0.002, 0.04]),
    (0.2, [0.15] * 10),           # steps eat the budget: 0, never negative
])
def test_gather_window_matches_the_jax_batcher(slo_s, steps):
    from tpu_pipelines.serving.batching import RequestBatcher as JaxBatcher
    from tpu_pipelines_torch.serving.batching import RequestBatcher

    windows = []
    for cls in (JaxBatcher, RequestBatcher):
        reg = MetricsRegistry() if cls is RequestBatcher else None
        b = cls(lambda batch: np.asarray(batch["x"]), max_batch_size=8,
                batch_timeout_s=0.005, slo_p99_s=slo_s, registry=reg)
        try:
            seen = [b.gather_window_s()]
            for s in steps:
                b._observe_step(s)
                seen.append(b.gather_window_s())
            windows.append(seen)
        finally:
            b.close()
    assert windows[1] == windows[0]
    assert min(windows[1]) >= 0.0
    assert reg.get("serving_batch_deadline_seconds").get() == windows[1][-1]
    if steps:
        assert reg.get("serving_model_step_seconds").get() == b._step_ewma_s


def test_slo_batcher_serves_rows_and_ages_its_oldest_work():
    """Row-correct results under the SLO window; ``oldest_work_age_s``
    grows behind a wedged device call and the two-phase close fails the
    wedged group at its deadline."""
    from tpu_pipelines_torch.serving.batching import RequestBatcher

    b = RequestBatcher(lambda batch: np.asarray(batch["x"]) * 2.0,
                       max_batch_size=8, batch_timeout_s=0.005,
                       slo_p99_s=0.05)
    try:
        with ThreadPoolExecutor(max_workers=6) as pool:
            futs = [pool.submit(b.submit, {"x": np.full((2, 3), float(i))}, 2)
                    for i in range(12)]
            for i, f in enumerate(futs):
                np.testing.assert_array_equal(f.result(timeout=30),
                                              np.full((2, 3), 2.0 * i))
        assert b._step_ewma_s is not None and b.requests_served == 12
        assert b.oldest_work_age_s() == 0.0
    finally:
        b.close()

    release = threading.Event()
    wedged = RequestBatcher(lambda batch: release.wait(10) and batch["x"],
                            max_batch_size=2, batch_timeout_s=0.001)
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(wedged.submit, {"x": np.ones((1, 1))}, 1, 30.0)
        time.sleep(0.2)
        assert wedged.oldest_work_age_s() >= 0.15
        wedged.request_close()
        wedged.join_close(0.2)
        with pytest.raises(RuntimeError, match="closed"):
            fut.result(timeout=10)
        release.set()
    wedged.join_close(5)


# ------------------------------------------------------------------ router

def _replicas(package, states):
    """Replicas of ``package`` ("jax" or "torch") put in the observed
    (queue depth, EWMA p99) states."""
    if package == "jax":
        from tpu_pipelines.serving.fleet import Replica
        kwargs = {}
    else:
        from tpu_pipelines_torch.serving.fleet import Replica
        kwargs = {"device": "cpu"}
    replicas = []
    for i, (depth, p99) in enumerate(states):
        r = Replica(i, lambda batch: np.asarray(batch["x"]),
                    max_batch_size=2, batch_timeout_s=0.001, **kwargs)
        r._inflight = depth
        if p99:
            r.latency.ewma_p99_s = p99
            r.latency.count = 1
        replicas.append(r)
    return replicas


@pytest.mark.parametrize("states", [
    [(0, 0.0), (0, 0.0), (0, 0.0)],       # cold, equal: round-robin
    [(3, 0.01), (0, 0.05), (1, 0.02)],
    [(0, 0.12), (2, 0.003)],              # a slow replica sheds traffic
    [(5, 0.001), (5, 0.001), (4, 0.002), (0, 0.0)],
])
def test_router_picks_like_the_jax_router(states):
    from tpu_pipelines.serving.fleet import LatencyAwareRouter as JaxRouter
    from tpu_pipelines_torch.serving.fleet import LatencyAwareRouter

    picks = {}
    for package, router_cls in (("jax", JaxRouter),
                                ("torch", LatencyAwareRouter)):
        replicas = _replicas(package, states)
        try:
            router = router_cls()
            seq = [router.pick(replicas).name for _ in range(len(states) + 2)]
            best, costs = router.pick_with_costs(replicas)
            picks[package] = (seq, best.name, costs)
        finally:
            for r in replicas:
                r.batcher.close()
    assert picks["torch"] == picks["jax"]


def test_router_redirects_around_slow_replica():
    from tpu_pipelines_torch.serving.fleet import Replica, ReplicaPool

    reg = MetricsRegistry()
    SLOW, FAST = 0.12, 0.003

    def fn(delay):
        def predict(batch):
            time.sleep(delay)
            return np.asarray(batch["x"])
        return predict

    slow = Replica(0, fn(SLOW), max_batch_size=4, batch_timeout_s=0.001,
                   registry=reg, device="cpu")
    fast = Replica(1, fn(FAST), max_batch_size=4, batch_timeout_s=0.001,
                   registry=reg, device="cpu")
    pool = ReplicaPool([slow, fast])
    try:
        with ThreadPoolExecutor(max_workers=4) as tp:
            list(tp.map(lambda i: pool.submit(
                {"x": np.full((1, 2), float(i))}, 1), range(40)))
    finally:
        pool.close()
    assert slow.latency.count + fast.latency.count == 40
    assert fast.latency.count >= 3 * slow.latency.count
    p99 = reg.get("serving_replica_p99_seconds")
    assert p99.labels("0").get() >= SLOW * 0.8 > p99.labels("1").get()


def test_replica_pool_close_drains_in_parallel():
    from tpu_pipelines_torch.serving.fleet import Replica, ReplicaPool

    release = threading.Event()

    def wedged(batch):
        release.wait(10)
        return np.asarray(batch["x"])

    replicas = [Replica(i, wedged, max_batch_size=2, batch_timeout_s=0.001,
                        device="cpu")
                for i in range(3)]
    pool = ReplicaPool(replicas)
    with ThreadPoolExecutor(max_workers=3) as tp:
        futs = [tp.submit(r.submit, {"x": np.ones((1, 2))}, 1, 30.0)
                for r in replicas]
        time.sleep(0.2)
        t0 = time.monotonic()
        pool.close(timeout_s=1.0)
        assert time.monotonic() - t0 < 2.0   # one timeout, not three
        for f in futs:
            with pytest.raises(RuntimeError, match="closed"):
                f.result(timeout=10)
        release.set()
    for r in replicas:
        r.batcher.join_close(5)
    assert pool.closed


# ------------------------------------------------------ version manager

def _residency_trace(manager_cls, tmp_path, loader):
    """One op sequence (loads, a rollback, an eviction, a lease held across
    a swap); returns what the manager showed after each op."""
    mgr = manager_cls("m", max_versions=2, loader=loader)
    dirs = [_fake_payload(tmp_path, v, float(v)) for v in (1, 2, 3, 4, 5)]
    trace = []

    def note(op):
        trace.append((op, mgr.active_version, mgr.resident_versions(),
                      mgr.active_loaded().scale))

    mgr.load_version(dirs[0])
    note("load 1")
    mgr.load_version(dirs[1])
    note("load 2")
    mgr.activate("1")
    note("rollback to 1")
    mgr.activate("2")
    mgr.load_version(dirs[2])
    note("load 3 evicts 1")
    with pytest.raises(KeyError):
        mgr.activate("1")
    with mgr.lease() as (version, loaded):
        mgr.load_version(dirs[3])
        mgr.load_version(dirs[4])
        note("load 4 and 5 while 3 is leased")
        trace.append(("leased", version, loaded.scale, mgr.lease_count("3"),
                      "3" in mgr._versions))
    trace.append(("drained", "3" in mgr._versions, mgr.lease_count("3")))
    return trace


def test_version_swap_rollback_and_drain_match_the_jax_manager(tmp_path):
    from tpu_pipelines.serving.fleet import ModelVersionManager as JaxManager
    from tpu_pipelines_torch.serving.fleet import ModelVersionManager

    want = _residency_trace(JaxManager, tmp_path / "jax", _fake_loader)
    got = _residency_trace(ModelVersionManager, tmp_path / "torch",
                           _fake_loader)
    assert got == want
    assert want[-2] == ("leased", "3", 3.0, 1, True)
    assert want[-1] == ("drained", False, 0)


def test_canary_gate_refuses_a_bad_version(tmp_path):
    from tpu_pipelines_torch.components.infra_validator import canary_check
    from tpu_pipelines_torch.serving.fleet import (
        CanaryRefused,
        ModelVersionManager,
    )

    reg = MetricsRegistry()
    mgr = ModelVersionManager(
        "m", loader=_fake_loader, registry=reg,
        canary_fn=lambda loaded, v: canary_check(
            loaded.predict, {"x": np.asarray([1.0, 2.0])}))
    mgr.load_version(_fake_payload(tmp_path, 1, 1.0))
    with pytest.raises(CanaryRefused, match="non-finite"):
        mgr.load_version(_fake_payload(tmp_path, 2, float("nan")))
    assert mgr.active_version == "1" and mgr.resident_versions() == ["1"]
    assert reg.get("serving_canary_failures_total").get() == 1


# ------------------------------------------------ ModelServer fleet mode

def test_fleet_server_hot_swap_under_load_zero_5xx(tmp_path, fake_loader):
    base = tmp_path / "m"
    _fake_payload(base, 1, 1.0)
    server = ModelServer("toy", str(base), replicas=2, max_versions=2,
                         slo_p99_ms=25.0, max_batch_size=8,
                         batch_timeout_s=0.002, device="cpu")
    assert server._fleet is not None
    port = server.start()
    url = f"http://127.0.0.1:{port}/v1/models/toy:predict"
    body = json.dumps({"inputs": {"x": [[1.0, 2.0]]}}).encode()
    errors = []

    def fire(n):
        for _ in range(n):
            try:
                status, _ = _post(url, body)
                if status != 200:
                    errors.append(status)
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))

    try:
        fire(2)  # also captures the fleet's canary batch
        threads = [threading.Thread(target=fire, args=(25,))
                   for _ in range(3)]
        for t in threads:
            t.start()
        _fake_payload(base, 2, 2.0)
        status, reply = _post(f"http://127.0.0.1:{port}/v1/models/toy:reload")
        assert (status, reply["version"]) == (200, "2")
        for t in threads:
            t.join()
        assert errors == []
        _, out = _post(url, body)
        assert out["predictions"] == [[2.0, 4.0]]
        scrape = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
        health = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=10).read())
    finally:
        server.stop()
    assert not re.search(r'serving_requests_total\{[^}]*code="5', scrape)
    assert 'serving_model_info{model="toy",version="2"} 1' in scrape
    assert 'serving_model_info{model="toy",version="1"} 0' in scrape
    assert "serving_version_swaps_total 2" in scrape
    per_replica = {
        m.group(1): float(m.group(2)) for m in re.finditer(
            r'serving_replica_requests_total\{replica="(\d+)"\} (\S+)', scrape)
    }
    assert set(per_replica) == {"0", "1"}
    assert sum(per_replica.values()) == 78   # warm-up + hammer + post-swap
    assert 'serving_replica_batch_deadline_seconds{replica="0"}' in scrape
    # The stub has no device step: the swap's warm-up ran the legacy way.
    assert "serving_aot_compiles_total 0" in scrape
    assert health["healthy"] is True
    assert health["fleet"]["replicas"] == 2
    assert health["fleet"]["active_version"] == "2"


class CudaStub(FakeLoaded):
    """A stand-in payload that says it lives on the card (nothing runs
    there): the fleet captures its buckets through ``aot.warm_loaded``,
    replaced below by a recorder."""

    device = torch.device("cuda")

    def __init__(self, scale):
        super().__init__(scale)
        self.aot = AotDispatch()
        self.calls = []

    def predict(self, batch):
        self.calls.append("predict")
        return super().predict(batch)

    predict_transformed = predict


def test_fleet_captures_the_boot_version_before_it_serves(tmp_path,
                                                          monkeypatch):
    """The version the fleet boots with goes active with no canary batch:
    its first batch is its warm-up, captured before that batch is served;
    a capture that fails fails the request and is tried again, never an
    eager predict; a pushed version is captured at its gate instead."""
    from tpu_pipelines_torch.serving import aot
    from tpu_pipelines_torch.serving.fleet import ServingFleet

    failing = [True]

    def warm_loaded(loaded, batch, max_batch_size, *, raw=True):
        loaded.calls.append(("warm", {k: np.asarray(v)[:1].tolist()
                                      for k, v in batch.items()}))
        if failing[0]:
            raise RuntimeError("capture failed")
        loaded.aot.install("raw", AotDispatch.signature(batch), object())
        return {"buckets": [1, 2], "compiled": 2, "cache_hits": 0,
                "fallback_warm": False, "cached_to_disk": 0, "seconds": 0.0}

    monkeypatch.setattr(aot, "warm_loaded", warm_loaded)
    base = tmp_path / "m"
    _fake_payload(base, 1, 1.0)
    fleet = ServingFleet(
        "m", str(base), replicas=2, max_versions=2, max_batch_size=4,
        batch_timeout_s=0.002, device="cpu",
        loader=lambda vdir: CudaStub(_fake_loader(vdir).scale))
    try:
        fleet.reload()
        boot = fleet.active_loaded()
        assert boot.calls == [] and fleet.last_warm is None
        with pytest.raises(RuntimeError, match="capture failed"):
            fleet.submit({"x": np.asarray([[5.0, 6.0]])}, 1)
        # The batcher reruns a failed batch's requests alone: each run
        # tries the capture again, none predicts.
        assert boot.calls and set(map(repr, boot.calls)) == {
            repr(("warm", {"x": [[5.0, 6.0]]}))}
        failed = len(boot.calls)
        failing[0] = False
        with ThreadPoolExecutor(max_workers=4) as tp:
            outs = list(tp.map(lambda i: fleet.submit(
                {"x": np.full((1, 2), float(i))}, 1), range(8)))
        assert [o.tolist() for o in outs] == [[[float(i)] * 2]
                                              for i in range(8)]
        # One more capture, before any predict; then only predicts.
        assert boot.calls[failed][0] == "warm"
        assert set(boot.calls[failed + 1:]) == {"predict"}
        assert fleet.last_warm["compiled"] == 2

        _fake_payload(base, 2, 2.0)
        assert fleet.reload() == "2"
        pushed = fleet.active_loaded()
        # The gate: the canary's predict, then the capture from its batch.
        assert [c if c == "predict" else c[0] for c in pushed.calls] == [
            "predict", "warm"]
        np.testing.assert_array_equal(
            fleet.submit({"x": np.asarray([[1.0, 1.0]])}, 1), [[2.0, 2.0]])
        assert pushed.calls[2:] == ["predict"]
    finally:
        fleet.close()


def test_fleet_canary_refuses_bad_push_with_409(tmp_path, fake_loader):
    base = tmp_path / "m"
    _fake_payload(base, 1, 1.0)
    server = ModelServer("toy", str(base), replicas=2, max_versions=2,
                         device="cpu")
    port = server.start()
    url = f"http://127.0.0.1:{port}/v1/models/toy:predict"
    body = json.dumps({"inputs": {"x": [[3.0, 4.0]]}}).encode()
    try:
        _post(url, body)  # captures the canary batch
        _fake_payload(base, 2, float("nan"))
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(f"http://127.0.0.1:{port}/v1/models/toy:reload")
        assert err.value.code == 409
        assert "canary" in json.load(err.value)["error"]
        assert server.version == "1"
        assert _post(url, body) == (200, {"predictions": [[3.0, 4.0]]})
        scrape = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
        assert "serving_canary_failures_total 1" in scrape
    finally:
        server.stop()


def test_fleet_env_knobs(tmp_path, fake_loader, monkeypatch):
    base = tmp_path / "m"
    _fake_payload(base, 1, 1.0)
    monkeypatch.setenv("TPP_SERVING_REPLICAS", "3")
    monkeypatch.setenv("TPP_SERVING_MAX_VERSIONS", "2")
    monkeypatch.setenv("TPP_SERVING_SLO_P99_MS", "25")
    monkeypatch.setenv("TPP_SERVING_MAX_QUEUE", "7")
    server = ModelServer("toy", str(base), device="cpu")
    try:
        health = server.health()
        assert health["fleet"]["replicas"] == 3
        assert health["fleet"]["slo_p99_ms"] == 25.0
        assert server.max_versions == 2 and server.max_queue_depth == 7
        assert "replica_states" not in health["fleet"]  # supervisor off
    finally:
        server.stop()
    # Constructor wins over env.
    server2 = ModelServer("toy", str(base), replicas=1, max_versions=1,
                          slo_p99_ms=0.0, device="cpu")
    try:
        assert server2._fleet is None
    finally:
        server2.stop()
    # The knobs that once raised naming A8b are read from the environment
    # like the rest (TPP_REQUEST_TRACE=1 means "all").
    for env, read in (
            ("TPP_SERVING_PREFIX_CACHE", lambda s: s.prefix_cache_entries),
            ("TPP_REQUEST_TRACE", lambda s: s.request_tracer.mode == "all"),
            ("TPP_SERVING_SPEC_TOKENS", lambda s: s.spec_tokens)):
        monkeypatch.setenv(env, "1")
        server3 = ModelServer("toy", str(base), device="cpu")
        try:
            assert read(server3) == 1, env
        finally:
            server3.stop()
        monkeypatch.delenv(env)
    monkeypatch.setenv("TPP_METRICS_HISTORY", "1")
    server4 = ModelServer("toy", str(base), replicas=2, device="cpu")
    server4.stop()


# ------------------------------------------------------------ supervisor

def test_supervisor_ejects_and_rebuilds_a_killed_replica(tmp_path,
                                                         fake_loader):
    """KILL_REPLICA on replica 0 with the supervisor on: requests fail
    over to replica 1 (every reply 200), the supervisor ejects replica 0,
    rebuilds it (a new generation the kill no longer reaches) and
    re-admits it."""
    base = tmp_path / "m"
    _fake_payload(base, 1, 1.0)
    server = ModelServer("toy", str(base), replicas=2, max_versions=2,
                         batch_timeout_s=0.001, supervisor_interval_s=3600.0,
                         device="cpu")
    fleet = server._fleet
    sup = fleet.supervisor
    port = server.start()
    url = f"http://127.0.0.1:{port}/v1/models/toy:predict"
    body = json.dumps({"inputs": {"x": [[1.0]]}}).encode()
    plan = faults.FaultPlan({faults.REPLICA_KEY: faults.NodeFault(
        faults.KILL_REPLICA, replica="0")})
    try:
        with plan.activate():
            codes = [_post(url, body)[0] for _ in range(6)]
            assert codes == [200] * 6
            first = sup.probe_once()
            assert first["0"][0] == "degraded" and first["1"][0] == "healthy"
            assert sup.probe_once()["0"][0] == "ejected"
            assert sup.allow(fleet.pool.replicas[0]) is False
            assert [_post(url, body)[0] for _ in range(4)] == [200] * 4
            assert sup.probe_once()["0"] == ("healthy", "ok")
            assert fleet.pool.replicas[0].generation == 1
            health = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=10).read())
        scrape = server.metrics.to_prometheus()
    finally:
        server.stop()
    assert ("__replica__", "kill_replica:0") in plan.log
    assert health["fleet"]["replica_states"] == {"0": "healthy",
                                                 "1": "healthy"}
    assert 'serving_replica_state{replica="0"} 0' in scrape
    assert float(re.search(r"^serving_failovers_total (\S+)$", scrape,
                           re.M)[1]) >= 1


def test_a_device_error_fails_over_and_a_wedged_replica_is_rebuilt(
        tmp_path, fake_loader):
    """DEVICE_ERROR on a request's replica (its isolation retry too): the
    pool retries it once on the peer.  WEDGE_PREDICT parks a device call:
    the supervisor's queue-age probe ejects the replica, the rebuild fails
    the wedged request, which then fails over, and the old worker exits
    once the call returns."""
    base = tmp_path / "m"
    _fake_payload(base, 1, 2.0)
    server = ModelServer("toy", str(base), replicas=2, max_versions=2,
                         batch_timeout_s=0.001, supervisor_interval_s=3600.0,
                         supervisor_queue_age_s=0.2, device="cpu")
    fleet = server._fleet
    sup = fleet.supervisor
    batch = {"x": np.ones((1, 1))}
    try:
        plan = faults.FaultPlan({faults.REPLICA_KEY: faults.NodeFault(
            faults.DEVICE_ERROR, times=2)})
        with plan.activate():
            assert server.predict_batch(batch).tolist() == [[2.0]]
        assert [e for _, e in plan.log if e.startswith("device_error")]
        assert server.metrics.get("serving_failovers_total").get() == 1

        wedge = faults.NodeFault(faults.WEDGE_PREDICT, max_hang_s=30)
        plan = faults.FaultPlan({faults.REPLICA_KEY: wedge})
        with plan.activate(), ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(server.predict_batch, batch)
            deadline = time.monotonic() + 10
            while (not any(r.batcher.oldest_work_age_s() > 0.3
                           for r in fleet.pool.replicas)
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            wedged = next(r for r in fleet.pool.replicas
                          if r.batcher.oldest_work_age_s() > 0.3)
            assert sup.probe_once()[wedged.name][0] == "degraded"
            assert sup.probe_once()[wedged.name][0] == "ejected"
            assert sup.probe_once()[wedged.name] == ("healthy", "ok")
            assert fut.result(timeout=30).tolist() == [[2.0]]
            wedge.release.set()
        assert wedged.generation == 1
        # The old worker records its release from its own thread once the
        # event wakes it: wait for that record (bounded), then hold it.
        deadline = time.monotonic() + 10
        while (("__replica__", "wedge_released") not in plan.log
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert ("__replica__", "wedge_released") in plan.log
    finally:
        server.stop()


def test_a_reload_during_the_hammer_answers_every_request(tmp_path,
                                                         fake_loader):
    """RELOAD_DURING_HAMMER: the 5th request starts a hot-swap to a version
    already on disk while the requests keep coming; every reply is 200."""
    base = tmp_path / "m"
    _fake_payload(base, 1, 1.0)
    server = ModelServer("toy", str(base), replicas=2, max_versions=2,
                         batch_timeout_s=0.001, device="cpu")
    url = f"http://127.0.0.1:{server.start()}/v1/models/toy:predict"
    body = json.dumps({"inputs": {"x": [[1.0]]}}).encode()
    plan = faults.FaultPlan({faults.SERVING_KEY: faults.NodeFault(
        faults.RELOAD_DURING_HAMMER, after=5)})
    try:
        _post(url, body)
        _fake_payload(base, 2, 3.0)
        with plan.activate(), ThreadPoolExecutor(max_workers=4) as pool:
            codes = [c for c, _ in pool.map(lambda _: _post(url, body),
                                            range(24))]
        deadline = time.monotonic() + 10
        while server.version != "2" and time.monotonic() < deadline:
            time.sleep(0.01)
        assert codes == [200] * 24 and server.version == "2"
        assert _post(url, body) == (200, {"predictions": [[3.0]]})
        assert plan.log == [("__serving__", "reload_during_hammer:predict")]
    finally:
        server.stop()


def test_every_replica_down_answers_503_with_retry_after(tmp_path,
                                                         fake_loader):
    base = tmp_path / "m"
    _fake_payload(base, 1, 1.0)
    server = ModelServer("toy", str(base), replicas=2, max_versions=2,
                         supervisor_interval_s=3600.0, device="cpu")
    sup = server._fleet.supervisor
    port = server.start()
    url = f"http://127.0.0.1:{port}/v1/models/toy:predict"
    try:
        for r in server._fleet.pool.replicas:
            sup.breakers[r.name].trip()
            sup._set_state(r.name, "ejected")
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(url, json.dumps({"inputs": {"x": [[1.0]]}}).encode())
        assert err.value.code == 503
        assert err.value.headers["Retry-After"] == "1"
        assert "fleet unavailable" in json.load(err.value)["error"]
        scrape = server.metrics.to_prometheus()
    finally:
        server.stop()
    assert "serving_fleet_unavailable_total 1" in scrape


# ------------------------------------------- a real payload on both fleets

def test_tiny_bert_fleet_replies_like_the_jax_fleet(tmp_path, monkeypatch):
    """The same tiny BERT weights behind a 2-replica, 2-version fleet of
    each package; a push of the same weights as version 2 (a hot swap
    through the canary and the bucket warm-up) serves the same replies."""
    import test_torch_serving as ts
    from tpu_pipelines.serving import ModelServer as JaxServer
    from tpu_pipelines.trainer.export import export_model as jax_export_model
    from tpu_pipelines_torch.models.convert import bert_state_dict_from_flax
    from tpu_pipelines_torch.trainer.export import export_model

    monkeypatch.setenv("TPP_AOT_CACHE", str(tmp_path / "aot_cache"))
    params = ts._flax_params(0)
    for v in ("1", "2"):
        jax_export_model(serving_model_dir=str(tmp_path / "jax" / v),
                         params=params, module_file=ts.JAX_MODULE,
                         hyperparameters=ts.HP)
    export_model(serving_model_dir=str(tmp_path / "port" / "1"),
                 params=bert_state_dict_from_flax(params),
                 module_file=ts.PORT_MODULE, hyperparameters=ts.HP)
    batch = ts._batch(n=4, seed=3)
    body = {"inputs": {k: v.tolist() for k, v in batch.items()}}
    replies = {}
    for name, server in (
            ("jax", JaxServer("bert", str(tmp_path / "jax"), replicas=2,
                              max_versions=2, max_batch_size=4)),
            ("port", ModelServer("bert", str(tmp_path / "port"), replicas=2,
                                 max_versions=2, max_batch_size=4,
                                 device="cpu"))):
        try:
            url = f"http://127.0.0.1:{server.start()}/v1/models/bert"
            first = _post(f"{url}:predict", json.dumps(body).encode())[1]
            if name == "port":
                export_model(serving_model_dir=str(tmp_path / "port" / "2"),
                             params=bert_state_dict_from_flax(params),
                             module_file=ts.PORT_MODULE,
                             hyperparameters=ts.HP)
            assert _post(f"{url}:reload")[1]["version"] == "2"
            second = _post(f"{url}:predict", json.dumps(body).encode())[1]
            replies[name] = (np.asarray(first["predictions"]),
                             np.asarray(second["predictions"]))
            if name == "port":
                warm = server._fleet.last_warm
        finally:
            server.stop()
    assert warm["buckets"] == [1, 2, 4] and warm["fallback_warm"] is True
    assert replies["port"][0].shape == (4, ts.HP["num_classes"])
    np.testing.assert_array_equal(replies["port"][1], replies["port"][0])
    for got, want in zip(replies["port"], replies["jax"]):
        np.testing.assert_allclose(got, want, **ts.BF16_TOL)


# --------------------------------------------------------- entry points

def test_the_fleet_defaults_to_cuda_and_raises_without_it(tmp_path,
                                                          fake_loader,
                                                          monkeypatch):
    import torch

    from tpu_pipelines_torch.serving.fleet import ServingFleet

    base = tmp_path / "m"
    _fake_payload(base, 1, 1.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelServer("toy", str(base), replicas=2, max_versions=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingFleet("toy", str(base))


def test_serving_cli_runs_the_fleet_on_cpu(tmp_path):
    """``python -m tpu_pipelines_torch.serving --replicas 2 --max-versions
    2 --slo-p99-ms 50 --device cpu``: replies, and /healthz carries the
    fleet block."""
    import signal
    import subprocess
    import sys

    import test_torch_serving as ts

    base = tmp_path / "served"
    ts._port_payload(base / "1")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_pipelines_torch.serving",
         "--model-name", "bert", "--base-dir", str(base), "--port", "0",
         "--host", "127.0.0.1", "--device", "cpu", "--replicas", "2",
         "--max-versions", "2", "--slo-p99-ms", "50",
         "--poll-seconds", "0.5"],
        cwd=repo, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": repo},
    )
    try:
        port = None
        deadline = time.monotonic() + 60
        while port is None and time.monotonic() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            m = re.search(r"serving 'bert' \(version 1\) on 127\.0\.0\.1:(\d+)",
                          line)
            if m:
                port = int(m[1])
        assert port is not None, "server never reported its port"
        body = json.dumps({"instances": ts._rows(ts._batch(n=2))}).encode()
        code, reply = _post(f"http://127.0.0.1:{port}/v1/models/bert:predict",
                            body)
        assert code == 200 and np.asarray(reply["predictions"]).shape == (2, 3)
        health = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=10).read())
        assert health["fleet"] == {
            "replicas": 2, "versions_resident": ["1"], "active_version": "1",
            "slo_p99_ms": 50.0, "model_type": "predict"}
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            assert proc.wait(timeout=30) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
