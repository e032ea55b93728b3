"""Request tracing through the port's serving surface against the JAX
package's, on the CPU.

The same tiny BERT weights (``tests/test_torch_serving.py``) served by each
package's ``ModelServer`` with ``request_trace_mode="all"`` and a trace
dir, once as a micro-batching single server and once as a two-replica
fleet.  Three requests: REST with a W3C ``traceparent``, gRPC with one in
its metadata, REST without.  Per request the two packages must give the
same span and instant names, the same parent chain (each child's parent is
the request's root span; the root's parent is the caller's span id, or
empty) and the same ``traceparent`` handling (the caller's trace id comes
back in the reply header or the trailing metadata).  The reference's
``summarize_request_traces`` reads the port's trace file and agrees with
the port's own summary, and ``/metrics`` carries an exemplar line for each
traced endpoint.  No numbers are compared: span durations are the
machine's.
"""

import json
import os
import urllib.request

import grpc
import pytest

import test_torch_serving as ts
from tpu_pipelines.observability.export import (
    summarize_request_traces as ref_summarize,
)
from tpu_pipelines.serving import grpc_server as ref_grpc
from tpu_pipelines.serving.server import ModelServer as RefServer
from tpu_pipelines.trainer.export import export_model as jax_export_model
from tpu_pipelines_torch.observability import request_trace as port_rt
from tpu_pipelines_torch.observability.export import (
    read_events,
    summarize_request_traces,
)
from tpu_pipelines_torch.serving import grpc_server as port_grpc
from tpu_pipelines_torch.serving.server import ModelServer

CALLER_TRACE = "4bf92f3577b34da6a3ce929d0e0e4736"
CALLER_SPAN = "00f067aa0ba902b7"
TRACEPARENT = f"00-{CALLER_TRACE}-{CALLER_SPAN}-01"
GRPC_TRACE = "0af7651916cd43dd8448eb211c80319c"
GRPC_TRACEPARENT = f"00-{GRPC_TRACE}-b7ad6b7169203331-01"

SIDES = {
    "ref": (RefServer, ref_grpc, {}),
    "port": (ModelServer, port_grpc, {"device": "cpu"}),
}
MODES = {
    "batching": {"batching": True, "max_batch_size": 4},
    "fleet": {"replicas": 2, "max_versions": 2, "max_batch_size": 4},
}


@pytest.fixture(scope="module")
def payloads(tmp_path_factory):
    base = tmp_path_factory.mktemp("traced")
    jax_export_model(serving_model_dir=str(base / "ref" / "1"),
                     params=ts._flax_params(0), module_file=ts.JAX_MODULE,
                     hyperparameters=ts.HP)
    ts._port_payload(base / "port" / "1", seed=0)
    return {"ref": str(base / "ref"), "port": str(base / "port")}


def _rest(port, batch, traceparent=None):
    headers = {"Content-Type": "application/json"}
    if traceparent:
        headers["traceparent"] = traceparent
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/bert:predict",
        data=json.dumps({"inputs": {k: v.tolist()
                                    for k, v in batch.items()}}).encode(),
        headers=headers)
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.headers.get("traceparent")


def _grpc_predict(module, target, batch):
    channel = grpc.insecure_channel(target)
    try:
        call = channel.unary_unary(
            f"/{module.SERVICE_NAME}/Predict",
            request_serializer=module.pb.PredictRequest.SerializeToString,
            response_deserializer=module.pb.PredictResponse.FromString)
        req = module.pb.PredictRequest(model_name="bert")
        for k, v in batch.items():
            req.inputs[k].CopyFrom(module.array_to_tensor(v))
        _, info = call.with_call(
            req, metadata=(("traceparent", GRPC_TRACEPARENT),), timeout=60)
        return dict(info.trailing_metadata())["traceparent"]
    finally:
        channel.close()


def _serve(side, base, mode, trace_dir):
    server_cls, grpc_mod, kwargs = SIDES[side]
    server = server_cls("bert", base, request_trace_mode="all",
                        trace_dir=trace_dir, **MODES[mode], **kwargs)
    batch = ts._batch(n=3, seed=5)
    try:
        port = server.start()
        replies = [_rest(port, batch, TRACEPARENT)]
        grpc_server, gport = grpc_mod.start_grpc_server(server)
        try:
            replies.append(_grpc_predict(grpc_mod, f"127.0.0.1:{gport}",
                                         batch))
        finally:
            grpc_server.stop(grace=1)
        replies.append(_rest(port, batch))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=60) as r:
            scrape = r.read().decode()
    finally:
        server.stop()
    return replies, scrape


def _structure(events):
    """Per trace, in request order: the root's endpoint, code and parent,
    and the sorted (kind, name, parent is root) of everything else."""
    roots = sorted((e for e in events if e["name"] == "request"),
                   key=lambda e: e["ts"])
    out = []
    for root in roots:
        children = sorted(
            (e["ev"], e["name"], e["parent"] == root["span"])
            for e in events
            if e["trace"] == root["trace"] and e is not root
            and e["name"] != "exemplar")
        out.append({"trace": root["trace"], "parent": root["parent"],
                    "endpoint": root["args"]["endpoint"],
                    "code": root["args"]["code"], "children": children})
    return out


def _strip_times(summary):
    """The summary without the clock's numbers."""
    def clean(obj):
        if isinstance(obj, dict):
            return {k: clean(v) for k, v in obj.items()
                    if k not in ("ts", "start_ts", "latency_s", "dur_s",
                                 "window_s", "costs", "depth")}
        if isinstance(obj, list):
            return [clean(v) for v in obj]
        return obj
    return clean(summary)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_spans_parents_and_traceparents_match_the_reference(payloads,
                                                           tmp_path, mode):
    got = {}
    for side in SIDES:
        trace_dir = str(tmp_path / side)
        replies, scrape = _serve(side, payloads[side], mode, trace_dir)
        events = read_events(os.path.join(trace_dir, "serving",
                                          "events.jsonl"))
        got[side] = (replies, scrape, events)
    structures = {side: _structure(got[side][2]) for side in SIDES}
    anon = {}
    for side, s in structures.items():
        # The third request's trace id is fresh on each side.
        anon[side] = [dict(t, trace=t["trace"] if i < 2 else "fresh")
                      for i, t in enumerate(s)]
    assert anon["port"] == anon["ref"]
    port = structures["port"]
    assert [t["trace"] for t in port[:2]] == [CALLER_TRACE, GRPC_TRACE]
    assert port[0]["parent"] == CALLER_SPAN and port[2]["parent"] == ""
    assert all(child[2] for t in port for child in t["children"])
    names = {child[1] for child in port[0]["children"]}
    assert {"admission", "batch.wait", "model.step"} <= names
    if mode == "fleet":
        assert "route" in names
    replies = got["port"][0]
    assert port_rt.parse_traceparent(replies[0])[0] == CALLER_TRACE
    assert port_rt.parse_traceparent(replies[1])[0] == GRPC_TRACE
    assert port_rt.parse_traceparent(replies[2])[0] == port[2]["trace"]
    for side in SIDES:
        assert ('# exemplar serving_request_latency_seconds'
                '{endpoint="predict"} trace_id=') in got[side][1]
    events = got["port"][2]
    assert (_strip_times(ref_summarize(events))
            == _strip_times(summarize_request_traces(events)))
    summary = summarize_request_traces(events)
    assert summary["trace_count"] == 3
    if mode == "fleet":  # the version lease's note on the model.step span
        assert summary["traces"][CALLER_TRACE]["version"] == "1"


def test_tracing_off_writes_nothing_and_adds_no_family(payloads, tmp_path,
                                                       monkeypatch):
    monkeypatch.delenv("TPP_REQUEST_TRACE", raising=False)
    monkeypatch.setenv("TPP_REQUEST_TRACE_DIR", str(tmp_path / "tr"))
    server = ModelServer("bert", payloads["port"], batching=True,
                         device="cpu")
    try:
        assert server.request_tracer is None
        port = server.start()
        assert _rest(port, ts._batch(n=2, seed=1), TRACEPARENT) is None
        text = server.metrics_text()
    finally:
        server.stop()
    assert "serving_traced_requests_total" not in text
    assert "# exemplar" not in text
    assert not os.path.exists(tmp_path / "tr")


def test_traceparent_parsing_matches_the_reference():
    from tpu_pipelines.observability import request_trace as ref_rt

    for header in (TRACEPARENT, TRACEPARENT.upper(), "garbage", "",
                   None, f"ff-{CALLER_TRACE}-{CALLER_SPAN}-01",
                   f"00-{'0' * 32}-{CALLER_SPAN}-01"):
        assert port_rt.parse_traceparent(header) == \
            ref_rt.parse_traceparent(header)
    for value in ("", "off", "all", "sample:3", "sample", "sample:x", "on"):
        assert port_rt.parse_mode(value) == ref_rt.parse_mode(value)
    assert port_rt.format_traceparent("a" * 32, "b" * 16) == \
        ref_rt.format_traceparent("a" * 32, "b" * 16)
