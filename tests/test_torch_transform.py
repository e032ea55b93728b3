"""Port parity: the TransformGraph's torch evaluator and analyzers, on the
CPU, against the reference's numpy (``apply_host``) and jax
(``apply_device``) evaluations of the same DAG.

A preprocessing_fn that uses every op the device side runs (the
arithmetic, the transcendental and comparison ops, clip, cast,
fill_missing, where, one_hot, identity and the z-score, 0-1 and bucketize
analyzers, one of them nested) next to the host-only string ops (vocab,
hash, string equality), over columns made from a seed with NaNs, ids out
of one-hot range and OOV strings.

Tolerances:
  - port torch evaluator vs ``apply_host`` (both packages' numpy): equal
    bit for bit, dtypes included, except log1p, log and sqrt, which the
    two libraries compute to within TRANSCENDENTAL_ULPS f32 ulps (torch's
    vectorized CPU sqrt is not always the correctly rounded one);
  - port vs the reference's jax device path: ints equal; floats within
    JAX_TOL (XLA rewrites x / c as x * (1 / c) and fuses, a few f32 ulps
    on values of order one);
  - analyzer states: the port's float64 torch reductions vs the
    reference's numpy float64 within 1e-12 relative (sum order only).
"""

import numpy as np
import pytest
import torch

from tpu_pipelines.data.schema import Feature as RefFeature
from tpu_pipelines.data.schema import FeatureType as RefType
from tpu_pipelines.data.schema import Schema as RefSchema
from tpu_pipelines.transform.graph import TransformGraph as RefGraph
from tpu_pipelines_torch.data.schema import Feature, FeatureType, Schema
from tpu_pipelines_torch.transform import graph as port_graph
from tpu_pipelines_torch.transform.expr import OPS
from tpu_pipelines_torch.transform.graph import TransformGraph

TRANSCENDENTAL_ULPS = 2
JAX_TOL = dict(rtol=1e-6, atol=1e-6)
STATE_RTOL = 1e-12
HOST_ONLY = {"vocab_apply", "tokenize", "hash_strings"}
TYPES = {"x": "FLOAT", "y": "FLOAT", "n": "INT", "s": "BYTES"}


def preprocessing_fn(inputs, tft):
    x, y, n, s = inputs["x"], inputs["y"], inputs["n"], inputs["s"]
    return {
        "add": x + y, "sub": x - 2.5, "mul": x * y, "div": x / y,
        "div_c": x / 3.0, "log1p": tft.log1p(tft.abs(x)),
        "log": tft.log(tft.abs(y) + 1.0), "sqrt": tft.sqrt(tft.abs(x)),
        "clip": tft.clip(x, -1.0, 1.5), "cast_i": tft.cast(n, "int32"),
        "cast_f": tft.cast(n, "float32"), "fill": tft.fill_missing(y, 3.0),
        "where": tft.where(tft.greater(x, 0.0), x, y),
        "where_c": tft.where(tft.less(x, 0.5), 1.0, y),
        "eq": tft.equal(n, 3), "gt": tft.greater(x, y),
        "onehot": tft.one_hot(n, depth=4),
        "onehot_vocab": tft.one_hot(
            tft.compute_and_apply_vocabulary(s, num_oov_buckets=1), depth=3),
        "z": tft.scale_to_z_score(x),
        "z_of_bucket": tft.scale_to_z_score(tft.bucketize(y, 5)),
        "s01": tft.scale_to_0_1(y), "bucket": tft.bucketize(x, 4),
        "ident": x.graph.add_op("identity", [y]),
        "hash": tft.hash_strings(s, 7), "str_eq": tft.equal(s, "b"),
        "vocab": tft.compute_and_apply_vocabulary(s, num_oov_buckets=2),
    }


def _data(seed, rows=300):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=rows) * 3.0
    y = rng.uniform(-5.0, 50.0, size=rows)
    x[rng.random(rows) < 0.05] = np.nan
    y[rng.random(rows) < 0.05] = np.nan
    return {
        "x": x, "y": y, "n": rng.integers(-1, 6, size=rows),
        "s": np.asarray(rng.choice(["a", "b", "c", "zz", ""], rows), object),
    }


def _graphs(seed=0):
    data = _data(seed)
    ref = RefGraph.build(preprocessing_fn, RefSchema(
        {k: RefFeature(k, RefType(v)) for k, v in TYPES.items()}))
    ref.analyze_chunks(lambda: iter([data]), on_chip=False)
    port = TransformGraph.build(preprocessing_fn, Schema(
        {k: Feature(k, FeatureType(v)) for k, v in TYPES.items()}))
    chunks = [{k: v[i:i + 64] for k, v in data.items()}
              for i in range(0, len(data["x"]), 64)]
    port.analyze_chunks(lambda: iter(chunks), device="cpu")
    return ref, port, _data(seed + 1)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ok = ~np.isnan(a)
    assert np.array_equal(ok, ~np.isnan(b))
    return float(np.max(np.abs(a[ok].astype(np.float64) - b[ok])
                        / np.spacing(np.abs(a[ok])), initial=0.0))


def test_the_device_side_runs_every_numeric_op():
    _, port, _ = _graphs()
    host_fn, device_fn, iface = port.split_host_device()
    iface_ids = {int(k[1:]) for k in iface}
    device_ops = {n.op for n in port.nodes
                  if n.op != "input" and n.id not in iface_ids
                  and not any(port.nodes[int(a["ref"])].dtype == "STRING"
                              for a in n.inputs if isinstance(a, dict))}
    assert device_ops == set(OPS) - HOST_ONLY


def test_torch_evaluator_matches_apply_host_and_the_reference():
    ref, port, batch = _graphs()
    want_host = ref.apply_host(batch)
    want_jax = {k: np.asarray(v) for k, v in ref.apply_device(batch).items()}
    assert ref.device_apply_active is True
    port_host = port.apply_host(batch)
    got = port.apply_device(batch, "cpu")
    assert port.device_apply_active is True
    assert sorted(got) == sorted(want_host)
    for name, want in want_host.items():
        want = np.asarray(want)
        assert got[name].dtype == want.dtype, name
        np.testing.assert_array_equal(port_host[name], want, err_msg=name)
        if name in ("log1p", "log", "sqrt"):
            assert _ulps(got[name], want) <= TRANSCENDENTAL_ULPS, name
        else:
            np.testing.assert_array_equal(got[name], want, err_msg=name)
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got[name], want_jax[name],
                                       err_msg=name, **JAX_TOL)
        else:
            np.testing.assert_array_equal(got[name], want_jax[name],
                                          err_msg=name)


def test_one_hot_and_bucketize_edge_semantics():
    ids = torch.tensor([-1.0, 0.0, 1.7, 3.0, 4.0, 9.0])
    node = port_graph.Node(0, "one_hot", [], {"depth": 4}, "NUMERIC")
    out = port_graph._torch_stateless(node, [ids]).numpy()
    np.testing.assert_array_equal(out.sum(1), [0, 1, 1, 1, 0, 0])
    np.testing.assert_array_equal(out.argmax(1)[1:4], [0, 1, 3])
    bnode = port_graph.Node(1, "bucketize", [], {"num_buckets": 3}, "NUMERIC")
    state = {"boundaries": np.asarray([1.0, 2.0])}
    x = torch.tensor([0.5, 1.0, 1.5, 2.0, 7.0, float("nan")])
    got = port_graph._torch_analyzer(bnode, state, x)
    assert got.dtype == torch.int32
    want = np.searchsorted(np.float32([1.0, 2.0]), x.numpy())
    np.testing.assert_array_equal(got.numpy(), want)


def test_interface_names_equal_the_reference():
    ref, port, _ = _graphs()
    assert port.split_host_device()[2] == ref.split_host_device()[2]


def test_analyzer_states_equal_float64(tmp_path):
    ref, port, _ = _graphs()
    assert sorted(port.state) == sorted(ref.state)
    for nid, st in ref.state.items():
        for key, want in st.items():
            if key.startswith("_"):
                continue
            got = port.state[nid][key]
            if key == "vocab":
                assert list(got) == list(want)
                continue
            a, b = np.asarray(got, np.float64), np.asarray(want, np.float64)
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=STATE_RTOL, atol=0.0)


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_a_graph_saved_by_either_package_loads_in_the_other(tmp_path,
                                                            direction):
    ref, port, batch = _graphs()
    if direction == "port_to_ref":
        port.save(str(tmp_path))
        loaded = RefGraph.load(str(tmp_path))
        want = ref.apply_host(batch)
    else:
        ref.save(str(tmp_path))
        loaded = TransformGraph.load(str(tmp_path))
        want = port.apply_host(batch)
    got = loaded.apply_host(batch)
    for name in want:
        np.testing.assert_allclose(np.asarray(got[name], np.float64),
                                   np.asarray(want[name], np.float64),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    if direction == "ref_to_port":
        dev = loaded.apply_device(batch, "cpu")
        np.testing.assert_array_equal(dev["bucket"], want["bucket"])


def test_apply_device_without_cuda_raises(monkeypatch):
    _, port, batch = _graphs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.apply_device(batch)


def test_a_string_interface_materializes_host_side_and_says_so():
    def passthrough_fn(inputs, tft):
        s = inputs["s"]
        return {"raw_s": s.graph.add_op("identity", [s]),
                "x2": inputs["x"] * 2.0}

    schema = Schema({k: Feature(k, FeatureType(v)) for k, v in TYPES.items()})
    graph = TransformGraph.build(passthrough_fn, schema)
    graph.analyze_chunks(lambda: iter([_data(0)]), device="cpu")
    assert graph.device_apply_active is None
    batch = _data(1)
    got = graph.apply_device(batch, "cpu")
    assert graph.device_apply_active is False
    want = graph.apply_host(batch)
    assert got["raw_s"].tolist() == want["raw_s"].tolist()
    np.testing.assert_array_equal(got["x2"], want["x2"])
