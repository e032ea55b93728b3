"""Port parity: the data plane without pyarrow (CsvExampleGen, the .npz
shards, BatchIterator), against the reference's Parquet data plane.

Both CsvExampleGen executors run on the same CSV; the reference hashes
each row's Arrow text, the port reproduces that text from its own parse.
Split membership must be identical row for row (same rows, same order in
each split), and the column values equal: exact for ints and strings,
exact or both NaN for doubles.  BatchIterator batches over the two
artifacts, with the same seed, must be equal batch for batch.
"""

import os

import numpy as np
import pytest

from tpu_pipelines.components.example_gen import CsvExampleGen as RefGen
from tpu_pipelines.data import examples_io as ref_io
from tpu_pipelines.data import input_pipeline as ref_ip
from tpu_pipelines.dsl.component import ExecutorContext as RefCtx
from tpu_pipelines.metadata.types import Artifact as RefArtifact
from tpu_pipelines_torch.components.example_gen import CsvExampleGen as PortGen
from tpu_pipelines_torch.components.example_gen import arrow_text
from tpu_pipelines_torch.data import examples_io as port_io
from tpu_pipelines_torch.data import input_pipeline as port_ip
from tpu_pipelines_torch.dsl.component import ExecutorContext as PortCtx
from tpu_pipelines_torch.metadata.types import Artifact as PortArtifact

HERE = os.path.dirname(os.path.abspath(__file__))
TAXI_CSV = os.path.join(HERE, "testdata", "taxi_sample.csv")


def _run_gen(gen_cls, ctx_cls, art_cls, csv, out, **props):
    params = {k: p.default for k, p in gen_cls.SPEC.parameters.items()}
    params.update(input_path=str(csv), **props)
    art = art_cls(type_name="Examples", uri=str(out))
    gen_cls.EXECUTOR(ctx_cls(node_id="gen", inputs={},
                             outputs={"examples": [art]},
                             exec_properties=params))
    return art


def _both(tmp_path, csv, **props):
    ref = _run_gen(RefGen, RefCtx, RefArtifact, csv, tmp_path / "ref", **props)
    port = _run_gen(PortGen, PortCtx, PortArtifact, csv, tmp_path / "port",
                    **props)
    return ref, port


def _assert_columns_equal(got, want):
    assert list(got) == list(want)
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert len(g) == len(w), name
        if w.dtype.kind == "f" or g.dtype.kind == "f":
            np.testing.assert_array_equal(g.astype(np.float64),
                                          w.astype(np.float64), err_msg=name)
        else:
            assert g.tolist() == w.tolist(), name


def _assert_same_splits(ref, port):
    assert port.properties["split_counts"] == ref.properties["split_counts"]
    assert port_io.split_names(port.uri) == ref_io.split_names(ref.uri)
    for split in ref_io.split_names(ref.uri):
        _assert_columns_equal(port_io.read_split(port.uri, split),
                              ref_io.read_split(ref.uri, split))


@pytest.mark.parametrize("num_shards", [1, 3])
def test_taxi_sample_splits_identically(tmp_path, num_shards):
    ref, port = _both(tmp_path, TAXI_CSV, num_shards=num_shards)
    _assert_same_splits(ref, port)
    assert port_io.num_split_shards(port.uri, "train") == num_shards


def _trap_csv(path, rows=400, seed=0):
    """Integral floats, 1e-7, 1e21, tiny and huge doubles, negative zero,
    empty numeric and string fields, null spellings, quoted commas."""
    rng = np.random.default_rng(seed)
    doubles = ["4.0", "1e-7", "1e21", "2.5", "0.1", "-0.0", "1e-5",
               "123456789012.0", "0.30000000000000004", "", "NA", "7"]
    strings = ['"Smith, Jones & Co"', "", "Cash", "NA", "null", "Flash Cab",
               '"a ""quoted"" name"']
    lines = ["trip_miles,fare,hour,company,flag,tips"]
    for i in range(rows):
        hour = "" if i % 17 == 0 else str(int(rng.integers(-3, 24)))
        flag = ("true", "false", "TRUE")[i % 3]
        lines.append(",".join([
            rng.choice(doubles), repr(float(rng.normal() * 10.0 ** rng.integers(-8, 22))),
            hour, rng.choice(strings), flag, f"{rng.uniform(0, 9):.2f}",
        ]))
    path.write_text("\n".join(lines) + "\n")
    return path


def test_seeded_traps_split_identically(tmp_path):
    csv = _trap_csv(tmp_path / "traps.csv")
    ref, port = _both(tmp_path, csv, num_shards=2)
    _assert_same_splits(ref, port)
    port_table = port_io.read_split_table(port.uri, "train")
    assert port_table.columns["hour"].dtype == np.int64
    assert port_table.null_count("hour") > 0


def test_streaming_ingest_keeps_membership(tmp_path):
    ref, port = _both(tmp_path, TAXI_CSV, num_shards=2)
    streamed = _run_gen(PortGen, PortCtx, PortArtifact, TAXI_CSV,
                        tmp_path / "stream", num_shards=2,
                        streaming_threshold_bytes=0)
    for split in ("train", "eval"):
        want = ref_io.read_split(ref.uri, split)
        got = port_io.read_split(streamed.uri, split)
        # Streaming spreads blocks across shards: the same rows, by key.
        key = lambda cols: sorted(zip(*(np.asarray(cols[c]).tolist()
                                        for c in cols)))
        assert key(got) == key(want)


def test_arrow_text_matches_arrow_casts():
    pa = pytest.importorskip("pyarrow")
    rng = np.random.default_rng(5)
    vals = np.concatenate([
        rng.normal(size=3000) * 10.0 ** rng.integers(-12, 25, size=3000),
        np.round(rng.uniform(0, 100, 1000), 2),
        [0.0, -0.0, 1e-7, 1e21, 1e-6, 1e10, 9.999999999e9, 5e-324,
         1.7976931348623157e308, np.inf, -np.inf],
    ])
    want = pa.array(vals).cast(pa.string()).to_pylist()
    assert arrow_text(vals, None, "double").tolist() == want
    ints = rng.integers(-10 ** 12, 10 ** 12, size=100)
    assert arrow_text(ints, None, "int64").tolist() == [str(v) for v in ints]


def test_shard_round_trip_keeps_values_nulls_and_order(tmp_path):
    n = 50
    rng = np.random.default_rng(0)
    ints = rng.integers(0, 9, n)
    int_null = rng.random(n) < 0.2
    strs = np.asarray(rng.choice(["a", "bb", "", "Cash, Card"], n), dtype="U")
    obj = np.asarray(strs.tolist(), dtype=object)
    obj[3] = None
    table = port_io.Table(
        {"i": ints, "f": rng.normal(size=n).astype(np.float32), "s": obj,
         "v": rng.normal(size=(n, 2)).astype(np.float32), "b": ints > 4},
        {"i": int_null},
    )
    port_io.write_split(str(tmp_path), "train", table, num_shards=4)
    assert port_io.shard_row_counts(str(tmp_path), "train") == [13, 13, 12, 12]
    back = port_io.read_split_table(str(tmp_path), "train")
    np.testing.assert_array_equal(back.columns["i"], ints)
    np.testing.assert_array_equal(back.null_mask("i"), int_null)
    np.testing.assert_array_equal(back.columns["v"], table.columns["v"])
    assert back.columns["s"].dtype.kind == "U"
    cols = port_io.read_split(str(tmp_path), "train", columns=["i", "s"])
    assert list(cols) == ["i", "s"]
    assert np.isnan(cols["i"][int_null]).all() and cols["i"].dtype == np.float64
    assert cols["s"][3] is None and cols["s"].dtype == object
    assert cols["s"][:3].tolist() == strs[:3].tolist()
    chunks = list(port_io.iter_table_chunks(str(tmp_path), "train", rows=5))
    assert [c.num_rows for c in chunks] == [5, 5, 3, 5, 5, 3, 5, 5, 2, 5, 5, 2]
    # An empty shard keeps the schema's columns and dtypes.
    writer = port_io.open_split_writer(str(tmp_path), "eval", table,
                                       shard=0, num_shards=1)
    writer.close()
    empty = port_io.read_split(str(tmp_path), "eval")
    assert list(empty) == list(table.columns) and len(empty["i"]) == 0


@pytest.mark.parametrize("shuffle,drop,epochs", [
    (True, True, 2), (False, False, 1), (True, False, 1),
])
def test_batch_iterator_matches_reference(tmp_path, shuffle, drop, epochs):
    ref, port = _both(tmp_path, TAXI_CSV, num_shards=3)
    columns = ["fare", "company", "trip_start_hour"]
    kw = dict(batch_size=16, shuffle=shuffle, seed=7, drop_remainder=drop,
              num_epochs=epochs)
    want = list(ref_ip.BatchIterator(ref.uri, "train",
                                     ref_ip.InputConfig(**kw), columns=columns))
    got_it = port_ip.BatchIterator(port.uri, "train",
                                   port_ip.InputConfig(**kw), columns=columns)
    got = list(got_it)
    assert got_it.steps_per_epoch() * epochs == len(got) == len(want)
    for g, w in zip(got, want):
        _assert_columns_equal(g, w)


def test_batch_iterator_streaming_path_yields_every_row(tmp_path):
    _, port = _both(tmp_path, TAXI_CSV, num_shards=3)
    cfg = port_ip.InputConfig(batch_size=8, shuffle=True, seed=1,
                              drop_remainder=False, num_epochs=1,
                              max_in_memory_rows=10, shuffle_buffer_rows=20)
    it = port_ip.BatchIterator(port.uri, "train", cfg)
    assert it.streaming
    fares = np.concatenate([b["fare"] for b in it])
    want = port_io.read_split(port.uri, "train")["fare"]
    np.testing.assert_array_equal(np.sort(fares), np.sort(want))
