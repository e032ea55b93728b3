"""The port's ``data/record_io.py`` against the reference's
(``tests/test_record_ingest.py``): the masked crc32c, the TFRecord framing
and its errors, the tf.Example wire decoder and the batched columns.

Records are seeded (numpy) and encoded by ``chip_smoke.py``'s writer
(through ``tests/torch_records.py``; packed and unpacked repeated
values); one test frames them with TensorFlow's own writer when it is
installed, and one reads an ArrayRecord file written by ``array_record``
when that is installed.  Every comparison
is exact: the two decoders read the same bytes into the same values (the
reference's Arrow columns read back as Python values, the port's numpy
columns).
"""

import os
import struct

import numpy as np
import pytest

from tpu_pipelines.data import record_io as ref
from tpu_pipelines_torch.data import record_io as port

from torch_records import encode_example, example_rows, frame, write_tfrecord


def _rows(n, seed=0, start=0):
    return example_rows(np.random.default_rng(seed), n, start)


def _ref_table(batches):
    import pyarrow as pa

    return pa.Table.from_batches(list(batches))


def _assert_columns_equal(port_tables, ref_batches):
    """The port's tables hold the reference's RecordBatch values: row
    counts per chunk, column names and order, every value exactly."""
    port_tables = list(port_tables)
    ref_batches = list(ref_batches)
    assert [t.num_rows for t in port_tables] == [b.num_rows for b in ref_batches]
    table = _ref_table(ref_batches)
    assert port_tables[0].column_names == table.column_names
    for name in table.column_names:
        got = np.concatenate([t.columns[name] for t in port_tables]).tolist()
        want = table.column(name).to_pylist()
        assert got == want, name


# ------------------------------------------------------------------ crc32c


def test_masked_crc32c_known_vectors():
    # CRC-32C check value of "123456789" (RFC 3720 B.4).
    assert port._crc32c(b"123456789") == 0xE3069283
    assert port._crc32c(b"") == 0
    for data in (b"", b"a", b"123456789", bytes(range(256)) * 3):
        assert port._masked_crc32c(data) == ref._masked_crc32c(data)


@pytest.mark.parametrize("n", [0, 1, 7, 64, 1000, 4097])
def test_table_crc_equals_google_crc32c(n):
    google_crc32c = pytest.importorskip("google_crc32c")
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    assert port._crc32c(data) == google_crc32c.value(data)


# ----------------------------------------------------------------- framing


def _file(tmp_path, payloads, name="data.tfrecord"):
    path = str(tmp_path / name)
    write_tfrecord(path, payloads, port._masked_crc32c)
    return path


def test_framing_reads_every_record_as_the_reference(tmp_path):
    payloads = [encode_example(r) for r in _rows(20)]
    path = _file(tmp_path, payloads)
    assert list(port.iter_tfrecords(path)) == payloads
    assert list(port.iter_tfrecords(path)) == list(ref.iter_tfrecords(path))


@pytest.mark.parametrize("where,match", [
    (8, "length-crc mismatch"),       # a bit of the length crc
    (20, "payload-crc mismatch"),     # a bit inside the payload
    ("tail", "payload-crc mismatch"),  # a bit of the payload crc
])
def test_corrupt_crc_raises_in_both(tmp_path, where, match):
    raw = bytearray(frame(encode_example(_rows(1)[0]), port._masked_crc32c))
    at = len(raw) - 1 if where == "tail" else where
    raw[at] ^= 0x01
    path = str(tmp_path / "bad.tfrecord")
    with open(path, "wb") as f:
        f.write(bytes(raw))
    for mod in (port, ref):
        with pytest.raises(ValueError, match=match):
            list(mod.iter_tfrecords(path))
    # The trusted-source opt-out reads it (the payload flip parses or not
    # alike in both packages).
    if where == "tail":
        assert list(port.iter_tfrecords(path, verify_crc=False)) == list(
            ref.iter_tfrecords(path, verify_crc=False))


def test_corrupt_length_and_truncation_raise(tmp_path):
    good = frame(encode_example(_rows(1)[0]), port._masked_crc32c)
    huge = struct.pack("<Q", port.MAX_RECORD_BYTES + 1)
    cases = {
        "cap": (huge + good[8:], False, "exceeds"),
        "header": (good + good[:5], True, "truncated TFRecord header"),
        "payload": (good[:-10], True, "truncated TFRecord payload"),
        "footer": (good[:-2], True, "truncated TFRecord footer"),
    }
    for name, (data, verify, match) in cases.items():
        path = str(tmp_path / f"{name}.tfrecord")
        with open(path, "wb") as f:
            f.write(data)
        for mod in (port, ref):
            with pytest.raises(ValueError, match=match):
                list(mod.iter_tfrecords(path, verify_crc=verify))


# ------------------------------------------------------------- the decoder


@pytest.mark.parametrize("packed", [True, False])
def test_parse_tf_example_equals_the_reference(packed):
    for row in _rows(10, seed=3):
        payload = encode_example(row, packed=packed)
        got, want = port.parse_tf_example(payload), ref.parse_tf_example(payload)
        assert list(got) == list(want)
        for name in want:
            g, w = got[name], want[name]
            if isinstance(w, list):
                assert g == w
            else:
                assert g.dtype == w.dtype and g.tolist() == w.tolist()


def test_parse_edge_values_equal_the_reference():
    """Extreme int64s (a ten-byte varint), an empty string, non-ASCII
    UTF-8, float specials, unknown fields ahead of the features."""
    row = {
        "big": np.asarray([-(1 << 63), (1 << 63) - 1, 0, -1]),
        "text": ["".encode(), "naïve ☕".encode()],
        "f": np.asarray([np.inf, -np.inf, -0.0, 1e-45], np.float32),
    }
    payload = b"\x10\x05" + encode_example(row)    # field 2, varint 5 first
    got, want = port.parse_tf_example(payload), ref.parse_tf_example(payload)
    assert got["big"].tolist() == want["big"].tolist()
    assert got["text"] == want["text"]
    np.testing.assert_array_equal(got["f"], want["f"])


# ------------------------------------------------------------ batched rows


@pytest.mark.parametrize("batch_rows", [7, 64, 8192])
def test_batches_hold_the_reference_values(tmp_path, batch_rows):
    payloads = [encode_example(r, packed=bool(i % 2))
                for i, r in enumerate(_rows(50, seed=5))]
    path = _file(tmp_path, payloads)
    got = port.tf_example_batches(port.iter_tfrecords(path), batch_rows)
    want = ref.tf_example_batches(ref.iter_tfrecords(path), batch_rows)
    _assert_columns_equal(got, want)
    table = next(port.tf_example_batches(port.iter_tfrecords(path), 8192))
    assert table.columns["name"].dtype.kind == "U"
    assert table.columns["fare"].dtype == np.float32
    assert table.columns["count"].dtype == np.int64
    assert table.columns["vec"].shape == (50, 3)
    assert table.columns["pair"].shape == (50, 2)


def test_records_written_by_tensorflow(tmp_path):
    tf = pytest.importorskip("tensorflow")
    path = str(tmp_path / "tf.tfrecord")
    with tf.io.TFRecordWriter(path) as w:
        for r in _rows(30, seed=9):
            w.write(encode_example(r))
    got = port.tf_example_batches(port.iter_tfrecords(path), 16)
    want = ref.tf_example_batches(ref.iter_tfrecords(path), 16)
    _assert_columns_equal(got, want)


def test_array_record_reader(tmp_path):
    pytest.importorskip("array_record")
    from array_record.python.array_record_module import ArrayRecordWriter

    path = str(tmp_path / "data.array_record")
    payloads = [encode_example(r) for r in _rows(12, seed=2)]
    w = ArrayRecordWriter(path, "group_size:4")
    for p in payloads:
        w.write(p)
    w.close()
    assert list(port.iter_array_records(path)) == payloads
    assert list(port.iter_array_records(path)) == list(ref.iter_array_records(path))


@pytest.mark.parametrize("rows,batch_rows,match", [
    # In one chunk, differing counts are ragged; across chunks the second
    # row meets the first chunk's pins.
    ([{"x": np.zeros(2, np.float32)}, {"x": np.zeros(3, np.float32)}], 2,
     "ragged"),
    ([{"x": np.zeros(2, np.float32)}, {"x": np.zeros(2, np.int64)}], 1,
     "pinned by the first chunk"),
    ([{"x": np.zeros(2, np.float32)}, {"x": np.zeros(1, np.float32)}], 1,
     "pinned by the first chunk"),
    ([{"x": np.zeros(1, np.float32)}, {"y": np.zeros(1, np.float32)}], 2,
     "inconsistent feature sets"),
])
def test_shape_and_kind_contract_raises_in_both(tmp_path, rows, batch_rows,
                                                match):
    path = _file(tmp_path, [encode_example(r) for r in rows])
    for mod in (port, ref):
        with pytest.raises(ValueError, match=match):
            list(mod.tf_example_batches(mod.iter_tfrecords(path), batch_rows))


def test_non_utf8_bytes_raise_naming_the_format(tmp_path):
    path = _file(tmp_path, [encode_example({"b": [b"\xff\xfe"]})])
    with pytest.raises(ValueError, match="non-UTF-8"):
        list(port.tf_example_batches(port.iter_tfrecords(path)))


def test_array_record_names_the_package_when_missing(tmp_path, monkeypatch):
    import builtins

    real = builtins.__import__

    def no_array_record(name, *args, **kwargs):
        if name.startswith("array_record"):
            raise ImportError(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_array_record)
    with pytest.raises(ImportError, match="array_record"):
        list(port.iter_array_records(os.fspath(tmp_path / "x.array_record")))
