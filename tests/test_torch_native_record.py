"""The port's record core (``data/native_record.py`` over
``csrc/host/record_core.cc``) against the reference's
(``tpu_pipelines/data/native_record.py`` over ``native/record_core.cc``) and
against both packages' Python decoders: the chunk parser, its refusals, and
the crc32c that frames every TFRecord.

Records are seeded (numpy, and hypothesis where it draws them) and encoded
by ``chip_smoke.py``'s writer through ``tests/torch_records.py``, packed and
unpacked.  Every comparison is exact.
"""

import struct

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tpu_pipelines.data import native_record as ref_native
from tpu_pipelines.data import record_io as ref_io
from tpu_pipelines_torch.data import native_record, record_io

from torch_records import encode_example, example_rows, write_tfrecord

SCHEMA = [("name", native_record.KIND_BYTES, 1),
          ("fare", native_record.KIND_FLOAT, 1),
          ("count", native_record.KIND_INT64, 1),
          ("vec", native_record.KIND_FLOAT, 3),
          ("pair", native_record.KIND_INT64, 2)]


@pytest.fixture(scope="module")
def reference_core():
    if ref_native._load_library() is None:
        pytest.skip("the reference's record core cannot build (no make/g++)")


def _records(n, seed=0, packed=True):
    rows = example_rows(np.random.default_rng(seed), n)
    return [encode_example(r, packed=packed) for r in rows], rows


def _same_parse(got, want):
    assert got.keys() == want.keys()
    for name in want:
        if isinstance(want[name], tuple):
            for g, w in zip(got[name], want[name]):
                np.testing.assert_array_equal(g, w)
        else:
            assert got[name].dtype == want[name].dtype
            np.testing.assert_array_equal(got[name], want[name])


@pytest.mark.parametrize("packed", [True, False])
def test_parse_chunk_equals_the_reference_core_and_the_rows(reference_core, packed):
    recs, rows = _records(257, seed=3, packed=packed)
    got = native_record.parse_chunk(recs, SCHEMA)
    want = ref_native.parse_chunk(recs, SCHEMA)
    assert got is not None and want is not None
    _same_parse(got, want)
    np.testing.assert_array_equal(got["count"][:, 0],
                                  [r["count"][0] for r in rows])
    assert (got["count"] < 0).any()
    np.testing.assert_array_equal(got["vec"], np.stack([r["vec"] for r in rows]))
    bdata, offsets = got["name"]
    assert [bytes(bdata[offsets[j]:offsets[j + 1]]) for j in range(257)] == [
        r["name"][0] for r in rows]


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(
    n=st.integers(1, 12),
    width=st.integers(1, 5),
    packed=st.booleans(),
    ints=st.lists(st.integers(-2**63, 2**63 - 1), min_size=60, max_size=60),
    texts=st.lists(st.binary(max_size=9), min_size=12, max_size=12),
)
def test_drawn_chunks_parse_as_the_reference_core(n, width, packed, ints, texts):
    if ref_native._load_library() is None:
        pytest.skip("the reference's record core cannot build")
    rng = np.random.default_rng(n * 7 + width)
    recs = [encode_example({
        "t": [texts[i]],
        "f": rng.normal(size=width).astype(np.float32),
        "i": np.asarray(ints[i * width:(i + 1) * width] or [0], np.int64),
    }, packed=packed) for i in range(n)]
    counts = {len(ints[i * width:(i + 1) * width] or [0]) for i in range(n)}
    if len(counts) != 1:
        return
    schema = [("t", 0, 1), ("f", 1, width), ("i", 2, counts.pop())]
    got = native_record.parse_chunk(recs, schema)
    want = ref_native.parse_chunk(recs, schema)
    assert (got is None) == (want is None)
    if got is not None:
        _same_parse(got, want)


@pytest.mark.parametrize("bad", ["extra", "missing", "count", "garbage"])
def test_deviating_chunks_are_refused_by_both_cores(reference_core, bad):
    recs, rows = _records(6, seed=5)
    schema = list(SCHEMA)
    if bad == "extra":
        recs[3] = encode_example({**rows[3], "surprise": np.asarray([1])})
    elif bad == "missing":
        recs[3] = encode_example({k: v for k, v in rows[3].items() if k != "fare"})
    elif bad == "count":
        schema[3] = ("vec", native_record.KIND_FLOAT, 4)
    else:
        recs[3] = b"\xff\x88garbage"
    assert native_record.parse_chunk(recs, schema) is None
    assert ref_native.parse_chunk(recs, schema) is None


def _python_tables(path, batch_rows):
    pins, order, raw, out = {}, [], [], []
    for rec in record_io.iter_tfrecords(path):
        raw.append(rec)
        if len(raw) >= batch_rows:
            out.append(record_io._chunk(raw, pins, order))
            raw = []
    if raw:
        out.append(record_io._chunk(raw, pins, order))
    return out


@pytest.mark.parametrize("batch_rows", [7, 64])
def test_batches_through_the_core_equal_the_python_parse(tmp_path, batch_rows):
    recs, _ = _records(50, seed=9, packed=False)
    path = str(tmp_path / "r.tfrecord")
    write_tfrecord(path, recs)
    native_record.reset_counters()
    native = list(record_io.tf_example_batches(
        record_io.iter_tfrecords(path), batch_rows=batch_rows))
    seen = native_record.counters()
    python = _python_tables(path, batch_rows)
    assert [t.num_rows for t in native] == [t.num_rows for t in python]
    for a, b in zip(native, python):
        assert list(a.columns) == list(b.columns)
        for name in b.columns:
            assert a.columns[name].dtype == b.columns[name].dtype
            np.testing.assert_array_equal(a.columns[name], b.columns[name])
    # The first chunk was parsed in Python (it pins the schema), every later
    # one by the core; every record's two crc fields through the C crc.
    first = min(batch_rows, 50)
    assert seen["pin_chunks"] == 1 and seen["pin_records"] == first
    assert seen["native_records"] == 50 - first and seen["python_chunks"] == 0
    assert seen["native_chunks"] == len(native) - 1
    assert seen["crc_calls"] == 2 * 50
    assert seen["crc_nbytes"] == sum(8 + len(r) for r in recs)


def test_a_refused_chunk_goes_through_the_python_parse(tmp_path):
    """A later chunk with another value count is refused by the core; the
    Python parse then raises its pinned-count error, as the reference's."""
    recs, rows = _records(8, seed=1)
    for i in range(4, 8):
        rows[i]["vec"] = np.zeros(4, np.float32)
        recs[i] = encode_example(rows[i])
    path = str(tmp_path / "r.tfrecord")
    write_tfrecord(path, recs)
    native_record.reset_counters()
    with pytest.raises(ValueError, match="pinned by the first chunk"):
        list(record_io.tf_example_batches(record_io.iter_tfrecords(path),
                                          batch_rows=4))
    with pytest.raises(ValueError, match="pinned by the first chunk"):
        list(ref_io.tf_example_batches(ref_io.iter_tfrecords(path),
                                       batch_rows=4))
    assert native_record.counters()["python_chunks"] == 1


def test_a_first_chunk_that_deviates_parses_as_the_python_parse(tmp_path):
    """A missing feature in the first chunk, which both parse in Python
    to pin the schema: the reference's feature-set error."""
    recs, rows = _records(5, seed=2)
    recs[2] = encode_example({k: v for k, v in rows[2].items() if k != "pair"})
    path = str(tmp_path / "r.tfrecord")
    write_tfrecord(path, recs)
    for mod in (record_io, ref_io):
        with pytest.raises(ValueError, match="inconsistent feature sets"):
            list(mod.tf_example_batches(mod.iter_tfrecords(path)))


def test_bytes_that_are_not_utf8_still_raise(tmp_path):
    recs, rows = _records(6, seed=4)
    rows[5]["name"] = [b"\xff\xfe"]
    recs[5] = encode_example(rows[5])
    path = str(tmp_path / "r.tfrecord")
    write_tfrecord(path, recs)
    native_record.reset_counters()
    with pytest.raises(ValueError, match="non-UTF-8"):
        list(record_io.tf_example_batches(record_io.iter_tfrecords(path),
                                          batch_rows=3))
    assert native_record.counters()["python_chunks"] == 1


# RFC 3720 (iSCSI) appendix B.4 and the usual check value.
RFC3720 = [
    (bytes(32), 0x8A9136AA),
    (b"\xff" * 32, 0x62A8AB43),
    (bytes(range(32)), 0x46DD794E),
    (bytes(range(31, -1, -1)), 0x113FDB5C),
    (b"123456789", 0xE3069283),
    (b"", 0),
]


@pytest.mark.parametrize("data,want", RFC3720)
def test_crc32c_vectors(data, want):
    assert native_record.crc32c(data) == want
    assert record_io._crc32c_py(data) == want
    assert record_io._crc32c(data) == want


@settings(max_examples=60, deadline=None)
@given(data=st.binary(max_size=300), split=st.integers(0, 300))
def test_crc32c_equals_the_table_version_and_extends(data, split):
    assert record_io._crc32c(data) == record_io._crc32c_py(data)
    head, tail = data[:split], data[split:]
    assert native_record.crc32c(tail, native_record.crc32c(head)) == \
        native_record.crc32c(data)


def test_masked_crc_equals_the_references_on_seeded_bytes():
    rng = np.random.default_rng(0)
    for size in (0, 1, 7, 8, 9, 63, 1000, 1 << 16):
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        for off in range(3):  # unaligned starts take the byte loop first
            chunk = data[off:]
            assert record_io._masked_crc32c(chunk) == ref_io._masked_crc32c(chunk)
            assert record_io._crc32c(chunk) == record_io._crc32c_py(chunk)


def test_frames_written_by_the_port_verify_in_the_reference(tmp_path):
    recs, _ = _records(20, seed=6)
    path = str(tmp_path / "r.tfrecord")
    write_tfrecord(path, recs)
    assert list(ref_io.iter_tfrecords(path)) == recs
    with open(path, "rb") as f:
        blob = bytearray(f.read())
    blob[12 + 5] ^= 1  # a bit of the first payload
    bad = str(tmp_path / "bad.tfrecord")
    with open(bad, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(ValueError, match="payload-crc mismatch"):
        list(record_io.iter_tfrecords(bad))
    (length,) = struct.unpack("<Q", bytes(blob[:8]))
    assert length == len(recs[0])
