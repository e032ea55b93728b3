"""TFRecord / ArrayRecord ingest without TensorFlow.

The port's copy of ``tpu_pipelines/data/record_io.py``: the TFRecord
container framing (length / masked-crc / payload) and a minimal protobuf
wire decoder of ``tf.train.Example`` (Example.features=1, Features.feature=1
map, Feature oneof bytes_list=1 / float_list=2 / int64_list=3, each with
value=1; packed and unpacked repeated encodings both accepted), copied
as they are.  ArrayRecord files are read through the ``array_record``
bindings, imported at call time; without the package the read raises,
naming it.

What differs: batches come out as the port's numpy columns
(``data/examples_io.Table``), not as pyarrow RecordBatches.  A scalar
feature becomes a 1-D column (float32, int64, or a ``U`` string array), a
fixed-length multi-value feature a 2-D column; the value count and kind are
pinned by the first chunk, as in the reference.  A bytes feature that is not
UTF-8 raises: the ``.npz`` shards keep strings as ``U`` arrays
(``allow_pickle=False``) and have no binary column (``ROADMAP.md`` C, the
Examples format).  Every record is parsed in Python; the reference's native
chunk parser is ``ROADMAP.md`` A24.

CRC verification: both masked crc32c fields of every record are verified
by default (``verify_crc=False`` opts out for trusted re-reads).  The crc32c
is table-based Python; the reference's ``google_crc32c`` C extension is not
imported, so the port reads the same on a machine without it.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from tpu_pipelines_torch.data.examples_io import Table

# ------------------------------------------------------------------ framing

# Sanity cap on the framed record length: a corrupt length field must fail
# fast, not trigger an unbounded multi-GB f.read allocation first.
MAX_RECORD_BYTES = 1 << 30


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C_TABLE = _crc32c_table()


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), reflected, table-driven."""
    table = _CRC32C_TABLE
    crc = 0xFFFFFFFF
    for byte in data:
        crc = (crc >> 8) ^ table[(crc ^ byte) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc32c(data: bytes) -> int:
    """TFRecord's masked crc: rotate-right-15 of crc32c, plus a constant."""
    crc = _crc32c(data)
    return ((crc >> 15) | ((crc << 17) & 0xFFFFFFFF)) + 0xA282EAD8 & 0xFFFFFFFF


def iter_tfrecords(path: str, verify_crc: bool = True) -> Iterator[bytes]:
    """Yield raw record payloads from one TFRecord file.

    Container framing per record: u64le length, u32le masked length-crc,
    payload, u32le masked payload-crc.  Both masked crc32c fields are
    verified by default; the length is sanity-capped before allocation so
    a corrupt length field cannot trigger an unbounded read.
    """
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise ValueError(
                    f"truncated TFRecord header in {path!r} "
                    f"({len(header)} trailing bytes)"
                )
            (length,) = struct.unpack("<Q", header[:8])
            if verify_crc:
                (length_crc,) = struct.unpack("<I", header[8:12])
                if _masked_crc32c(header[:8]) != length_crc:
                    raise ValueError(
                        f"TFRecord length-crc mismatch in {path!r} at "
                        f"offset {f.tell() - 12} — file is corrupt"
                    )
            if length > MAX_RECORD_BYTES:
                raise ValueError(
                    f"TFRecord length field {length} in {path!r} exceeds "
                    f"the {MAX_RECORD_BYTES}-byte cap — corrupt framing"
                )
            payload = f.read(length)
            if len(payload) < length:
                raise ValueError(
                    f"truncated TFRecord payload in {path!r} "
                    f"(wanted {length}, got {len(payload)})"
                )
            footer = f.read(4)
            if len(footer) < 4:
                raise ValueError(f"truncated TFRecord footer in {path!r}")
            if verify_crc:
                (payload_crc,) = struct.unpack("<I", footer)
                if _masked_crc32c(payload) != payload_crc:
                    raise ValueError(
                        f"TFRecord payload-crc mismatch in {path!r} at "
                        f"offset {f.tell() - 4 - length} — data is corrupt"
                    )
            yield payload


def iter_array_records(path: str) -> Iterator[bytes]:
    """Yield raw record payloads from one ArrayRecord file."""
    try:
        from array_record.python.array_record_module import ArrayRecordReader
    except ImportError as e:
        raise ImportError(
            f"reading {path!r} needs the 'array_record' package, which is "
            "not installed"
        ) from e

    reader = ArrayRecordReader(path)
    try:
        n = reader.num_records()
        # Chunked reads: bounded memory on arbitrarily large files.
        chunk = 4096
        for lo in range(0, n, chunk):
            for rec in reader.read(list(range(lo, min(lo + chunk, n)))):
                yield rec
    finally:
        reader.close()


# ------------------------------------------------- tf.train.Example parsing


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:
        _, pos = _read_varint(buf, pos)
        return pos
    if wire_type == 1:
        return pos + 8
    if wire_type == 2:
        n, pos = _read_varint(buf, pos)
        return pos + n
    if wire_type == 5:
        return pos + 4
    raise ValueError(f"unsupported wire type {wire_type}")


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, bytes, int]]:
    """Yield (field_number, wire_type, buf, value_pos) — caller decodes."""
    pos = 0
    end = len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        yield key >> 3, key & 0x7, buf, pos
        pos = _skip_field(buf, pos, key & 0x7)


def _length_delimited(buf: bytes, pos: int) -> bytes:
    n, pos = _read_varint(buf, pos)
    return buf[pos : pos + n]


def _decode_float_list(buf: bytes) -> np.ndarray:
    """FloatList: repeated float value = 1 — packed or unpacked, in wire
    order (mixed encodings concatenate as encountered)."""
    parts: List[np.ndarray] = []
    for num, wt, b, pos in _iter_fields(buf):
        if num != 1:
            continue
        if wt == 2:
            parts.append(np.frombuffer(_length_delimited(b, pos), "<f4"))
        elif wt == 5:
            parts.append(
                np.asarray([struct.unpack_from("<f", b, pos)[0]], "<f4")
            )
    if not parts:
        return np.asarray([], "<f4")
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def _to_i64(v: int) -> int:
    """Truncate a decoded varint to int64 as protobuf's C++ readers do (a
    non-canonical 10-byte varint can decode to v >= 2^64)."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


def _decode_int64_list(buf: bytes) -> np.ndarray:
    """Int64List: repeated int64 value = 1 — packed varints or unpacked."""
    out: List[int] = []
    for num, wt, b, pos in _iter_fields(buf):
        if num != 1:
            continue
        if wt == 2:
            chunk = _length_delimited(b, pos)
            p = 0
            while p < len(chunk):
                v, p = _read_varint(chunk, p)
                out.append(_to_i64(v))
        elif wt == 0:
            v, _ = _read_varint(b, pos)
            out.append(_to_i64(v))
    return np.asarray(out, np.int64)


def _decode_bytes_list(buf: bytes) -> List[bytes]:
    return [
        _length_delimited(b, pos)
        for num, wt, b, pos in _iter_fields(buf)
        if num == 1 and wt == 2
    ]


def parse_tf_example(payload: bytes) -> Dict[str, object]:
    """tf.train.Example bytes -> {feature_name: ndarray | list[bytes]}."""
    features: Dict[str, object] = {}
    for num, wt, buf, pos in _iter_fields(payload):
        if num != 1 or wt != 2:           # Example.features
            continue
        for fnum, fwt, fbuf, fpos in _iter_fields(_length_delimited(buf, pos)):
            if fnum != 1 or fwt != 2:     # Features.feature map entry
                continue
            entry = _length_delimited(fbuf, fpos)
            name: Optional[str] = None
            value: object = None
            for enum_, ewt, ebuf, epos in _iter_fields(entry):
                if enum_ == 1 and ewt == 2:          # key
                    name = _length_delimited(ebuf, epos).decode("utf-8")
                elif enum_ == 2 and ewt == 2:        # value: Feature
                    feat = _length_delimited(ebuf, epos)
                    for knum, kwt, kbuf, kpos in _iter_fields(feat):
                        if kwt != 2:
                            continue
                        body = _length_delimited(kbuf, kpos)
                        if knum == 1:
                            value = _decode_bytes_list(body)
                        elif knum == 2:
                            value = _decode_float_list(body)
                        elif knum == 3:
                            value = _decode_int64_list(body)
            if name is not None and value is not None:
                features[name] = value
    return features


# ------------------------------------------------------------ batch builder

_KIND_NAMES = {0: "bytes", 1: "float32", 2: "int64"}


def _column(values: list, name: str, pins: Dict[str, dict]) -> np.ndarray:
    """Rows of a feature -> a numpy column (1-D for one value a row, 2-D
    for a fixed count).

    Every row must have the same value count, and the count and the kind
    are pinned by the first chunk: a later chunk that differs raises a
    contextual error (the reference's first-chunk typing contract)."""
    lengths = {len(v) for v in values}
    if len(lengths) != 1:
        raise ValueError(
            f"feature {name!r} is ragged (row value counts {sorted(lengths)}); "
            "fixed-length features required — pad upstream or split columns"
        )
    (n,) = lengths
    if n == 0:
        raise ValueError(f"feature {name!r} has empty values")
    pin = pins.get(name)
    if pin is not None and pin["n"] != n:
        raise ValueError(
            f"feature {name!r} has {n} values per row in a later chunk but "
            f"{pin['n']} in the first chunk; fixed-length features required "
            "— the shape is pinned by the first chunk (like streaming CSV "
            "inference)"
        )
    first = values[0]
    if isinstance(first, list):                       # bytes rows
        kind = 0
        try:
            col = np.asarray(
                [b.decode("utf-8") for row in values for b in row], dtype="U"
            )
        except UnicodeDecodeError as e:
            raise ValueError(
                f"feature {name!r} holds non-UTF-8 bytes ({e}); the port's "
                ".npz Examples keep text columns only (ROADMAP.md C, the "
                "Examples format)"
            ) from e
    else:
        col = np.concatenate(values)
        kind = 1 if col.dtype == np.float32 else 2
    if pin is not None and pin["kind"] != kind:
        raise ValueError(
            f"feature {name!r} is {_KIND_NAMES[kind]} in a later chunk but "
            f"{_KIND_NAMES[pin['kind']]} in the first chunk; the column type "
            "is pinned by the first chunk (like streaming CSV inference) — "
            "fix the drifting rows upstream"
        )
    if pin is None:
        pins[name] = {"n": n, "kind": kind}
    return col if n == 1 else col.reshape(len(values), n)


def _chunk(raw: List[bytes], pins: Dict[str, dict], order: List[str]) -> Table:
    rows = [parse_tf_example(rec) for rec in raw]
    if not order:
        order.extend(rows[0])
    for r in rows:
        if set(r) != set(order):
            missing = set(order) ^ set(r)
            raise ValueError(
                f"inconsistent feature sets across examples: {missing}"
            )
    return Table({
        name: _column([r[name] for r in rows], name, pins) for name in order
    })


def tf_example_batches(
    records: Iterable[bytes], batch_rows: int = 8192
) -> Iterator[Table]:
    """Parse a record stream into tables of at most ``batch_rows`` rows.
    The first chunk pins the schema (feature kinds and value counts)."""
    pins: Dict[str, dict] = {}
    order: List[str] = []
    raw: List[bytes] = []
    for rec in records:
        raw.append(rec)
        if len(raw) >= batch_rows:
            yield _chunk(raw, pins, order)
            raw = []
    if raw:
        yield _chunk(raw, pins, order)
