"""ctypes binding over ``csrc/host/record_core.cc``: the tf.Example chunk
parser and the crc32c of record ingest.

The port of ``tpu_pipelines/data/native_record.py``.  The per-record
protobuf wire decode and the crc of every framed record are the serial
host stages of record ingest; the C++ loops run them far faster than the
interpreter.

Strictness contract (record_core.cc): the engine parses against the schema
the caller pinned; ANY deviation (unknown or missing feature, count
mismatch, malformed bytes) fails the whole chunk, ``parse_chunk`` returns
None and the caller re-parses the chunk with the Python decoder, whose
errors and output are the semantics.  The native path can only produce
identical data faster, never different data.

What differs from the reference: the library is built by ``ops/_build.py``
(``g++``, into ``_build/``) at first use, and a failed build raises, naming
the compiler; the reference logs and returns None for every chunk
(``ROADMAP.md`` C).  The library also carries ``rec_crc32c``, which
``data/record_io.py`` frames and verifies every record with (the reference
uses the ``google_crc32c`` extension when installed, which the port does
not import).

Counters (``counters()`` / ``reset_counters()``): records parsed natively,
first chunks parsed in Python to pin the schema, chunks the native parser
refused (re-parsed in Python), and the calls and bytes of the C crc, so a
caller can tell that a path still uses the core.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpu_pipelines_torch.ops import _build

LIB_NAME = "record_core"

KIND_BYTES, KIND_FLOAT, KIND_INT64 = 0, 1, 2

_I64P = ctypes.POINTER(ctypes.c_int64)
_PROTOTYPES = {
    "rec_parser_create": (ctypes.c_void_p, [
        ctypes.c_char_p, _I64P, ctypes.POINTER(ctypes.c_int32), _I64P,
        ctypes.c_int64,
    ]),
    "rec_parser_destroy": (None, [ctypes.c_void_p]),
    "rec_set_float_out": (None, [ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_void_p]),
    "rec_set_int64_out": (None, [ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_void_p]),
    "rec_parse_batch": (ctypes.c_int64, [
        ctypes.c_void_p, ctypes.c_char_p, _I64P, ctypes.c_int64,
    ]),
    "rec_bytes_size": (ctypes.c_int64, [ctypes.c_void_p, ctypes.c_int64]),
    "rec_bytes_count": (ctypes.c_int64, [ctypes.c_void_p, ctypes.c_int64]),
    "rec_copy_bytes": (None, [  # tpp: disable=TPP214 (dict key)
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]),
    "rec_crc32c": (ctypes.c_uint32, [ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.c_uint32]),
}

_COUNTER_NAMES = ("native_records", "native_chunks", "pin_records",
                  "pin_chunks", "python_chunks", "crc_calls", "crc_nbytes")
_COUNTS = dict.fromkeys(_COUNTER_NAMES, 0)
_COUNT_LOCK = threading.Lock()


def _count(**deltas: int) -> None:
    with _COUNT_LOCK:
        for name, n in deltas.items():
            _COUNTS[name] += n


def counters() -> Dict[str, int]:
    """The counts since the last reset: ``native_records`` /
    ``native_chunks`` parsed by the core, ``pin_records`` / ``pin_chunks``
    parsed in Python as a stream's first chunk (it pins the schema),
    ``python_chunks`` the core refused (re-parsed in Python),
    ``crc_calls`` / ``crc_nbytes`` of the C crc32c."""
    with _COUNT_LOCK:
        return dict(_COUNTS)


def reset_counters() -> None:
    with _COUNT_LOCK:
        for name in _COUNTS:
            _COUNTS[name] = 0


def library() -> ctypes.CDLL:
    """The record core, built with ``g++`` at first use (raises when the
    build fails)."""
    return _build.load_host(LIB_NAME, _PROTOTYPES)


def build_seconds() -> float:
    """Build the record core now; the compile's seconds (0.0 when an
    up-to-date library was already built)."""
    return _build.build_host(LIB_NAME)


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of ``data``, continuing from ``crc``."""
    _count(crc_calls=1, crc_nbytes=len(data))
    return int(library().rec_crc32c(data, len(data), crc))


# Schema: [(name, kind, count)], pinned by the caller.
Schema = List[Tuple[str, int, int]]


def parse_chunk(
    records: Sequence[bytes], schema: Schema
) -> Optional[Dict[str, object]]:
    """Parse records strictly against ``schema``.

    Returns {name: float32/int64 ndarray [n, count]} for numeric features
    and {name: (bytes_data uint8 ndarray, offsets int64 ndarray)} for bytes
    features, or None when the chunk deviates from the schema (the caller
    re-parses it in Python).
    """
    if not records or not schema:
        return None
    lib = library()
    n = len(records)
    names = "".join(name for name, _, _ in schema).encode("utf-8")
    name_offsets = np.zeros(len(schema) + 1, np.int64)
    np.cumsum(
        [len(name.encode("utf-8")) for name, _, _ in schema],
        out=name_offsets[1:],
    )
    kinds = np.asarray([k for _, k, _ in schema], np.int32)
    counts = np.asarray([c for _, _, c in schema], np.int64)
    h = lib.rec_parser_create(
        names, name_offsets.ctypes.data_as(_I64P),
        kinds.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        counts.ctypes.data_as(_I64P), len(schema),
    )
    try:
        out: Dict[str, object] = {}
        for i, (name, kind, count) in enumerate(schema):
            if kind == KIND_FLOAT:
                arr = np.empty((n, count), np.float32)
                lib.rec_set_float_out(h, i, arr.ctypes.data)
                out[name] = arr
            elif kind == KIND_INT64:
                arr = np.empty((n, count), np.int64)
                lib.rec_set_int64_out(h, i, arr.ctypes.data)
                out[name] = arr

        data = b"".join(records)
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum(
            np.fromiter((len(r) for r in records), np.int64, count=n),
            out=offsets[1:],
        )
        if lib.rec_parse_batch(h, data, offsets.ctypes.data_as(_I64P), n) != 0:
            return None

        for i, (name, kind, count) in enumerate(schema):
            if kind != KIND_BYTES:
                continue
            total = int(lib.rec_bytes_size(h, i))
            n_vals = int(lib.rec_bytes_count(h, i))
            if n_vals != n * count:
                return None
            bdata = np.empty(max(1, total), np.uint8)
            boffsets = np.empty(n_vals + 1, np.int64)
            lib.rec_copy_bytes(h, i, bdata.ctypes.data, boffsets.ctypes.data)
            out[name] = (bdata[:total], boffsets)
        return out
    finally:
        lib.rec_parser_destroy(h)
