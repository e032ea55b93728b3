"""Vectorized stable string hashing for the host data plane (the port's
copy of ``tpu_pipelines/utils/hashing.py``, plus ``fnv1a_update``, which
continues a hash over another column so a row's fields hash as their join).

The Beam-replacement host stages (SURVEY.md §2b Beam row) hash strings in
bulk: ExampleGen's content-hash splits, ``tft.hash_strings``, and OOV
bucketing in ``vocab_apply``.  A per-row ``hashlib`` loop is the single
slowest pattern at dataset scale, so this module implements FNV-1a as a
columnwise numpy recurrence over the UTF-32 codepoint matrix: O(max_len)
vectorized passes instead of O(rows) Python iterations.

Properties: deterministic across runs/platforms/processes (pure uint64
wraparound arithmetic), independent of any seed, stable under row
reordering — the contract content-hash splitting needs.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

FNV_PRIME = np.uint64(1099511628211)
_FNV_PRIME = FNV_PRIME
FNV_OFFSET = np.uint64(14695981039346656037)
_FNV_OFFSET = FNV_OFFSET
# Process strings in row chunks so the padded [rows, max_len] codepoint
# matrix stays bounded even when one row is pathologically long.
_CHUNK_ROWS = 65536
# Code points widened to uint64 at a time by ``fnv1a_update`` (32 MB).
_BLOCK_CODES = 1 << 22


def _fnv1a_chunk(arr: np.ndarray) -> np.ndarray:
    """FNV-1a per row of a unicode array (numpy 'U' dtype), vectorized."""
    return fnv1a_update(np.full(len(arr), _FNV_OFFSET, np.uint64), arr)


def fnv1a_update(h: np.ndarray, arr: np.ndarray) -> np.ndarray:
    """Continue the FNV-1a states ``h`` (uint64, one per row) over each
    row of the unicode array ``arr``."""
    n = len(arr)
    if n == 0:
        return np.zeros(0, np.uint64)
    arr = np.asarray(arr, dtype="U")  # pads rows to the chunk max length
    lengths = np.char.str_len(arr)
    max_len = max(1, int(arr.dtype.itemsize // 4))
    codes = np.frombuffer(
        arr.tobytes(), dtype=np.uint32
    ).reshape(n, max_len)
    h = np.array(h, np.uint64)
    # Every row has its first ``common`` code points: those positions need
    # no mask, and run as two in-place ufuncs a position over columns
    # widened in blocks of at most _BLOCK_CODES codes (a few long rows,
    # as a flattened image's text, spend their time here).
    common, end = int(lengths.min()), int(lengths.max())
    cols = max(1, _BLOCK_CODES // n)
    with np.errstate(over="ignore"):
        for lo in range(0, common, cols):
            block = np.ascontiguousarray(
                codes[:, lo:min(common, lo + cols)].T, dtype=np.uint64)
            for col in block:
                np.bitwise_xor(h, col, out=h)
                np.multiply(h, _FNV_PRIME, out=h)
        for j in range(common, end):
            active = j < lengths
            upd = (h ^ codes[:, j].astype(np.uint64)) * _FNV_PRIME
            h = np.where(active, upd, h)
    return h


def hash_strings(values: Iterable) -> np.ndarray:
    """uint64 content hash per element (elements are str()-ed first)."""
    arr = np.asarray(values)
    if arr.dtype == object or arr.dtype.kind not in ("U", "S"):
        arr = np.asarray([("" if v is None else str(v)) for v in arr])
    elif arr.dtype.kind == "S":
        arr = np.char.decode(arr, "utf-8")
    out = np.empty(len(arr), np.uint64)
    for start in range(0, len(arr), _CHUNK_ROWS):
        out[start:start + _CHUNK_ROWS] = _fnv1a_chunk(
            arr[start:start + _CHUNK_ROWS]
        )
    return out


def hash_buckets(values: Iterable, num_buckets: int) -> np.ndarray:
    """Stable bucket index in [0, num_buckets) per element."""
    return (hash_strings(values) % np.uint64(num_buckets)).astype(np.int64)
