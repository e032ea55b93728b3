"""ctypes binding over ``csrc/host/tokenizer_core.cc``: the host tokenizer.

The port of ``tpu_pipelines/transform/native_tokenizer.py``.  Wordpiece
encoding is the per-row host stage of the BERT Transform, and the vocabulary
count its analysis pass; the C++ loops run both far faster than the
interpreter, with none of a process pool's spawn latency.  Semantics parity
contract, as the reference's:

  - rows that are pure ASCII after ``str()`` encode (and count) in C++,
    whose pretokenizer and lowercaser are exactly the ASCII projection of
    the Python engine's ``\\w+|[^\\w\\s]`` + ``str.lower()``;
  - any row with a code point above 127 goes through the Python engine
    (Python's unicode tables are the semantics), and the results are
    stitched back in row order.

What differs from the reference: the library is built by ``ops/_build.py``
(``g++``, into ``_build/``) at first use and a failed build raises, naming
the compiler; the reference logs and falls back to Python (``ROADMAP.md``
C).  ``encode_batch`` still returns None when more than ``max_python_rows``
rows need the Python engine, so the caller's process pool takes the column.

Counters (``counters()`` / ``reset_counters()``): rows encoded natively,
rows sent to the Python engine (inline, or the whole column to the pool),
and rows counted natively and in Python by the vocabulary counter.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Any, Dict, List, Optional

import numpy as np

from tpu_pipelines_torch.ops import _build

LIB_NAME = "tokenizer_core"

_I64P = ctypes.POINTER(ctypes.c_int64)
_PROTOTYPES = {
    "tok_create": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.c_int]),
    "tok_destroy": (None, [ctypes.c_void_p]),
    "tok_has_wordpiece": (ctypes.c_int, [ctypes.c_void_p]),
    "tok_encode_batch": (None, [
        ctypes.c_void_p, ctypes.c_char_p, _I64P, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_void_p,
    ]),
    "tok_counter_create": (ctypes.c_void_p, [ctypes.c_int]),
    "tok_counter_destroy": (None, [ctypes.c_void_p]),
    "tok_counter_add": (None, [ctypes.c_void_p, ctypes.c_char_p, _I64P,
                               ctypes.c_int64]),
    "tok_counter_add_ucs4": (None, [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int64, ctypes.c_int64]),
    "tok_counter_serialize": (ctypes.c_int64, [ctypes.c_void_p,
                                               ctypes.c_char_p,
                                               ctypes.c_int64]),
}

_COUNTER_NAMES = ("native_rows", "python_rows", "count_native_rows",
                  "count_python_rows")
_COUNTS = dict.fromkeys(_COUNTER_NAMES, 0)
_COUNT_LOCK = threading.Lock()


def _count(**deltas: int) -> None:
    with _COUNT_LOCK:
        for name, n in deltas.items():
            _COUNTS[name] += n


def counters() -> Dict[str, int]:
    """The counts since the last reset: ``native_rows`` encoded by the
    core, ``python_rows`` encoded by the Python engine (inline or in the
    pool), ``count_native_rows`` / ``count_python_rows`` counted by the
    vocabulary pass."""
    with _COUNT_LOCK:
        return dict(_COUNTS)


def reset_counters() -> None:
    with _COUNT_LOCK:
        for name in _COUNTS:
            _COUNTS[name] = 0


def library() -> ctypes.CDLL:
    """The tokenizer core, built with ``g++`` at first use (raises when the
    build fails)."""
    return _build.load_host(LIB_NAME, _PROTOTYPES)


def build_seconds() -> float:
    """Build the tokenizer core now; the compile's seconds (0.0 when an
    up-to-date library was already built)."""
    return _build.build_host(LIB_NAME)


def _all_ascii_view(strs: np.ndarray):
    """(contiguous array, width in chars) when every code point of the
    U-dtype array is ASCII, else None: one vectorized max is the check."""
    if strs.size == 0 or strs.dtype.itemsize == 0:
        return None
    strs = np.ascontiguousarray(strs)
    if int(strs.view(np.uint32).max(initial=0)) >= 128:
        return None
    return strs, strs.dtype.itemsize // 4


def _pack_rows(rows: List[bytes]):
    """(data, offsets pointer, offsets array, n) for the concatenated-rows
    C ABI; the caller keeps the array alive across the call."""
    n = len(rows)
    offsets = np.zeros(n + 1, dtype=np.int64)
    if n:
        np.cumsum(np.fromiter((len(r) for r in rows), np.int64, count=n),
                  out=offsets[1:])
    return b"".join(rows), offsets.ctypes.data_as(_I64P), offsets, n


class NativeTokenizer:
    """One vocabulary and its parameters; reusable across chunks."""

    def __init__(self, vocab: List[str], lowercase: bool):
        self._lib = library()
        buf = "\n".join(vocab).encode("utf-8")
        self._handle = self._lib.tok_create(buf, len(buf),
                                            1 if lowercase else 0)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.tok_destroy(handle)
            self._handle = None

    def encode_ascii_rows(self, rows: List[bytes], max_len: int) -> np.ndarray:
        """[len(rows), max_len] int32 ids for rows already known ASCII."""
        if max_len < 2:
            # The core's budget arithmetic needs room for [CLS] + [SEP].
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        out = np.zeros((len(rows), max_len), dtype=np.int32)
        if rows:
            data, offsets_ptr, _offsets, n = _pack_rows(rows)
            self._lib.tok_encode_batch(self._handle, data, offsets_ptr, n,
                                       max_len, out.ctypes.data)
            _count(native_rows=n)
        return out


class NativeTokenCounter:
    """Streaming pretoken counter over ASCII rows (the vocabulary-build
    side): counts stay in the core's hash map until ``counts()``."""

    def __init__(self, lowercase: bool):
        self._lib = library()
        self._handle = self._lib.tok_counter_create(1 if lowercase else 0)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.tok_counter_destroy(handle)
            self._handle = None

    def add_ascii_rows(self, rows: List[bytes]) -> None:
        if not rows:
            return
        data, offsets_ptr, _offsets, n = _pack_rows(rows)
        self._lib.tok_counter_add(self._handle, data, offsets_ptr, n)
        _count(count_native_rows=n)

    def add_unicode_array(self, strs: np.ndarray) -> bool:
        """Count a ``U<width>`` array straight from its UCS4 buffer.  False
        (nothing counted) when a code point is not ASCII: the caller then
        routes row by row."""
        if strs.size == 0 or strs.dtype.itemsize == 0:
            return True
        view = _all_ascii_view(strs)
        if view is None:
            return False
        arr, width = view
        self._lib.tok_counter_add_ucs4(self._handle, arr.ctypes.data,
                                       arr.size, width)
        _count(count_native_rows=int(arr.size))
        return True

    def counts(self) -> Dict[str, int]:
        needed = self._lib.tok_counter_serialize(self._handle, None, 0)
        if needed <= 0:
            return {}
        buf = ctypes.create_string_buffer(int(needed))
        self._lib.tok_counter_serialize(self._handle, buf, needed)
        out: Dict[str, int] = {}
        for line in buf.raw[:needed].decode("utf-8").splitlines():
            term, _, cnt = line.rpartition("\t")
            out[term] = int(cnt)
        return out


def encode_batch(
    col, params: Dict[str, Any], state: Dict[str, Any], python_engine,
    max_python_rows: int = 4096,
) -> Optional[np.ndarray]:
    """Encode a column through the core; None = the caller's process pool
    should take the whole column.

    ``python_engine(subset_rows) -> ndarray`` encodes the rows that are not
    ASCII (and is the semantics reference).  ``state`` memoizes the
    NativeTokenizer beside the vocabulary's other derived caches.  When
    more than ``max_python_rows`` rows need the Python engine (a mostly
    non-ASCII corpus), returns None.
    """
    tok = state.get("_native_tok")
    if tok is None:
        tok = state["_native_tok"] = NativeTokenizer(
            list(state["vocab"]), bool(params.get("lowercase", True)))
    max_len = int(params["max_len"])
    ascii_rows: List[bytes] = []
    fallback_idx: List[int] = []
    for i, text in enumerate(col):
        s = "" if text is None else str(text)
        try:
            ascii_rows.append(s.encode("ascii"))
        except UnicodeEncodeError:
            fallback_idx.append(i)
    if len(fallback_idx) > max_python_rows:
        return None
    if not fallback_idx:
        return tok.encode_ascii_rows(ascii_rows, max_len)
    out = np.zeros((len(col), max_len), dtype=np.int32)
    native = np.ones(len(col), bool)
    native[fallback_idx] = False
    if ascii_rows:
        out[native] = tok.encode_ascii_rows(ascii_rows, max_len)
    subset = np.asarray(
        ["" if col[i] is None else str(col[i]) for i in fallback_idx],
        dtype=object,
    )
    out[np.asarray(fallback_idx)] = python_engine(subset)
    _count(python_rows=len(fallback_idx))
    return out
