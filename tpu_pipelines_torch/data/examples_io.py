"""On-disk ``Examples`` artifact format: columnar ``.npz`` shards per split.

Layout under an Examples artifact uri::

    <uri>/Split-<name>/data-00000-of-00004.npz

The port's counterpart of ``tpu_pipelines/data/examples_io.py``, which
writes Parquet through ``pyarrow``.  The port reads and writes numpy's own
archive instead, so its data plane needs nothing beyond numpy: one array
per column (strings as numpy ``U`` arrays, so ``allow_pickle=False`` holds;
2-D arrays for fixed-length vector columns), and for a column that holds
nulls a boolean mask beside it (``<name>.__null__``).  Null semantics follow
the reference's Arrow columns: a null int or double reads back as NaN in a
float64 column, a null string as ``None`` in an object column, and the
statistics count nulls from the mask.  Parity with the reference is held on
column values, not on file bytes (``ROADMAP.md`` C).

As in the reference, the shard is the unit of parallelism (one writer, one
file) and ``rows`` the unit of streaming; shards are contiguous row slices
of a split, so concatenating them in index order gives the split's rows in
their written order.
"""

from __future__ import annotations

import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Mapping, Optional, Sequence

import numpy as np

SPLIT_PREFIX = "Split-"
_SHARD_RE = re.compile(r"^data-(\d{5})-of-(\d{5})\.npz$")
NULL_SUFFIX = ".__null__"
_COLUMNS_KEY = "__columns__"
_ROWS_KEY = "__num_rows__"
# Rows per streamed chunk (the reference's Parquet row-group size).
DEFAULT_ROW_GROUP = 16384


class Table:
    """An ordered set of equal-length numpy columns with optional null
    masks: the port's stand-in for the reference's ``pyarrow.Table``."""

    def __init__(
        self,
        columns: Mapping[str, np.ndarray],
        nulls: Optional[Mapping[str, np.ndarray]] = None,
    ):
        self.columns: Dict[str, np.ndarray] = {
            k: np.asarray(v) for k, v in columns.items()
        }
        self.nulls: Dict[str, np.ndarray] = {
            k: np.asarray(m, bool) for k, m in (nulls or {}).items()
            if m is not None and np.asarray(m).any()
        }
        lengths = {len(v) for v in self.columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of unequal length: {sorted(lengths)}")
        self.num_rows = lengths.pop() if lengths else 0

    @property
    def column_names(self) -> List[str]:
        return list(self.columns)

    def null_mask(self, name: str) -> Optional[np.ndarray]:
        return self.nulls.get(name)

    def null_count(self, name: str) -> int:
        mask = self.nulls.get(name)
        return 0 if mask is None else int(mask.sum())

    def take(self, index) -> "Table":
        """Rows selected by a slice, a boolean mask or an index array."""
        return Table(
            {k: v[index] for k, v in self.columns.items()},
            {k: m[index] for k, m in self.nulls.items()},
        )

    def slice(self, start: int, length: int) -> "Table":
        return self.take(slice(start, start + length))

    def empty_like(self) -> "Table":
        return self.take(slice(0, 0))


def concat_tables(tables: Sequence[Table]) -> Table:
    if len(tables) == 1:
        return tables[0]
    names = tables[0].column_names
    nulls = {}
    for name in names:
        if any(name in t.nulls for t in tables):
            nulls[name] = np.concatenate([
                t.nulls.get(name, np.zeros(t.num_rows, bool)) for t in tables
            ])
    return Table(
        {n: np.concatenate([t.columns[n] for t in tables]) for n in names},
        nulls,
    )


def shard_file_name(index: int, count: int) -> str:
    if not 0 <= index < count:
        raise ValueError(f"shard index {index} not in [0, {count})")
    return f"data-{index:05d}-of-{count:05d}.npz"


def split_dir(uri: str, split: str) -> str:
    return os.path.join(uri, f"{SPLIT_PREFIX}{split}")


def _shard_files_in(d: str) -> List[str]:
    try:
        names = os.listdir(d)
    except (FileNotFoundError, NotADirectoryError):
        return []
    return sorted(n for n in names if _SHARD_RE.match(n))


def split_shard_paths(uri: str, split: str) -> List[str]:
    """Ordered shard paths of a split.  Raises FileNotFoundError if the
    split is absent and ValueError if the shard set is inconsistent (a
    partial write)."""
    d = split_dir(uri, split)
    shards = _shard_files_in(d)
    if not shards:
        raise FileNotFoundError(
            f"Examples artifact at {uri!r} has no split {split!r} "
            f"(available: {split_names(uri)})"
        )
    count = int(_SHARD_RE.match(shards[0]).group(2))
    expect = [shard_file_name(i, count) for i in range(count)]
    if shards != expect:
        raise ValueError(
            f"split {split!r} at {uri!r} has an inconsistent shard set "
            f"{shards} (expected {count} files data-*-of-{count:05d}); "
            "partial write?"
        )
    return [os.path.join(d, n) for n in shards]


def num_split_shards(uri: str, split: str) -> int:
    return len(split_shard_paths(uri, split))


def split_names(uri: str) -> List[str]:
    if not os.path.isdir(uri):
        return []
    return [
        d[len(SPLIT_PREFIX):] for d in sorted(os.listdir(uri))
        if d.startswith(SPLIT_PREFIX)
        and _shard_files_in(os.path.join(uri, d))
    ]


def _shard_bounds(num_rows: int, num_shards: int) -> List[int]:
    """Row offsets slicing ``num_rows`` into ``num_shards`` contiguous,
    maximally-even shards (first ``num_rows % num_shards`` get one extra)."""
    base, extra = divmod(num_rows, num_shards)
    bounds = [0]
    for i in range(num_shards):
        bounds.append(bounds[-1] + base + (1 if i < extra else 0))
    return bounds


def _write_table(path: str, table: Table) -> None:
    arrays = {
        _COLUMNS_KEY: np.asarray(table.column_names, dtype="U"),
        _ROWS_KEY: np.asarray(table.num_rows, np.int64),
    }
    for name, col in table.columns.items():
        mask = table.nulls.get(name)
        if col.dtype == object:
            # U arrays keep allow_pickle=False; a None is "" under the mask.
            none = np.asarray([v is None for v in col], bool)
            if none.any():
                col = np.where(none, "", col)
                mask = none if mask is None else (mask | none)
            col = col.astype("U") if len(col) else np.zeros(0, "U1")
        arrays[name] = col
        if mask is not None:
            arrays[name + NULL_SUFFIX] = mask
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _as_table(table) -> Table:
    return table if isinstance(table, Table) else table_from_columns(table)


def write_split(
    uri: str, split: str, table, num_shards: int = 1,
) -> str:
    """Materialize a whole split as ``num_shards`` contiguous shards,
    written in a thread pool; returns the split directory."""
    table = _as_table(table)
    d = split_dir(uri, split)
    os.makedirs(d, exist_ok=True)
    bounds = _shard_bounds(table.num_rows, num_shards)

    def write_one(i: int) -> None:
        _write_table(
            os.path.join(d, shard_file_name(i, num_shards)),
            table.slice(bounds[i], bounds[i + 1] - bounds[i]),
        )

    workers = min(num_shards, os.cpu_count() or 1)
    if workers > 1:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(write_one, range(num_shards)))
    else:
        for i in range(num_shards):
            write_one(i)
    return d


class SplitWriter:
    """One shard of a split, written incrementally: ``write_table`` appends
    a chunk, ``close`` writes the shard file (an empty shard when nothing
    was written, with ``schema``'s columns)."""

    def __init__(self, path: str, schema: Table):
        self.path = path
        self._schema = schema.empty_like()
        self._chunks: List[Table] = []

    def write_table(self, table) -> None:
        self._chunks.append(_as_table(table))

    def close(self) -> None:
        if self.path is None:
            return
        table = concat_tables(self._chunks) if self._chunks else self._schema
        _write_table(self.path, table)
        self.path = None
        self._chunks = []

    def __enter__(self) -> "SplitWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open_split_writer(
    uri: str, split: str, schema, shard: int = 0, num_shards: int = 1,
) -> SplitWriter:
    """Incremental writer of one shard of ``split``; a sharding component
    opens one writer per shard (all ``num_shards``, so the shard set is
    complete even when some end up empty).  ``schema`` is a table whose
    columns (and dtypes) an empty shard takes."""
    d = split_dir(uri, split)
    os.makedirs(d, exist_ok=True)
    return SplitWriter(
        os.path.join(d, shard_file_name(shard, num_shards)), _as_table(schema)
    )


def _select_paths(
    uri: str, split: str, shards: Optional[Sequence[int]]
) -> List[str]:
    paths = split_shard_paths(uri, split)
    if shards is None:
        return paths
    for s in shards:
        if not 0 <= s < len(paths):
            raise IndexError(
                f"shard {s} out of range for split {split!r} "
                f"({len(paths)} shard(s))"
            )
    return [paths[s] for s in shards]


def _read_shard(path: str, columns: Optional[Sequence[str]]) -> Table:
    with np.load(path, allow_pickle=False) as data:
        names = [str(n) for n in data[_COLUMNS_KEY]]
        if columns is not None:
            missing = [c for c in columns if c not in names]
            if missing:
                raise KeyError(f"columns {missing} not in {path!r} ({names})")
            names = list(columns)
        return Table(
            {n: data[n] for n in names},
            {n: data[n + NULL_SUFFIX] for n in names
             if n + NULL_SUFFIX in data.files},
        )


def iter_table_chunks(
    uri: str,
    split: str,
    columns: Optional[List[str]] = None,
    rows: int = DEFAULT_ROW_GROUP,
    shards: Optional[Sequence[int]] = None,
) -> Iterator[Table]:
    """Stream a split as tables of at most ``rows`` rows (null masks
    intact), shard by shard in index order; chunks never cross a shard."""
    for path in _select_paths(uri, split, shards):
        table = _read_shard(path, columns)
        for start in range(0, table.num_rows, rows):
            yield table.slice(start, rows)


def iter_column_chunks(
    uri: str,
    split: str,
    columns: Optional[List[str]] = None,
    rows: int = DEFAULT_ROW_GROUP,
    shards: Optional[Sequence[int]] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Stream a split as dict-of-numpy chunks of at most ``rows`` rows
    (``columns_from_table``'s null semantics)."""
    for table in iter_table_chunks(uri, split, columns, rows, shards):
        yield columns_from_table(table)


def read_split_table(
    uri: str, split: str, columns: Optional[List[str]] = None,
    shards: Optional[Sequence[int]] = None,
) -> Table:
    return concat_tables([
        _read_shard(p, columns) for p in _select_paths(uri, split, shards)
    ])


def read_split(
    uri: str, split: str, columns: Optional[List[str]] = None,
    shards: Optional[Sequence[int]] = None,
) -> Dict[str, np.ndarray]:
    """Split as a dict of numpy columns.  Strings come back as object
    arrays; vector columns as 2-D arrays; nulls as ``columns_from_table``
    gives them."""
    return columns_from_table(read_split_table(uri, split, columns, shards))


def columns_from_table(table: Table) -> Dict[str, np.ndarray]:
    """Numpy columns with the reference's null semantics: a numeric column
    with nulls becomes float64 with NaN there (what Arrow's ``to_numpy``
    gives), a string column becomes an object array with ``None`` there."""
    out: Dict[str, np.ndarray] = {}
    for name, col in table.columns.items():
        mask = table.nulls.get(name)
        if col.dtype.kind in ("U", "S", "O"):
            col = col.astype(object)
            if mask is not None:
                col[mask] = None
        elif mask is not None:
            col = col.astype(np.float64)
            col[mask] = np.nan
        out[name] = col
    return out


def table_from_columns(columns: Mapping[str, np.ndarray]) -> Table:
    """A table of numpy columns (1-D, or 2-D for fixed-length vectors)."""
    arrays = {}
    for name, arr in columns.items():
        arr = np.asarray(arr)
        if arr.ndim > 2:
            raise ValueError(
                f"column {name!r}: rank-{arr.ndim} arrays not supported; "
                "flatten trailing dims first"
            )
        arrays[name] = arr
    return Table(arrays)


def shard_row_counts(uri: str, split: str) -> List[int]:
    """Per-shard row counts, read from each shard's row-count entry (no
    column is decoded)."""
    counts = []
    for p in split_shard_paths(uri, split):
        with np.load(p, allow_pickle=False) as data:
            counts.append(int(data[_ROWS_KEY]))
    return counts


def num_rows(uri: str, split: str) -> int:
    return sum(shard_row_counts(uri, split))
