"""ExampleGen: ingest CSV, hash-split, emit an Examples artifact.

The port's ``CsvExampleGen`` (``tpu_pipelines/components/example_gen.py``,
TFX's ``CsvExampleGen``): CSV in, deterministic train/eval splits out, by
content-hash bucketing of each row.  The reference reads the file with
``pyarrow.csv`` and hashes each row's Arrow text; the port has no
``pyarrow``, so it parses with the stdlib ``csv`` module into numpy columns
and reproduces what the reference's hash sees:

  * **types** as Arrow's reader infers them for plain decimal text: int64,
    else boolean, else double, else string; a column of nulls only is
    null.  In a numeric or boolean column Arrow's null spellings (empty,
    ``NA``, ``null``, ``nan``, ...) are null; a string column keeps every
    value as text.  Hexadecimal integers and date/time text, which Arrow
    would read as numbers or timestamps, are read as strings here.
  * **text** as Arrow casts each value to a string: an int as Python
    prints it; a double in its shortest round-trip digits, positional when
    its decimal exponent is in [-6, 9] with no trailing ``.0`` (``4.0`` ->
    ``4``, ``1e-6`` -> ``0.000001``), else as ``1e-7`` / ``1.5e+10``;
    ``true`` / ``false``; a null as ``""``.  Rows join with ``\\x1f`` and
    hash with FNV-1a (``utils/hashing.py``), so a row lands in the same
    split in both packages.

``ImportExampleGen`` imports TFRecord / ArrayRecord files of
``tf.train.Example`` (parsed by ``data/record_io.py``) or an ``.npz`` of
columns.  Its hash split prints each numpy column's values as the
reference's Arrow column would (a float32 column in float32's shortest
digits, a vector column as Python prints its row's list), so the two
packages split the same rows alike.
"""

from __future__ import annotations

import csv
import itertools
import os
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from tpu_pipelines_torch.data import examples_io
from tpu_pipelines_torch.data.examples_io import Table
from tpu_pipelines_torch.data.shard_plan import ShardPlan
from tpu_pipelines_torch.dsl.component import Parameter, component
from tpu_pipelines_torch.utils.hashing import FNV_OFFSET, FNV_PRIME, fnv1a_update

DEFAULT_SPLITS = {"train": 2, "eval": 1}
# Arrow's default CSV null spellings (ConvertOptions.null_values).
NULL_VALUES = (
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "N/A", "NA", "NULL", "NaN", "n/a", "nan", "null",
)
TRUE_VALUES = ("1", "True", "TRUE", "true")
FALSE_VALUES = ("0", "False", "FALSE", "false")
# Rows per block of the streaming reader, and of the row hash.
STREAM_BLOCK_ROWS = 1 << 16
# column_types aliases the port reads (Arrow's type aliases).
_TYPE_ALIASES = {
    "int64": "int64", "double": "double", "float64": "double",
    "string": "string", "utf8": "string", "str": "string", "bool": "bool",
}


def _null_mask(raw: np.ndarray) -> np.ndarray:
    mask = np.zeros(len(raw), bool)
    for token in NULL_VALUES:
        mask |= raw == token
    return mask


def _has(raw: np.ndarray, sub: str) -> bool:
    return bool(len(raw)) and bool((np.char.find(raw, sub) >= 0).any())


def _first_parses(vals: np.ndarray, kind: str) -> bool:
    """Whether the first value parses as ``kind``: a cheap test that skips
    a whole-column attempt bound to fail."""
    if not len(vals) or kind in ("null", "string"):
        return True
    if kind == "bool":
        return str(vals[0]) in TRUE_VALUES + FALSE_VALUES
    try:
        (int if kind == "int64" else float)(str(vals[0]))
    except ValueError:
        return False
    return True


def _convert(raw: np.ndarray, kind: str, null: np.ndarray):
    """``raw`` (a ``U`` array) as a column of ``kind``; None when a value
    does not parse as that kind."""
    vals = raw[~null]
    if not _first_parses(vals, kind):
        return None
    if kind == "null":
        return np.full(len(raw), "", dtype="U1") if vals.size == 0 else None
    if kind == "string":
        return raw
    if kind == "bool":
        true = np.isin(vals, TRUE_VALUES)
        if not (true | np.isin(vals, FALSE_VALUES)).all():
            return None
        out = np.zeros(len(raw), bool)
        out[~null] = true
        return out
    if _has(vals, "_"):
        return None
    try:
        if kind == "int64":
            if _has(np.char.lstrip(vals), "+"):
                return None  # Arrow reads a signed "+3" as a double
            parsed = vals.astype(np.int64)
        else:
            parsed = vals.astype(np.float64)
    except (ValueError, OverflowError):
        return None
    out = np.zeros(len(raw), parsed.dtype)
    out[~null] = parsed
    return out


def parse_column(raw: np.ndarray, kind: Optional[str] = None):
    """``(values, null mask or None, kind)`` of one CSV column given as a
    ``U`` array; ``kind`` None infers it (null, int64, bool, double,
    string, the first that parses every non-null value)."""
    null = _null_mask(raw)
    kinds = [kind] if kind else ["null", "int64", "bool", "double", "string"]
    for k in kinds:
        col = _convert(raw, k, null if k != "string" else np.zeros_like(null))
        if col is not None:
            if k == "string":
                return col, None, k
            return col, (null if null.any() else None), k
    raise ValueError(
        f"CSV column does not parse as {kind}: "
        f"{raw[~null][:5].tolist()} ..."
    )


def _double_text(v: float, shortest=repr) -> str:
    """Arrow's text of one double (``shortest`` the digits of its type:
    ``repr`` for a double, ``str(np.float32(.))`` for a float): shortest
    round-trip digits, positional for decimal exponents in [-6, 9], else
    exponent form."""
    if v != v:
        return "nan"
    if v in (float("inf"), float("-inf")):
        return "inf" if v > 0 else "-inf"
    sign = "-" if np.signbit(v) else ""
    r = shortest(abs(v))
    if "e" in r:
        mant, exp = r.split("e")
        e = int(exp)
        digits = mant.replace(".", "")
    else:
        whole, _, frac = r.partition(".")
        digits = (whole + frac).lstrip("0")
        if not digits:
            return sign + "0"
        if whole.strip("0"):
            e = len(whole.lstrip("0")) - 1
        else:
            e = -(len(frac) - len(frac.lstrip("0")) + 1)
    digits = digits.rstrip("0") or "0"
    if -6 <= e <= 9:
        if e >= 0:
            whole = digits[:e + 1].ljust(e + 1, "0")
            frac = digits[e + 1:]
        else:
            whole, frac = "0", "0" * (-e - 1) + digits
        return sign + whole + ("." + frac if frac else "")
    mant = digits[0] + ("." + digits[1:] if len(digits) > 1 else "")
    return f"{sign}{mant}e{'+' if e > 0 else '-'}{abs(e)}"


def _float32_digits(v: float) -> str:
    return str(np.float32(v))


def arrow_text(col: np.ndarray, null: Optional[np.ndarray], kind: str) -> np.ndarray:
    """Each value of a parsed column as Arrow's string cast prints it, null
    as ``""`` (a ``U`` array)."""
    if kind in ("string", "null"):
        text = np.asarray(col, dtype="U")
    elif kind == "list":
        # A list column hashes as Python prints each row's list.
        text = np.asarray([str(row) for row in col.tolist()], dtype="U")
    elif kind == "float":
        text = np.asarray([_double_text(float(v), _float32_digits)
                           for v in col], dtype="U")
    elif kind == "int64":
        text = col.astype("U")
    elif kind == "bool":
        text = np.where(col, "true", "false")
    else:
        # numpy prints the same shortest digits, positional for
        # 1e-4 <= |v| < 1e16; there only an integral value's trailing ".0"
        # differs (printed here as the int).  The rest goes through
        # _double_text.
        a = np.abs(col)
        fast = (a == 0) | ((a >= 1e-4) & (a < 1e10))
        text = col.astype("U")
        integral = np.flatnonzero(fast & (col == np.floor(col)))
        if len(integral):
            ints = col[integral].astype(np.int64).astype("U")
            text = text.astype(f"<U{max(text.dtype.itemsize // 4, 2)}")
            text[integral] = np.where(np.signbit(col[integral]) & (
                col[integral] == 0), "-0", ints)
        slow = np.flatnonzero(~fast)
        if len(slow):
            text = text.astype(object)
            text[slow] = [_double_text(float(v)) for v in col[slow]]
            text = text.astype("U")
    if null is not None:
        text = np.where(null, "", text)
    return text


def _row_hash_buckets(table: Table, kinds: Dict[str, str],
                      num_buckets: int) -> np.ndarray:
    """Stable per-row bucket: FNV-1a of the row's Arrow text joined by
    ``\\x1f`` (the reference's ``utils/hashing.hash_buckets`` of the joined
    string), folded column by column over blocks of STREAM_BLOCK_ROWS rows."""
    sep = np.uint64(0x1F)
    out = np.empty(table.num_rows, np.int64)
    for start in range(0, table.num_rows, STREAM_BLOCK_ROWS):
        block = table.slice(start, STREAM_BLOCK_ROWS)
        h = np.full(block.num_rows, FNV_OFFSET, np.uint64)
        for i, name in enumerate(block.column_names):
            if i:
                with np.errstate(over="ignore"):
                    h = (h ^ sep) * FNV_PRIME
            h = fnv1a_update(h, arrow_text(
                block.columns[name], block.null_mask(name), kinds[name]))
        out[start:start + block.num_rows] = (
            h % np.uint64(num_buckets)).astype(np.int64)
    return out


def _read_rows(path: str) -> Iterator[List[str]]:
    with open(path, newline="", encoding="utf-8") as f:
        for row in csv.reader(f):
            if row:  # Arrow skips empty lines
                yield row


def _fast_block(path: str) -> Optional[Tuple[List[str], List[tuple]]]:
    """``(header, columns)`` of a CSV file with no quote character, split
    by ``str.split`` (no per-row Python); None when the file has quotes or
    rows of another width (then ``csv`` parses it, and names the row)."""
    with open(path, encoding="utf-8", newline="") as f:
        text = f.read()
    if '"' in text:
        return None
    lines = [line for line in text.splitlines() if line]
    if not lines:
        raise ValueError(f"CSV file {path!r} is empty")
    header, body = lines[0].split(","), lines[1:]
    width = len(header) - 1
    if any(line.count(",") != width for line in body):
        return None
    flat = ",".join(body).split(",") if body else []
    return header, [tuple(flat[j::len(header)]) for j in range(len(header))]


def _blocks(paths: List[str], block_rows: Optional[int]
            ) -> Iterator[Tuple[List[str], List[List[str]]]]:
    """``(header, rows)`` blocks of the CSV files, ``block_rows`` rows each
    (None: one block per file)."""
    for path in paths:
        rows = _read_rows(path)
        header = next(rows, None)
        if header is None:
            raise ValueError(f"CSV file {path!r} is empty")
        block: List[List[str]] = []
        for row in rows:
            if len(row) != len(header):
                raise ValueError(
                    f"{path!r}: a row has {len(row)} fields, the header "
                    f"{len(header)}: {row}"
                )
            block.append(row)
            if block_rows and len(block) == block_rows:
                yield header, block
                block = []
        if block or not block_rows:
            yield header, block


def _block_table(header: List[str], rows: List[List[str]],
                 kinds: Dict[str, str], fields=None
                 ) -> Tuple[Table, Dict[str, str]]:
    """Parse one block (its rows, or its ``fields`` column by column);
    ``kinds`` pins column types (the others are inferred).  Returns the
    table and every column's kind."""
    if fields is None:
        fields = list(zip(*rows)) if rows else [() for _ in header]
    columns, nulls, out_kinds = {}, {}, {}
    for name, values in zip(header, fields):
        raw = np.asarray(values, dtype="U") if values else np.zeros(0, "U1")
        col, null, kind = parse_column(raw, kinds.get(name))
        columns[name], out_kinds[name] = col, kind
        if null is not None:
            nulls[name] = null
    return Table(columns, nulls), out_kinds


def _split_masks(buckets: np.ndarray, splits: Dict[str, int]
                 ) -> Dict[str, np.ndarray]:
    out, lo = {}, 0
    for split, weight in splits.items():
        out[split] = (buckets >= lo) & (buckets < lo + weight)
        lo += weight
    return out


def _split_and_write(table: Table, kinds: Dict[str, str], uri: str,
                     splits: Dict[str, int], num_shards: int) -> Dict[str, int]:
    buckets = _row_hash_buckets(table, kinds, sum(splits.values()))
    counts = {}
    for split, mask in _split_masks(buckets, splits).items():
        sub = table.take(mask)
        examples_io.write_split(uri, split, sub, num_shards=num_shards)
        counts[split] = sub.num_rows
    return counts


def _parsed_blocks(blocks, kinds: Dict[str, str], path: str
                   ) -> Iterator[Tuple[Table, Dict[str, str]]]:
    """CSV blocks as ``(table, kinds)``; column types are pinned from the
    first block (Arrow's streaming reader does the same)."""
    for header, rows in blocks:
        try:
            table, block_kinds = _block_table(header, rows, kinds)
        except ValueError as e:
            raise ValueError(
                f"streaming CSV ingest of {path!r} failed mid-stream: "
                f"{e}\nThe streaming reader pins column types from the "
                "first block. If a column's type shifts deeper in the "
                "file (or across files), pin it explicitly via the "
                "column_types parameter, e.g. column_types={'fare': "
                "'float64'}; whole-file reads (below "
                "streaming_threshold_bytes) infer from every row instead."
            ) from e
        kinds = block_kinds
        yield table, kinds


def _split_and_write_streaming(tables, uri: str, splits: Dict[str, int],
                               num_shards: int) -> Dict[str, int]:
    """Hash-split a stream of ``(table, kinds)`` chunks; chunk i goes to
    shard i % num_shards of every split.  Every writer opens with the
    first chunk, so empty splits and shards still materialize."""
    counts = {s: 0 for s in splits}
    writers = None
    try:
        for i, (table, kinds) in enumerate(tables):
            if writers is None:
                writers = {
                    split: [examples_io.open_split_writer(
                        uri, split, table, shard=w, num_shards=num_shards)
                        for w in range(num_shards)]
                    for split in splits
                }
            buckets = _row_hash_buckets(table, kinds, sum(splits.values()))
            for split, mask in _split_masks(buckets, splits).items():
                sub = table.take(mask)
                if sub.num_rows:
                    writers[split][i % num_shards].write_table(sub)
                counts[split] += sub.num_rows
    finally:
        for ws in (writers or {}).values():
            for w in ws:
                w.close()
    return counts


def _pinned_kinds(column_types: Optional[Dict[str, str]]) -> Dict[str, str]:
    kinds = {}
    for name, alias in (column_types or {}).items():
        if alias not in _TYPE_ALIASES:
            raise ValueError(
                f"column_types[{name!r}] = {alias!r}: the port reads "
                f"{sorted(_TYPE_ALIASES)}"
            )
        kinds[name] = _TYPE_ALIASES[alias]
    return kinds


def read_csv(paths: List[str], column_types=None) -> Tuple[Table, Dict[str, str]]:
    """Whole-file read of one or more CSV files with one header layout:
    types inferred over every row."""
    kinds = _pinned_kinds(column_types)
    fast = _fast_block(paths[0]) if len(paths) == 1 else None
    if fast is not None:
        return _block_table(fast[0], [], kinds, fields=fast[1])
    header, rows = None, []
    for h, block in _blocks(paths, None):
        if header is not None and h != header:
            raise ValueError(f"CSV headers differ: {header} vs {h}")
        header = h
        rows.extend(block)
    return _block_table(header, rows, kinds)


def _resolve_span(ctx):
    """``input_path`` with ``{SPAN}`` / ``{VERSION}`` resolved
    (``utils/span.py``), and the span and version chosen (None when the
    path has no pattern)."""
    from tpu_pipelines_torch.utils.span import (
        has_span_pattern,
        resolve_span_pattern,
    )

    path = ctx.exec_properties["input_path"]
    if not has_span_pattern(path):
        return path, None, None
    return resolve_span_pattern(
        path,
        ctx.exec_properties.get("span"),
        ctx.exec_properties.get("version"),
    )


def _stamp_span(out, props, span, version):
    """The chosen span and version on the Examples artifact and on the
    execution's properties; returns ``props``."""
    for key, value in (("span", span), ("version", version)):
        if value is not None:
            out.properties[key] = value
            props[key] = value
    return props


@component(
    outputs={"examples": "Examples"},
    parameters={
        "input_path": Parameter(type=str, required=True),
        # {"train": 2, "eval": 1} -> 2/3 train, 1/3 eval by content hash.
        "splits": Parameter(type=dict, default=None),
        # Files above this many bytes stream in blocks into per-split
        # writers instead of being read whole.  0 = always stream.
        "streaming_threshold_bytes": Parameter(type=int, default=256 << 20),  # tpp: disable=TPP214 (parameter)
        # Optional {column: type alias} (int64, float64, string, bool).
        # The streaming reader infers types from its FIRST block only, so
        # pin any column whose type could shift deeper into a large file.
        "column_types": Parameter(type=dict, default=None),
        # Span/version selection: when input_path contains "{SPAN}" (and
        # optionally "{VERSION}"), the highest numbered match ingests
        # unless pinned here.
        "span": Parameter(type=int, default=None),
        "version": Parameter(type=int, default=None),
        # Shard files per split.  None follows the ShardPlan precedence:
        # TPP_DATA_SHARDS env, else host_cpus.  Split membership is the
        # per-row content hash at every shard count.
        "num_shards": Parameter(type=int, default=None),
    },
    external_input_parameters=("input_path",),
)
def CsvExampleGen(ctx):
    """Read CSV file(s), hash-split, write ``.npz`` shards; streaming when
    large."""
    path, span, version = _resolve_span(ctx)
    splits = ctx.exec_properties["splits"] or dict(DEFAULT_SPLITS)
    threshold = ctx.exec_properties["streaming_threshold_bytes"]  # tpp: disable=TPP214 (parameter)
    plan = ShardPlan.resolve(ctx.exec_properties.get("num_shards"))
    column_types = ctx.exec_properties["column_types"]
    if os.path.isdir(path):
        files = sorted(
            os.path.join(path, f) for f in os.listdir(path) if f.endswith(".csv")
        )
        if not files:
            raise ValueError(f"no .csv files under {path!r}")
    else:
        files = [path]
    out = ctx.output("examples")
    t0 = time.monotonic()
    total_bytes = sum(os.path.getsize(f) for f in files)
    if total_bytes > threshold:
        counts = _split_and_write_streaming(
            _parsed_blocks(_blocks(files, STREAM_BLOCK_ROWS),
                           _pinned_kinds(column_types), path),
            out.uri, splits, plan.num_shards,
        )
    else:
        table, kinds = read_csv(files, column_types)
        counts = _split_and_write(
            table, kinds, out.uri, splits, plan.num_shards
        )
    out.properties["split_names"] = sorted(counts)
    out.properties["split_counts"] = counts
    out.properties["num_shards"] = plan.num_shards
    n = sum(counts.values())
    elapsed = max(1e-9, time.monotonic() - t0)
    props = {
        "num_examples": n,
        "ingest_rows_per_sec": round(n / elapsed, 1),
        "data_shards": plan.num_shards,
        "shard_plan_source": plan.source,
        **{f"rows_{k}": v for k, v in counts.items()},
    }
    return _stamp_span(out, props, span, version)


RECORD_SUFFIXES = (".tfrecord", ".tfrecords", ".array_record", ".arrayrecord")


def column_kinds(table: Table) -> Dict[str, str]:
    """The Arrow type each numpy column stands for, by dtype: what the
    row hash needs to print its values as the reference's Arrow columns."""
    kinds = {}
    for name, col in table.columns.items():
        if col.ndim > 1:
            kinds[name] = "list"
        elif col.dtype.kind in ("U", "S", "O"):
            kinds[name] = "string"
        elif col.dtype == np.float32:
            kinds[name] = "float"
        elif col.dtype.kind == "f":
            kinds[name] = "double"
        elif col.dtype == bool:
            kinds[name] = "bool"
        else:
            kinds[name] = "int64"
    return kinds


def _record_reader(path: str, verify_crc: bool = True):
    from tpu_pipelines_torch.data import record_io

    if path.endswith((".array_record", ".arrayrecord")):
        return record_io.iter_array_records(path)
    return record_io.iter_tfrecords(path, verify_crc=verify_crc)


def _import_record_files(files, out_uri: str, splits: Dict[str, int],
                         per_split: bool, verify_crc: bool = True,
                         num_shards: int = 1) -> Dict[str, int]:
    """tf.train.Example record files -> ``.npz`` splits, O(chunk) memory.

    ``per_split=True``: each file is a split (``<split>.tfrecord``), one
    shard each.  Otherwise all files concatenate and hash-split row by row,
    as the CSV path does."""
    from tpu_pipelines_torch.data import record_io

    def tables(path):
        return record_io.tf_example_batches(_record_reader(path, verify_crc))

    counts: Dict[str, int] = {}
    if per_split:
        stems = [os.path.splitext(os.path.basename(f))[0] for f in files]
        dupes = sorted({s for s in stems if stems.count(s) > 1})
        if dupes:
            raise ValueError(
                f"multiple record files map to the same split name(s) "
                f"{dupes} (e.g. train.tfrecord + train.tfrecords); "
                "one file per split"
            )
        for f, split in zip(files, stems):
            writer = None
            counts[split] = 0
            try:
                for table in tables(f):
                    if writer is None:
                        writer = examples_io.open_split_writer(
                            out_uri, split, table)
                    writer.write_table(table)
                    counts[split] += table.num_rows
            finally:
                if writer is not None:
                    writer.close()
            if writer is None:
                raise ValueError(f"record file {f!r} is empty")
        return counts

    stream = ((t, column_kinds(t)) for f in files for t in tables(f))
    first = next(stream, None)
    if first is None:
        raise ValueError(f"no records in {files!r}")
    return _split_and_write_streaming(
        itertools.chain([first], stream), out_uri, splits, num_shards
    )


@component(
    outputs={"examples": "Examples"},
    parameters={
        # A directory of <split>.tfrecord / <split>.array_record files, a
        # single record file, or an .npz file whose arrays are columns
        # (dims beyond the second are flattened into fixed-length vector
        # columns).  "{SPAN}" / "{VERSION}" resolve as in CsvExampleGen.
        "input_path": Parameter(type=str, required=True),
        "splits": Parameter(type=dict, default=None),
        # TFRecord masked-crc32c verification (data/record_io.py).  False
        # is the trusted-source opt-out, also the way past third-party
        # writers that zero or mis-mask the crc fields.
        "verify_record_crc": Parameter(type=bool, default=True),
        # Shard files per split for the hash-split paths (ShardPlan
        # precedence, see CsvExampleGen).  The split-per-file import keeps
        # one file per split: the import is the layout there.
        "num_shards": Parameter(type=int, default=None),
        "span": Parameter(type=int, default=None),
        "version": Parameter(type=int, default=None),
    },
    external_input_parameters=("input_path",),
)
def ImportExampleGen(ctx):
    """Import already-materialized data as an Examples artifact.

    Accepted layouts (the reference's, less Parquet):
      - a directory of ``<split>.tfrecord`` / ``.array_record`` files of
        ``tf.train.Example`` payloads: parsed split per file;
      - a single record file: parsed, then hash-split like CsvExampleGen;
      - a single ``.npz``: its columns hash-split like CsvExampleGen.
    A directory of ``<split>.parquet`` files raises: the port's Examples
    are ``.npz`` shards and it reads no Parquet (``ROADMAP.md`` C).
    """
    path, span, version = _resolve_span(ctx)
    out = ctx.output("examples")
    plan = ShardPlan.resolve(ctx.exec_properties.get("num_shards"))
    verify_crc = ctx.exec_properties["verify_record_crc"]
    splits = ctx.exec_properties["splits"] or dict(DEFAULT_SPLITS)
    t0 = time.monotonic()
    if os.path.isdir(path):
        names = sorted(os.listdir(path))
        if any(f.endswith(".parquet") for f in names):
            raise NotImplementedError(
                f"{path!r} holds .parquet files: the port's Examples are "
                ".npz shards and it reads no Parquet (ROADMAP.md C, the "
                "Examples format); import TFRecords or an .npz instead"
            )
        record_files = [f for f in names if f.endswith(RECORD_SUFFIXES)]
        if not record_files:
            raise ValueError(f"no record files under {path!r}")
        counts = _import_record_files(
            [os.path.join(path, f) for f in record_files], out.uri, {},
            per_split=True, verify_crc=verify_crc,
        )
    elif path.endswith(RECORD_SUFFIXES):
        counts = _import_record_files(
            [path], out.uri, splits, per_split=False, verify_crc=verify_crc,
            num_shards=plan.num_shards,
        )
    elif path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as data:
            columns = {}
            for name in data.files:
                arr = data[name]
                if arr.ndim > 2:
                    arr = arr.reshape(arr.shape[0], -1)
                columns[name] = arr
        table = Table(columns)
        counts = _split_and_write(
            table, column_kinds(table), out.uri, splits, plan.num_shards
        )
    else:
        raise ValueError(f"unsupported import source: {path!r}")
    out.properties["split_names"] = sorted(counts)
    out.properties["split_counts"] = counts
    n = sum(counts.values())
    props = {
        "num_examples": n,
        "ingest_rows_per_sec": round(
            n / max(1e-9, time.monotonic() - t0), 1
        ),
        "data_shards": plan.num_shards,
        "shard_plan_source": plan.source,
    }
    return _stamp_span(out, props, span, version)
