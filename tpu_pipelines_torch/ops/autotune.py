"""Kernel autotuning on the card: measured block configurations and the
flash-vs-dense crossovers "auto" attention reads.  The port of
``tpu_pipelines/ops/autotune.py``, both halves.

Block configurations.  Per ``(op, batch*heads bucket, seq_len, head_dim,
dtype, causal, device_kind)`` key (:func:`make_key`, :func:`key_id`: the
reference's encoding, so both packages derive byte-identical ids for one
shape), the table holds the winning ``(block_q, block_k)`` of a timed
sweep over the pairs the CUDA kernels are built for (ops ``flash_fwd`` and
``flash_bwd``, tuned independently; ``flash_decode`` over ``block_k``).
:func:`get_block_config` answers ``flash_attention`` and
``flash_decode_attention`` (``ops/flash_attention.py resolve_blocks`` /
``resolve_decode_block``).  ``TPP_AUTOTUNE`` has the reference's modes:

  * ``cache-only`` (default): consult the table, never time anything;
  * ``sweep``: on a miss, sweep on the card and record the winners, but
    never while the current stream captures a CUDA graph (the counterpart
    of the reference's guard against timing inside a jit trace);
  * ``0`` / ``off``: bypass the table (the 64 x 64 defaults).

The card's rules replace the TPU's (:func:`valid_pairs`): a block pair is
valid iff the kernels are built for it at the dtype and head dim and its
tiles fit the 227 KB of shared memory a block may opt into; there is no
L-divisibility rule, since the kernels mask ragged keys.
:func:`clamp_block` gives the largest valid block at or below a request
and raises, listing the valid blocks, when there is none (the reference
clamps to a divisor of L).  ``TPP_AUTOTUNE_BLOCKS`` ("64x128,128x64")
overrides the candidates and ``TPP_AUTOTUNE_ITERS`` the launches timed per
candidate, as in the reference.  A sweep runs only on CUDA tensors: one of
a CPU tensor raises (the plain versions are never timed).  Lookups and
sweeps are counted in the port's metrics registry under the reference's
names: ``autotune_cache_hits_total``, ``autotune_cache_misses_total``,
``autotune_sweeps_total`` (each labelled by op) and the
``autotune_sweep_latency_seconds`` histogram.

Crossovers.
Per device kind (the card's name, ``torch.cuda.get_device_name``, e.g.
"NVIDIA H100 80GB HBM3"; "cpu" for the CPU) the table also holds two
measured lengths:

  * the training-regime crossover: the first sequence length at which the
    flash kernels (forward and backward) take no longer than dense
    attention.  ``models/transformer.py choose_attn_impl`` picks flash at
    or above it, dense below it, and flash wherever dense cannot fit;
  * the decode-regime crossover: the first KV-cache length at which the
    flash-decode kernel takes no longer than dense cache attention
    (``choose_decode_impl``).

Each has three states: a measured crossover; "measured none" (recorded as
null: dense won at every measured length where it fits), which shadows
the committed table; and "never measured" (no record), which also means
dense.  ``chip_smoke.py``'s crossover phase measures both on the card and
records them.

Storage, byte-compatible with the reference's table format (so either
package reads the other's file for the same kind):

  * user cache ``~/.cache/tpu_pipelines_torch/autotune/<kind>.json``
    (``TPP_AUTOTUNE_CACHE`` overrides the directory), written by
    :func:`record_entry`, :func:`record_crossover` and
    :func:`record_decode_crossover` under a cross-process ``FileLock``,
    atomically;
  * the committed table ``ops/autotune_table.json``: winners and
    crossovers measured on the card and promoted into the repo, so a fresh
    checkout starts with them.  User-cache records shadow committed ones.

Reads are tolerant (a missing, torn or corrupt file reads as ``{}``) and
memoized by (mtime, size), so a lookup inside a CUDA-graph capture is a
``stat`` and a dict read, never a device call.  :func:`get_block_config`
keeps each shape's answer per state of the two tables, so an eager caller
moves the counters once per shape, as the reference's jit does once per
trace.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from tpu_pipelines_torch.robustness.atomic import (
    FileLock,
    atomic_write_json,
    load_json_tolerant,
)
from tpu_pipelines_torch.utils.fingerprint import fingerprint_json

ENV_MODE = "TPP_AUTOTUNE"
ENV_CACHE_DIR = "TPP_AUTOTUNE_CACHE"
ENV_BLOCKS = "TPP_AUTOTUNE_BLOCKS"      # "64x128,128x64" candidate override
ENV_ITERS = "TPP_AUTOTUNE_ITERS"

MODE_OFF = "off"
MODE_CACHE_ONLY = "cache-only"
MODE_SWEEP = "sweep"

# The decode kernel takes one query row: its entries record block_q 1.
DECODE_BLOCK_Q = 1
# Host time a timed launch may take at most before the device runs dry:
# the timed launches queue behind a device sleep this long a launch.
_HOST_S_PER_LAUNCH = 5e-4

_TABLE_VERSION = 1
_COMMITTED_TABLE = os.path.join(os.path.dirname(__file__), "autotune_table.json")


# ------------------------------------------------------------------- keys


def autotune_mode() -> str:
    """Effective mode from ``TPP_AUTOTUNE`` (unset: cache-only)."""
    raw = os.environ.get(ENV_MODE, MODE_CACHE_ONLY).strip().lower()
    if raw in ("0", "off", "false", "none"):
        return MODE_OFF
    if raw == MODE_SWEEP:
        return MODE_SWEEP
    return MODE_CACHE_ONLY


def current_device_kind(device: Any = None) -> str:
    """The kind tables are keyed by: the card's name for a CUDA device
    (read from the properties torch caches, no device call), "cpu" for
    the CPU.  ``device=None`` is the current CUDA device when there is
    one, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        return str(torch.cuda.get_device_properties(dev).name)
    return dev.type


def dtype_name(dtype: Any) -> str:
    """The dtype as the reference's keys spell it ("bfloat16", not
    "torch.bfloat16")."""
    return str(dtype).replace("torch.", "")


def _next_pow2(n: int) -> int:
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


def make_key(
    op: str,
    batch: int,
    heads: int,
    seq_len: int,
    head_dim: int,
    dtype: Any,
    causal: bool,
    device_kind: Optional[str] = None,
) -> Dict[str, Any]:
    """Canonical lookup key for one tuned kernel instance, as the
    reference's: ``batch * heads`` bucketed to the next power of two (it
    only sets the grid's parallel dimension), ``seq_len`` exact."""
    return {
        "op": str(op),
        "bh_bucket": _next_pow2(batch * heads),
        "seq_len": int(seq_len),
        "head_dim": int(head_dim),
        "dtype": dtype_name(dtype),
        "causal": bool(causal),
        "device_kind": device_kind or current_device_kind(),
    }


def key_id(key: Dict[str, Any]) -> str:
    """Process-stable table id: the canonical JSON encoding hashed, byte
    for byte the reference's."""
    return fingerprint_json(key)[:16]


@functools.lru_cache(maxsize=4096)
def _shape_key_id(op, batch, heads, seq_len, head_dim, dtype, causal, kind):
    return key_id(make_key(op, batch, heads, seq_len, head_dim, dtype, causal,
                           kind))


# ------------------------------------------------------------------ tables


def cache_dir() -> str:
    env = os.environ.get(ENV_CACHE_DIR)
    if env:
        return env
    return os.path.join(
        os.path.expanduser("~"), ".cache", "tpu_pipelines_torch", "autotune"
    )


def cache_path(device_kind: Optional[str] = None) -> str:
    kind = (device_kind or current_device_kind()).replace(" ", "_")
    return os.path.join(cache_dir(), f"{kind}.json")


_table_memo: Dict[str, Tuple[Tuple[float, int], Dict[str, Any]]] = {}


def _load_table(path: str) -> Dict[str, Any]:
    """Tolerant, mtime-memoized table read ({} for absent/corrupt/torn:
    a damaged cache must never take down a run)."""
    try:
        st = os.stat(path)
        stamp = (st.st_mtime, st.st_size)
    except OSError:
        return {}
    memo = _table_memo.get(path)
    if memo is not None and memo[0] == stamp:
        return memo[1]
    data = load_json_tolerant(path)
    if not isinstance(data, dict):
        data = {}
    _table_memo[path] = (stamp, data)
    return data


def clear_memo() -> None:
    """Drop in-process table memos and resolved blocks (tests repoint the
    cache dir)."""
    _table_memo.clear()
    _resolved.clear()
    _stamps.clear()


# A table's (mtime, size) as last read, and when: the resolved blocks are
# checked against it at most every _RESTAT_S seconds (an eager decode loop
# asks for every launch; a stat each time cost seconds of host time a
# phase on the card's host).  This process's own writes drop it at once.
_RESTAT_S = 1.0
_stamps: Dict[str, Tuple[float, Optional[Tuple[int, int]]]] = {}


def _stamp(path: str) -> Optional[Tuple[int, int]]:
    now = time.monotonic()
    seen = _stamps.get(path)
    if seen is not None and now - seen[0] < _RESTAT_S:
        return seen[1]
    try:
        st = os.stat(path)
        stamp: Optional[Tuple[int, int]] = (st.st_mtime_ns, st.st_size)
    except OSError:
        stamp = None
    _stamps[path] = (now, stamp)
    return stamp


def _lookup_entry(kid: str, device_kind: Optional[str] = None
                  ) -> Optional[Dict[str, Any]]:
    """User cache first (freshly swept winners shadow the committed table),
    then the committed table."""
    for path in (cache_path(device_kind), _COMMITTED_TABLE):
        entry = (_load_table(path).get("entries") or {}).get(kid)
        if isinstance(entry, dict):
            return entry
    return None


def _update_table(path: str, mutate) -> None:
    """Read-modify-write under the cross-process lock, atomically."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with FileLock(path + ".lock"):
        table = load_json_tolerant(path)
        if not isinstance(table, dict):
            table = {}
        table.setdefault("version", _TABLE_VERSION)
        table.setdefault("entries", {})
        table.setdefault("crossover", {})
        mutate(table)
        atomic_write_json(path, table)
    _table_memo.pop(path, None)
    _stamps.pop(path, None)


def record_entry(
    key: Dict[str, Any],
    block_q: int,
    block_k: int,
    ms: float,
    swept: Optional[Sequence[Dict[str, Any]]] = None,
    source: str = "sweep",
) -> str:
    """Persist one winner into the user cache; returns its table id."""
    kid = key_id(key)

    def mutate(table):
        table["entries"][kid] = {
            "key": key,
            "block_q": int(block_q),
            "block_k": int(block_k),
            "ms": round(float(ms), 4),
            "swept": list(swept or []),
            "source": source,
        }

    _update_table(cache_path(key.get("device_kind")), mutate)
    return kid


# -------------------------------------------------------------- crossover


def _record(section: str, field: str, device_kind: str,
            length: Optional[int], geometry, source: str) -> None:
    def mutate(table):
        table.setdefault(section, {})[device_kind] = {
            field: int(length) if length is not None else None,
            "geometry": geometry or {},
            "source": source,
        }

    _update_table(cache_path(device_kind), mutate)


def _lookup(section: str, field: str, device_kind: Optional[str]) -> Optional[int]:
    kind = device_kind or current_device_kind()
    for path in (cache_path(kind), _COMMITTED_TABLE):
        rec = (_load_table(path).get(section) or {}).get(kind)
        if isinstance(rec, dict):
            v = rec.get(field)
            return int(v) if v is not None else None
    return None


def record_crossover(
    device_kind: str,
    crossover_seq_len: Optional[int],
    geometry: Optional[Dict[str, Any]] = None,
    source: str = "measured",
) -> None:
    """Store the measured flash-vs-dense crossover for one device kind.
    ``None`` records "measured none" (dense won wherever it fits)."""
    _record("crossover", "crossover_seq_len", device_kind, crossover_seq_len,
            geometry, source)


def lookup_crossover(device_kind: Optional[str] = None) -> Optional[int]:
    """Measured crossover sequence length for this kind; None when never
    measured or measured none."""
    return _lookup("crossover", "crossover_seq_len", device_kind)


def record_decode_crossover(
    device_kind: str,
    crossover_kv_len: Optional[int],
    geometry: Optional[Dict[str, Any]] = None,
    source: str = "measured",
) -> None:
    """Store the measured flash-decode-vs-dense crossover cache length.
    ``None`` records "measured none" (dense won at every measured length)."""
    _record("decode_crossover", "crossover_kv_len", device_kind,
            crossover_kv_len, geometry, source)


def lookup_decode_crossover(device_kind: Optional[str] = None) -> Optional[int]:
    """Measured decode crossover KV length for this kind; None when never
    measured or measured none."""
    return _lookup("decode_crossover", "crossover_kv_len", device_kind)


def committed_crossovers() -> Dict[str, int]:
    """device_kind -> training crossover from the committed table only."""
    out: Dict[str, int] = {}
    for kind, rec in (_load_table(_COMMITTED_TABLE).get("crossover") or {}).items():
        if isinstance(rec, dict) and rec.get("crossover_seq_len") is not None:
            out[str(kind)] = int(rec["crossover_seq_len"])
    return out


# ----------------------------------------------------------------- metrics


_metric_memo: List[Any] = [None, None]   # [registry, its four metrics]


def _metrics():
    """The four metrics, registered once per registry."""
    from tpu_pipelines_torch.observability.metrics import default_registry

    reg = default_registry()
    if _metric_memo[0] is not reg:
        _metric_memo[:] = [reg, _register(reg)]
    return _metric_memo[1]


def _register(reg):
    return (
        reg.counter(
            "autotune_cache_hits_total",
            "Autotune table lookups answered from cache", ("op",),
        ),
        reg.counter(
            "autotune_cache_misses_total",
            "Autotune table lookups with no stored winner", ("op",),
        ),
        reg.counter(
            "autotune_sweeps_total",
            "Candidate-grid sweeps executed (timed on device)", ("op",),
        ),
        reg.histogram(
            "autotune_sweep_latency_seconds",
            "Wall-clock cost of one candidate-grid sweep", ("op",),
        ),
    )


# -------------------------------------------------------------- candidates


def valid_pairs(op: str, dtype: Any, head_dim: int) -> List[Tuple[int, int]]:
    """The (block_q, block_k) pairs valid for ``op`` at ``dtype`` and
    ``head_dim`` on the card: those its kernels are built for whose tiles
    fit the shared memory a block may opt into (``flash_decode``: block_q
    1 against each built ``block_k``)."""
    from tpu_pipelines_torch.ops import flash_attention as fa

    if op == "flash_decode":
        return [(DECODE_BLOCK_Q, bk) for bk in fa.built_decode_blocks(dtype, head_dim)]
    return fa.built_blocks(op, dtype, head_dim)


def valid_blocks(op: str, dtype: Any, head_dim: int,
                 what: str = "block_k") -> List[int]:
    """The valid edges of one axis (``what``: block_q, block_k or their
    bwd_ names) among :func:`valid_pairs`; the pairs are every combination
    of them."""
    axis = 0 if what.endswith("block_q") else 1
    return sorted({pair[axis] for pair in valid_pairs(op, dtype, head_dim)})


def clamp_block(op: str, dtype: Any, head_dim: int, requested: int,
                what: str = "block") -> int:
    """Largest valid block at or below ``requested`` for ``what`` of
    ``op``; raises with the valid blocks listed when there is none."""
    requested = int(requested)
    valid = valid_blocks(op, dtype, head_dim, what)
    fit = [c for c in valid if c <= requested]
    if not fit:
        raise ValueError(
            f"{op}: no valid {what} <= {requested} for {dtype_name(dtype)} at "
            f"head_dim {head_dim} (the blocks the kernels are built for whose "
            f"tiles fit shared memory; valid: {valid})"
        )
    return fit[-1]


def candidate_pairs(op: str, dtype: Any, head_dim: int) -> List[Tuple[int, int]]:
    """The sweep's grid for ``op``: :func:`valid_pairs`, or the pairs
    ``TPP_AUTOTUNE_BLOCKS`` names ("64x128,128x64"; for ``flash_decode``
    each pair's block_k), as given."""
    env = os.environ.get(ENV_BLOCKS)
    if not env:
        return valid_pairs(op, dtype, head_dim)
    pairs = []
    for tok in env.split(","):
        tok = tok.strip().lower()
        if not tok:
            continue
        bq_s, _, bk_s = tok.partition("x")
        pairs.append((int(bq_s), int(bk_s or bq_s)))
    if op == "flash_decode":
        pairs = [(DECODE_BLOCK_Q, bk) for _, bk in pairs]
    return pairs


# ------------------------------------------------------------------ timing


def time_launches(fn: Callable[[], Any], iters: int) -> float:
    """Device ms per call of ``fn`` on the current stream: one warm call,
    then ``iters`` calls chained on the stream behind a device sleep that
    outlasts their host enqueue (so the events bracket back-to-back device
    work), one pair of CUDA events and one synchronize at the end.  Timed
    again behind a longer sleep if the enqueue outran it."""
    fn()  # builds, sets the shared-memory attribute, first launch
    sleep_s = iters * _HOST_S_PER_LAUNCH
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_s * 2e9))  # cycles at up to 2 GHz
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_s = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        if host_s < sleep_s:
            return start.elapsed_time(end) / iters
        sleep_s = 2 * host_s


def _sweep_iters() -> int:
    try:
        return max(1, int(os.environ.get(ENV_ITERS, "10")))
    except ValueError:
        return 10


def _sweep_device(device: Any, op: str) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(
            f"autotune: a {op} sweep times the CUDA kernels; it cannot run on "
            f"device {dev}"
        )
    return dev


def _timed_grid(pairs, valid, measure) -> Dict[str, Any]:
    """Time ``measure(bq, bk)`` for each pair; a pair not in ``valid`` (an
    override naming an unbuilt pair) gets an error row."""
    swept: List[Dict[str, Any]] = []
    for bq, bk in pairs:
        row: Dict[str, Any] = {"block_q": bq, "block_k": bk}
        if (bq, bk) in valid:
            row["ms"] = round(measure(bq, bk), 4)
        else:
            row["error"] = f"not a valid block pair here (valid: {valid})"
        swept.append(row)
    timed = [r for r in swept if "ms" in r]
    best = min(timed, key=lambda r: r["ms"]) if timed else None
    return {"best": best, "swept": swept}


def sweep_flash(
    batch: int,
    heads: int,
    seq_len: int,
    head_dim: int,
    dtype: Any,
    causal: bool,
    device: Any = "cuda",
    pairs: Optional[Sequence[Tuple[int, int]]] = None,
    iters: Optional[int] = None,
    timer: Callable[[Callable[[], Any], int], float] = time_launches,
) -> Dict[str, Dict[str, Any]]:
    """Time every candidate (block_q, block_k) of the flash forward and,
    independently, of the backward (Dvec, dq and dk/dv from one forward at
    the default blocks, held fixed as the reference's backward leg holds
    its forward); returns ``{"flash_fwd": {best, swept}, "flash_bwd":
    {...}}``."""
    from tpu_pipelines_torch.ops import flash_attention as fa

    dev = _sweep_device(device, "flash")
    iters = iters if iters is not None else _sweep_iters()
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (batch, seq_len, heads, head_dim)
    q, k, v, dout = (torch.randn(shape, generator=gen, device=dev, dtype=dtype)
                     for _ in range(4))
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal)

    def fwd(bq, bk):
        return timer(lambda: fa.flash_attention_forward(
            q, k, v, causal=causal, block_q=bq, block_k=bk), iters)

    def bwd(bq, bk):
        return timer(lambda: fa.flash_attention_backward(
            q, k, v, out, lse, dout, causal=causal, block_q=bq, block_k=bk),
            iters)

    results = {}
    for op, measure in (("flash_fwd", fwd), ("flash_bwd", bwd)):
        grid = pairs if pairs is not None else candidate_pairs(op, dtype, head_dim)
        results[op] = _timed_grid(grid, valid_pairs(op, dtype, head_dim), measure)
    return results


def sweep_decode(
    batch: int,
    heads: int,
    kv_len: int,
    head_dim: int,
    dtype: Any,
    device: Any = "cuda",
    pairs: Optional[Sequence[Tuple[int, int]]] = None,
    iters: Optional[int] = None,
    timer: Callable[[Callable[[], Any], int], float] = time_launches,
) -> Dict[str, Dict[str, Any]]:
    """Time each candidate ``block_k`` of the decode kernel (one query row
    per (batch, head) against a ``kv_len`` cache, every key valid); returns
    ``{"flash_decode": {best, swept}}`` with block_q 1."""
    from tpu_pipelines_torch.ops import flash_attention as fa

    dev = _sweep_device(device, "flash_decode")
    iters = iters if iters is not None else _sweep_iters()
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((batch, 1, heads, head_dim), generator=gen, device=dev,
                    dtype=dtype)
    k, v = (torch.randn((batch, kv_len, heads, head_dim), generator=gen,
                        device=dev, dtype=dtype) for _ in range(2))

    def measure(_, bk):
        return timer(lambda: fa.flash_decode_attention(q, k, v, block_k=bk), iters)

    grid = (pairs if pairs is not None
            else candidate_pairs("flash_decode", dtype, head_dim))
    grid = [(DECODE_BLOCK_Q, bk) for _, bk in grid]
    return {"flash_decode": _timed_grid(
        grid, valid_pairs("flash_decode", dtype, head_dim), measure)}


# Resolved blocks per (key id, the tables' paths and stamps): an eager
# caller resolves each shape once, as the reference does once per trace,
# so each counter moves once per shape and table state (another process's
# record is seen within _RESTAT_S).  A miss in sweep mode is not kept: a
# later call (outside a capture) sweeps it.
_resolved: Dict[Tuple[Any, ...], Optional[Tuple[int, int]]] = {}


def _resolved_key(kid: str, kind: str) -> Tuple[Any, ...]:
    user = cache_path(kind)
    return (kid, user, _stamp(user), _COMMITTED_TABLE, _stamp(_COMMITTED_TABLE))


def _capturing(device: torch.device) -> bool:
    return (device.type == "cuda"
            and torch.cuda.is_current_stream_capturing())


# ---------------------------------------------------------------- dispatch


def get_block_config(
    op: str,
    batch: int,
    heads: int,
    seq_len: int,
    head_dim: int,
    dtype: Any,
    causal: bool,
    device: Any = None,
) -> Optional[Tuple[int, int]]:
    """The tuned (block_q, block_k) for one kernel instance on ``device``
    (the card's name keys it), or None when the caller should take its
    defaults.

    ``off`` bypasses the table; ``cache-only`` answers from it and never
    times anything; ``sweep`` sweeps on a miss and records every swept op's
    winner (a ``flash_fwd`` or ``flash_bwd`` miss sweeps both), unless the
    current stream is capturing a CUDA graph (the port's counterpart of the
    reference's ``allow_sweep=False`` under a trace).  A shape with a
    symbolic dim (``torch.export`` of a dynamic
    batch) has no key: the caller takes its defaults."""
    mode = autotune_mode()
    if mode == MODE_OFF or not all(
            isinstance(x, int) for x in (batch, heads, seq_len, head_dim)):
        return None
    dev = torch.device(device if device is not None
                       else ("cuda" if torch.cuda.is_available() else "cpu"))
    kind = current_device_kind(dev)
    kid = _shape_key_id(op, batch, heads, seq_len, head_dim, dtype_name(dtype),
                        bool(causal), kind)
    memo = _resolved_key(kid, kind)
    if memo in _resolved and (_resolved[memo] is not None or mode != MODE_SWEEP):
        return _resolved[memo]
    hits, misses, sweeps, latency = _metrics()
    entry = _lookup_entry(kid, kind)
    if entry is not None:
        hits.labels(op).inc()
        _resolved[memo] = int(entry["block_q"]), int(entry["block_k"])
        return _resolved[memo]
    misses.labels(op).inc()
    if mode != MODE_SWEEP:
        _resolved[memo] = None
        return None
    if _capturing(dev):
        return None
    t0 = time.perf_counter()
    if op == "flash_decode":
        swept = sweep_decode(batch, heads, seq_len, head_dim, dtype, dev)
    else:
        swept = sweep_flash(batch, heads, seq_len, head_dim, dtype, causal, dev)
    elapsed = time.perf_counter() - t0
    out: Optional[Tuple[int, int]] = None
    for swept_op, res in swept.items():
        best = res.get("best")
        if best is None:
            continue
        record_entry(
            make_key(swept_op, batch, heads, seq_len, head_dim, dtype, causal,
                     kind),
            best["block_q"], best["block_k"], best["ms"], swept=res["swept"],
        )
        sweeps.labels(swept_op).inc()
        latency.labels(swept_op).observe(elapsed)
        if swept_op == op:
            out = (int(best["block_q"]), int(best["block_k"]))
    _resolved[_resolved_key(kid, kind)] = out
    return out
