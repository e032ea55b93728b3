"""The measured flash-vs-dense crossovers "auto" attention reads: the port
of the crossover half of ``tpu_pipelines/ops/autotune.py``.

Per device kind (the card's name, ``torch.cuda.get_device_name``, e.g.
"NVIDIA H100 80GB HBM3"; "cpu" for the CPU) the table holds two measured
lengths:

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
    :func:`record_crossover` / :func:`record_decode_crossover` under a
    cross-process ``FileLock``, atomically;
  * the committed table ``ops/autotune_table.json``: crossovers measured
    on the card and promoted into the repo, so a fresh checkout starts
    with them.  User-cache records shadow committed ones.

Reads are tolerant (a missing, torn or corrupt file reads as ``{}``) and
memoized by (mtime, size), so a lookup inside a CUDA-graph capture is a
``stat`` and a dict read, never a device call.

The reference's block sweep (``sweep_flash``, ``sweep_decode``,
``candidate_pairs``, ``clamp_block``, ``get_block_config``) has no
counterpart yet: every port kernel has fixed 64-wide blocks (ROADMAP.md
A13a).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch

from tpu_pipelines_torch.robustness.atomic import (
    FileLock,
    atomic_write_json,
    load_json_tolerant,
)

ENV_CACHE_DIR = "TPP_AUTOTUNE_CACHE"

_TABLE_VERSION = 1
_COMMITTED_TABLE = os.path.join(os.path.dirname(__file__), "autotune_table.json")


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
    """Drop in-process table memos (tests repoint the cache dir)."""
    _table_memo.clear()


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
