"""Content fingerprinting for artifacts, executors and property bags.

Cache correctness (SURVEY.md §7 "hard parts" #4) hinges on these keys: a
cache key must change whenever (a) any input artifact's *payload* changes,
(b) the node's exec-properties change, or (c) the executor code changes.
Silent staleness poisons every downstream result, so fingerprints hash real
file content — not mtimes — and executor versions hash the function's
source PLUS its captured state (closure cells, argument defaults).

Two determinism traps this module closes (both also surfaced as lint rules,
docs/ANALYSIS.md):

  * ``fingerprint_json`` used to fall back to bare ``str()`` for non-JSON
    values; an object whose repr embeds its memory address (``<obj at
    0x7f..>``) then hashed differently in every process — the node never
    cache-hit, and resumed runs re-ran clean work (lint: TPP104).  The
    canonical encoder scrubs addresses and tags the value's type instead.
  * ``fingerprint_callable`` used to hash source only; a factory-made
    executor capturing config in a closure kept its hash when the captured
    value changed — stale cache hits (lint: TPP201).  Closure-cell values
    and defaults now mix into the hash whenever they have a stable
    encoding.
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import json
import os
import re
from typing import Any, Callable, Dict, Iterator, List, Tuple

# CPython reprs embed the object's address: `<Foo object at 0x7f3a...>`.
# Anything matching this is nondeterministic across processes (and, with
# ASLR, across runs of the same process image).
_ADDR_RE = re.compile(r"0x[0-9a-fA-F]{4,}")

_JSON_NATIVE = (str, int, float, bool, type(None))


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def fingerprint_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def fingerprint_dir(root: str) -> str:
    """Deterministic content hash of a directory tree (names + bytes)."""
    h = hashlib.sha256()
    if os.path.isfile(root):
        return fingerprint_file(root)
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for name in sorted(filenames):
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, root)
            h.update(rel.encode())
            h.update(fingerprint_file(full).encode())
    return h.hexdigest()


# ------------------------------------------------------------ canonical JSON


def _canonical_default(value: Any) -> Any:
    """Deterministic stand-in for a non-JSON-native value.

    Order of preference: real structure (dataclass fields, set members,
    bytes) over stringification; when only ``str()`` is left, scrub any
    embedded memory address and tag the type so two *different* unprintable
    objects of different types cannot collide on the scrubbed text alone.
    """
    if isinstance(value, (set, frozenset)):
        # Sort by canonical encoding, not value (members may be unorderable).
        return {"__set__": sorted(canonical_json(v) for v in value)}
    if isinstance(value, bytes):
        return {"__bytes__": value.hex()}
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {
            "__dataclass__": type(value).__qualname__,
            "fields": dataclasses.asdict(value),
        }
    if callable(value):
        # A callable's identity is its code, not its repr.
        return {"__callable__": fingerprint_callable(value)}
    try:
        text = str(value)
    except Exception:
        text = f"<unprintable at 0x0 {type(value).__qualname__}>"
    if _ADDR_RE.search(text):
        return {
            "__opaque__": (
                f"{type(value).__module__}.{type(value).__qualname__}"
            ),
            "str": _ADDR_RE.sub("0xADDR", text),
        }
    return {"__str__": text, "type": type(value).__qualname__}


def canonical_json(obj: Any) -> str:
    """JSON encoding that is byte-identical across fresh processes.

    The contract ``fingerprint_json`` hashes: sorted keys, and every
    non-native value routed through ``_canonical_default`` (never bare
    ``str`` — see module docstring)."""
    return json.dumps(obj, sort_keys=True, default=_canonical_default)


def fingerprint_json(obj: Any) -> str:
    """Hash of a JSON-serializable object (sorted keys, stable encoding)."""
    return sha256_hex(canonical_json(obj).encode("utf-8"))


def find_unjsonable(
    obj: Any, _path: str = ""
) -> List[Tuple[str, Any, bool]]:
    """(path, value, embeds_address) for every non-JSON-native leaf.

    The lint rule TPP104 (``analysis/graph_rules.py``) renders these; ``embeds_address`` distinguishes
    the ERROR case (str() carries a memory address — key nondeterminism)
    from the WARN case (deterministic but blind to the value's state)."""
    out: List[Tuple[str, Any, bool]] = []
    for path, value in _walk(obj, _path):
        if isinstance(value, _JSON_NATIVE):
            continue
        try:
            text = str(value)
        except Exception:
            text = "0xDEAD"  # unprintable: treat as address-bearing
        out.append((path, value, bool(_ADDR_RE.search(text))))
    return out


def _walk(obj: Any, path: str) -> Iterator[Tuple[str, Any]]:
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _walk(v, f"{path}.{k}" if path else str(k))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _walk(v, f"{path}[{i}]")
    else:
        yield path or "<root>", obj

# --------------------------------------------------------- callable versions


def stable_token(value: Any, _depth: int = 0) -> Tuple[str, bool]:
    """(token, stable): a process-stable encoding of a captured value.

    ``stable`` is False when the only encoding available embeds a memory
    address — the value then contributes its type (deterministic) but
    cannot contribute its *state*, which is exactly the staleness the
    TPP201 lint rule reports."""
    if isinstance(value, _JSON_NATIVE):
        return json.dumps(value), True
    if isinstance(value, (list, tuple, dict, set, frozenset, bytes)):
        try:
            return canonical_json(value), True
        except (TypeError, ValueError, RecursionError):
            return f"<{type(value).__qualname__}>", False
    if inspect.ismodule(value):
        return f"module:{value.__name__}", True
    if isinstance(value, type):
        return f"class:{value.__module__}.{value.__qualname__}", True
    if callable(value) and _depth < 3:
        # Captured helper functions version by their own fingerprint, so
        # editing the helper invalidates the capturing executor too.
        return f"callable:{fingerprint_callable(value, _depth + 1)}", True
    text = str(value)
    if _ADDR_RE.search(text):
        return f"<{type(value).__module__}.{type(value).__qualname__}>", False
    return f"str:{text}", True


def fingerprint_callable(fn: Callable, _depth: int = 0) -> str:
    """Version hash of an executor: source + captured state.

    Hashing source (rather than module version strings) means editing an
    executor invalidates its cache entries automatically.  Closure-cell
    values and argument defaults mix in too, so a factory-made executor
    capturing config re-versions when the captured config changes —
    same source, different closure value => different hash (and thus a
    different ``execution_cache_key``)."""
    try:
        src = inspect.getsource(fn)
    except (OSError, TypeError):
        src = f"{getattr(fn, '__module__', '?')}.{getattr(fn, '__qualname__', repr(fn))}"
    parts = [src]
    code = getattr(fn, "__code__", None)
    cells = getattr(fn, "__closure__", None) or ()
    names = getattr(code, "co_freevars", ()) if code is not None else ()
    for name, cell in zip(names, cells):
        try:
            value = cell.cell_contents
        except ValueError:  # empty cell (still being built)
            parts.append(f"closure:{name}=<empty>")
            continue
        token, _ = stable_token(value, _depth)
        parts.append(f"closure:{name}={token}")
    defaults = getattr(fn, "__defaults__", None) or ()
    if defaults:
        toks = ",".join(stable_token(v, _depth)[0] for v in defaults)
        parts.append(f"defaults:{toks}")
    kwdefaults = getattr(fn, "__kwdefaults__", None) or {}
    for name in sorted(kwdefaults):
        parts.append(
            f"kwdefault:{name}={stable_token(kwdefaults[name], _depth)[0]}"
        )
    return sha256_hex("\x00".join(parts).encode("utf-8"))


def execution_cache_key(
    node_id: str,
    executor_version: str,
    exec_properties: Dict[str, Any],
    input_fingerprints: Dict[str, list],
) -> str:
    """Content key for the execution cache.

    ``input_fingerprints`` maps input key -> ordered list of artifact payload
    fingerprints.  Node identity participates so a different node that happens
    to share code and inputs does not alias this node's cache entries.
    """
    return fingerprint_json(
        {
            "node": node_id,
            "executor": executor_version,
            "props": exec_properties,
            "inputs": input_fingerprints,
        }
    )
