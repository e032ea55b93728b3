"""Native metadata backend: a ctypes binding over the port's C++ core.

The port of ``tpu_pipelines/metadata/native_store.py``.  ml-metadata is a
C++ storage core with a thin Python client; the same shape here: the C++
engine (``csrc/host/metadata_core.cc``: schema, prepared statements,
transactions, row serialization) is built with ``g++`` at first use into
``_build/`` (``ops/_build.py``, linked against the runtime libsqlite3)
and this module is the client.  The composite logic (publish_execution,
cache lookup, lineage walks, the stale-execution sweep) is inherited from
:class:`~tpu_pipelines_torch.metadata.store.MetadataStore` unchanged, so
both backends behave identically, and the on-disk SQLite schema matches,
so a store written by one backend opens in the other (and in the JAX
package's stores).

Select it with ``TPP_METADATA_BACKEND=native`` or
``open_store(backend="native")``; ``open_store`` falls back to the Python
backend with a warning when the library cannot be built.
"""

from __future__ import annotations

import ctypes
import json
import threading
from typing import Iterable, List, Optional

from tpu_pipelines_torch.metadata.store import MetadataStore, StoreUnavailableError
from tpu_pipelines_torch.metadata.types import (
    Artifact,
    ArtifactState,
    Context,
    Event,
    EventType,
    Execution,
    ExecutionState,
)

LIB_NAME = "metadata_core"

_c = ctypes
_P, _S, _I64, _D, _INT = _c.c_void_p, _c.c_char_p, _c.c_int64, _c.c_double, _c.c_int
# C function -> (restype, argtypes), set once when the library loads.
_PROTOTYPES = {
    "tpp_meta_open": (_P, [_S]),
    "tpp_meta_close": (None, [_P]),
    "tpp_meta_errmsg": (_S, [_P]),
    "tpp_meta_free": (None, [_P]),
    "tpp_meta_exec": (_INT, [_P, _S]),
    "tpp_meta_put_artifact": (_I64, [_P, _I64, _S, _S, _S, _S, _S, _D]),
    "tpp_meta_get_artifacts": (_P, [_P, _S, _S, _S, _I64]),
    "tpp_meta_put_execution": (_I64, [_P, _I64, _S, _S, _S, _S, _S, _D, _D]),
    "tpp_meta_get_executions": (_P, [_P, _S, _S, _I64]),
    "tpp_meta_put_event": (_INT, [_P, _I64, _I64, _S, _S, _I64, _D]),
    "tpp_meta_get_events": (_P, [_P, _I64, _I64]),
    "tpp_meta_put_context": (_I64, [_P, _S, _S, _S, _D]),
    "tpp_meta_get_context": (_P, [_P, _S, _S]),
    "tpp_meta_get_contexts": (_P, [_P, _S]),
    "tpp_meta_link": (_INT, [_P, _S, _I64, _I64]),
    "tpp_meta_by_context": (_P, [_P, _S, _I64]),
    "tpp_meta_latest_cached_execution": (_I64, [_P, _S, _S]),
}

_lib = None
_lib_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


def _load_library():
    """Build (g++, first use) and load the C++ core; raises
    NativeUnavailable when it cannot be built or loaded."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        from tpu_pipelines_torch.ops import _build

        try:
            _lib = _build.load_host(
                LIB_NAME, _PROTOTYPES, libs=(_build.sqlite_library(),)
            )
        except (OSError, RuntimeError) as e:
            raise NativeUnavailable(
                f"cannot build or load {LIB_NAME}: {str(e)[-500:]}"
            ) from e
        return _lib


def library_path() -> str:
    """Where the loaded C++ core lives (under ``_build/``)."""
    return _load_library()._name


def _b(s: Optional[str]) -> bytes:
    return (s or "").encode("utf-8")


class NativeMetadataStore(MetadataStore):
    """MetadataStore with every primitive served by the C++ core."""

    def __init__(self, db_path: str = ":memory:"):
        self._lib = _load_library()
        super().__init__(db_path)

    def _open_backend(self, db_path: str) -> None:
        self._handle = self._lib.tpp_meta_open(_b(db_path))
        if not self._handle:
            raise NativeUnavailable(f"tpp_meta_open failed for {db_path!r}")
        # Second line behind the cross-process flock writer lock (base
        # class): SQLite's own busy handler waits out a reader holding
        # the file mid-checkpoint instead of failing the write.
        self._lib.tpp_meta_exec(self._handle, b"PRAGMA busy_timeout=30000")

    # ------------------------------------------------------------ plumbing

    def _err(self, what: str):
        msg = self._lib.tpp_meta_errmsg(self._handle).decode("utf-8", "replace")
        # Structured (StoreUnavailableError is a RuntimeError subclass, so
        # existing expectations hold): the runner catches it around publishes
        # and records a node failure instead of crashing the run.
        raise StoreUnavailableError(f"native metadata store: {what}: {msg}")

    def _take_json(self, ptr) -> list:
        if not ptr:
            self._err("query")
        try:
            return json.loads(ctypes.string_at(ptr).decode("utf-8"))
        finally:
            self._lib.tpp_meta_free(ptr)

    def _commit(self) -> None:
        pass  # autocommit per statement outside explicit transactions

    # Transaction hooks consumed by the base class's publish_execution —
    # the retrying multi-writer composite (cross-process flock, transient
    # SQLITE_BUSY backoff, per-attempt id rollback) is inherited unchanged;
    # only BEGIN/COMMIT/ROLLBACK route through the C++ engine here.
    def _tx_begin(self) -> None:
        if self._lib.tpp_meta_exec(self._handle, b"BEGIN") != 0:
            self._err("BEGIN")

    def _tx_commit(self) -> None:
        if self._lib.tpp_meta_exec(self._handle, b"COMMIT") != 0:
            self._err("COMMIT")

    def _tx_rollback(self) -> None:
        self._lib.tpp_meta_exec(self._handle, b"ROLLBACK")

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.tpp_meta_close(self._handle)
            self._handle = None
        closer = getattr(self._plock, "close", None)
        if closer:
            closer()

    # ----------------------------------------------------------- artifacts

    def _artifact(self, row: dict) -> Artifact:
        art = Artifact(
            type_name=row["type_name"], uri=row["uri"],
            state=ArtifactState(row["state"]), properties=row["properties"],
            fingerprint=row["fingerprint"], create_time=row["create_time"],
        )
        art.id = row["id"]
        return art

    def put_artifact(self, artifact: Artifact) -> int:
        with self._lock, self._plock:
            rid = self._lib.tpp_meta_put_artifact(
                self._handle, artifact.id, _b(artifact.type_name),
                _b(artifact.uri), _b(artifact.state.value),
                _b(json.dumps(artifact.properties, sort_keys=True, default=str)),
                _b(artifact.fingerprint), artifact.create_time,
            )
            if rid < 0:
                self._err("put_artifact")
            artifact.id = rid
            return rid

    def get_artifact(self, artifact_id: int) -> Optional[Artifact]:
        rows = self._take_json(self._lib.tpp_meta_get_artifacts(
            self._handle, b"", b"", b"", artifact_id))
        return self._artifact(rows[0]) if rows else None

    # NB: the C ABI treats id/filter arguments < 0 as "no filter"; 0 is a
    # real value (the unpersisted sentinel) and matches nothing.

    def get_artifacts(self, type_name=None, state=None) -> List[Artifact]:
        rows = self._take_json(self._lib.tpp_meta_get_artifacts(
            self._handle, _b(type_name),
            _b(state.value if state else None), b"", -1))
        return [self._artifact(r) for r in rows]

    def get_artifacts_by_uri(self, uri: str) -> List[Artifact]:
        rows = self._take_json(self._lib.tpp_meta_get_artifacts(
            self._handle, b"", b"", _b(uri), -1))
        return [self._artifact(r) for r in rows]

    # ---------------------------------------------------------- executions

    def _execution(self, row: dict) -> Execution:
        ex = Execution(
            type_name=row["type_name"], node_id=row["node_id"],
            state=ExecutionState(row["state"]), properties=row["properties"],
            cache_key=row["cache_key"], create_time=row["create_time"],
            update_time=row["update_time"],
        )
        ex.id = row["id"]
        return ex

    def put_execution(self, execution: Execution) -> int:
        import time

        execution.update_time = time.time()
        with self._lock, self._plock:
            rid = self._lib.tpp_meta_put_execution(
                self._handle, execution.id, _b(execution.type_name),
                _b(execution.node_id), _b(execution.state.value),
                _b(json.dumps(execution.properties, sort_keys=True,
                              default=str)),
                _b(execution.cache_key), execution.create_time,
                execution.update_time,
            )
            if rid < 0:
                self._err("put_execution")
            execution.id = rid
            return rid

    def get_execution(self, execution_id: int) -> Optional[Execution]:
        rows = self._take_json(self._lib.tpp_meta_get_executions(
            self._handle, b"", b"", execution_id))
        return self._execution(rows[0]) if rows else None

    def get_executions(self, node_id=None, state=None) -> List[Execution]:
        rows = self._take_json(self._lib.tpp_meta_get_executions(
            self._handle, _b(node_id), _b(state.value if state else None), -1))
        return [self._execution(r) for r in rows]

    # -------------------------------------------------------------- events

    def put_events(self, events: Iterable[Event]) -> None:
        with self._lock, self._plock:
            for e in events:
                if self._lib.tpp_meta_put_event(
                    self._handle, e.artifact_id, e.execution_id,
                    _b(e.type.value), _b(e.path), e.index, e.ts,
                ) != 0:
                    self._err("put_event")

    def _events(self, rows: list) -> List[Event]:
        return [
            Event(r["artifact_id"], r["execution_id"], EventType(r["type"]),
                  r["path"], r["idx"], r["ts"])
            for r in rows
        ]

    def get_events_by_execution(self, execution_id: int) -> List[Event]:
        return self._events(self._take_json(
            self._lib.tpp_meta_get_events(self._handle, -1, execution_id)))

    def get_events_by_artifact(self, artifact_id: int) -> List[Event]:
        return self._events(self._take_json(
            self._lib.tpp_meta_get_events(self._handle, artifact_id, -1)))

    # ------------------------------------------------------------ contexts

    def put_context(self, context: Context) -> int:
        with self._lock, self._plock:
            rid = self._lib.tpp_meta_put_context(
                self._handle, _b(context.type_name), _b(context.name),
                _b(json.dumps(context.properties, sort_keys=True, default=str)),
                context.create_time,
            )
            if rid < 0:
                self._err("put_context")
            context.id = rid
            return rid

    @staticmethod
    def _context(r: dict) -> Context:
        ctx = Context(type_name=r["type_name"], name=r["name"],
                      properties=r["properties"], create_time=r["create_time"])
        ctx.id = r["id"]
        return ctx

    def get_context(self, type_name: str, name: str) -> Optional[Context]:
        rows = self._take_json(self._lib.tpp_meta_get_context(
            self._handle, _b(type_name), _b(name)))
        return self._context(rows[0]) if rows else None

    def get_contexts(self, type_name: Optional[str] = None) -> List[Context]:
        """All contexts in id order, optionally of one type (the run
        listing resume and ``inspect runs`` read)."""
        return [self._context(r) for r in self._take_json(
            self._lib.tpp_meta_get_contexts(self._handle, _b(type_name)))]

    def associate(self, context_id: int, execution_id: int) -> None:
        with self._lock, self._plock:
            if self._lib.tpp_meta_link(
                self._handle, b"associations", context_id, execution_id
            ) != 0:
                self._err("associate")

    def attribute(self, context_id: int, artifact_id: int) -> None:
        with self._lock, self._plock:
            if self._lib.tpp_meta_link(
                self._handle, b"attributions", context_id, artifact_id
            ) != 0:
                self._err("attribute")

    def get_executions_by_context(self, context_id: int) -> List[Execution]:
        return [self._execution(r) for r in self._take_json(
            self._lib.tpp_meta_by_context(self._handle, b"executions",
                                          context_id))]

    def get_artifacts_by_context(self, context_id: int) -> List[Artifact]:
        return [self._artifact(r) for r in self._take_json(
            self._lib.tpp_meta_by_context(self._handle, b"artifacts",
                                          context_id))]

    # ------------------------------------------------------- cache lookup

    def _latest_cached_execution_id(self, cache_key: str) -> int:
        rid = self._lib.tpp_meta_latest_cached_execution(
            self._handle, _b(cache_key), _b(ExecutionState.COMPLETE.value))
        if rid < 0:
            self._err("cache lookup")
        return int(rid)
