"""SQLite-backed metadata store with lineage and execution-cache queries.

The port's copy of ``tpu_pipelines/metadata/store.py`` (ml-metadata's
``MetadataStore``: artifacts, executions, contexts, events in embedded
SQLite), without the run tracer's spans and the fault-injection hooks.
The native (C++) backend waits (``ROADMAP.md`` A19).

Multi-writer discipline: the store is
crash-consistent and multi-process-safe, so concurrent runners and shard
children can publish into one store root without corruption:

  * **Crash atomicity** — WAL journaling + one transaction per composite
    publish: a crash at any instant leaves committed rows only, never a
    COMPLETE execution missing its output events.
  * **Cross-process writer lock** — every write (and the whole publish
    transaction) holds an ``fcntl.flock`` on the database file itself
    (``robustness.FileLock``; no sidecar file, so the disabled-mode
    zero-footprint contract holds), serializing N process-level writers
    instead of letting them race into ``SQLITE_BUSY`` storms.  The lock
    rides the kernel, so a dead writer releases it instantly.
  * **Contention retry** — the publish transaction retries
    transient failures (SQLITE_BUSY/locked, injected store-contention
    faults) under a jittered backoff policy, counted in
    ``retry_attempts_total{site="metadata.publish"}``; per-attempt id
    rollback keeps the retry idempotent.
  * **Torn-write detection on load** — opening a file-backed store runs
    ``PRAGMA quick_check`` (disable with ``TPP_STORE_VERIFY=0``) and
    surfaces corruption as a structured ``StoreUnavailableError`` instead
    of a downstream lineage walk reading garbage — the store-level mirror
    of the RunTrace torn-tail repair.

Readers never block writers: WAL snapshots serve the lineage CLI/UI while
a publish is in flight.
"""

from __future__ import annotations

import contextlib
import json
import os
import sqlite3
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence

from tpu_pipelines_torch.metadata.types import (
    Artifact,
    ArtifactState,
    Context,
    Event,
    EventType,
    Execution,
    ExecutionState,
)

class StoreUnavailableError(RuntimeError):
    """The metadata backend cannot serve a request (build timeout, dead
    native handle, engine-level failure).  Subclasses RuntimeError so
    existing callers keep working; the runner catches it around publishes
    and records a node failure instead of crashing the whole run."""


_SCHEMA = """
CREATE TABLE IF NOT EXISTS artifacts (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    type_name TEXT NOT NULL,
    uri TEXT NOT NULL,
    state TEXT NOT NULL,
    properties TEXT NOT NULL,
    fingerprint TEXT NOT NULL DEFAULT '',
    create_time REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_artifacts_type ON artifacts(type_name);
CREATE INDEX IF NOT EXISTS idx_artifacts_uri ON artifacts(uri);

CREATE TABLE IF NOT EXISTS executions (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    type_name TEXT NOT NULL,
    node_id TEXT NOT NULL,
    state TEXT NOT NULL,
    properties TEXT NOT NULL,
    cache_key TEXT NOT NULL DEFAULT '',
    create_time REAL NOT NULL,
    update_time REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_exec_cache ON executions(cache_key);
CREATE INDEX IF NOT EXISTS idx_exec_node ON executions(node_id);

CREATE TABLE IF NOT EXISTS events (
    artifact_id INTEGER NOT NULL,
    execution_id INTEGER NOT NULL,
    type TEXT NOT NULL,
    path TEXT NOT NULL DEFAULT '',
    idx INTEGER NOT NULL DEFAULT 0,
    ts REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_events_artifact ON events(artifact_id);
CREATE INDEX IF NOT EXISTS idx_events_execution ON events(execution_id);

CREATE TABLE IF NOT EXISTS contexts (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    type_name TEXT NOT NULL,
    name TEXT NOT NULL,
    properties TEXT NOT NULL,
    create_time REAL NOT NULL,
    UNIQUE(type_name, name)
);

CREATE TABLE IF NOT EXISTS associations (      -- execution ∈ context
    context_id INTEGER NOT NULL,
    execution_id INTEGER NOT NULL,
    UNIQUE(context_id, execution_id)
);

CREATE TABLE IF NOT EXISTS attributions (      -- artifact ∈ context
    context_id INTEGER NOT NULL,
    artifact_id INTEGER NOT NULL,
    UNIQUE(context_id, artifact_id)
);
"""


class MetadataStore:
    """Embedded artifact/execution/lineage store.

    Use ``MetadataStore(":memory:")`` for tests, a file path for real runs.
    """

    def __init__(self, db_path: str = ":memory:"):
        self.db_path = db_path
        self._lock = threading.RLock()
        self._in_tx = False
        if db_path != ":memory:":
            parent = os.path.dirname(os.path.abspath(db_path))
            os.makedirs(parent, exist_ok=True)
        # Cross-process writer lock ON the database file (no sidecar —
        # the disabled-mode contract is "exactly md.sqlite + payloads").
        # :memory: stores are process-private, so a null context suffices.
        if db_path != ":memory:":
            from tpu_pipelines_torch.robustness import FileLock

            self._plock = FileLock(db_path)
        else:
            self._plock = contextlib.nullcontext()
        self._open_backend(db_path)
        self._verify_on_load(db_path)

    def _open_backend(self, db_path: str) -> None:
        """Open the storage engine; the native backend overrides only this.

        ``timeout=30`` arms SQLite's own busy handler as the second line
        behind the flock writer lock (a reader mid-checkpoint can still
        hold the file briefly).
        """
        try:
            self._conn = sqlite3.connect(
                db_path, check_same_thread=False, timeout=30.0
            )
            with self._lock, self._plock:
                if db_path != ":memory:":
                    self._conn.execute("PRAGMA journal_mode=WAL")
                self._conn.execute("PRAGMA foreign_keys=ON")
                self._conn.executescript(_SCHEMA)
                self._conn.commit()
        except sqlite3.DatabaseError as e:
            # "file is not a database" and friends: a torn/garbage file is
            # a structured store failure, not a bare sqlite3 crash.
            raise StoreUnavailableError(
                f"metadata store at {db_path!r} is unreadable: {e}"
            ) from e

    def _verify_on_load(self, db_path: str) -> None:
        """Torn-write detection on open (``TPP_STORE_VERIFY=0`` skips):
        a file-backed store that fails ``PRAGMA quick_check`` surfaces as
        StoreUnavailableError NOW, instead of as garbage lineage later —
        mirroring the trace log's torn-tail repair at the store layer."""
        if db_path == ":memory:":
            return
        if os.environ.get("TPP_STORE_VERIFY", "1").strip() == "0":
            return
        try:
            rows = self._quick_check()
        except sqlite3.DatabaseError as e:
            raise StoreUnavailableError(
                f"metadata store at {db_path!r} failed integrity "
                f"verification: {e}"
            ) from e
        if rows and rows != ["ok"]:
            raise StoreUnavailableError(
                f"metadata store at {db_path!r} is corrupt (torn write?): "
                + "; ".join(rows[:5])
            )

    def _quick_check(self) -> List[str]:
        # A throwaway stdlib connection, NOT the backend handle: both
        # backends share the on-disk format, so this one check covers the
        # native (C++) engine too.
        conn = sqlite3.connect(self.db_path)
        try:
            return [
                str(r[0]) for r in conn.execute("PRAGMA quick_check")
            ]
        finally:
            conn.close()

    def _commit(self) -> None:
        """Commit unless inside an explicit multi-write transaction."""
        if not self._in_tx:
            self._conn.commit()

    # Transaction hooks — overridden by alternative backends
    # (metadata/native_store.py) so publish_execution stays shared.
    def _tx_begin(self) -> None:
        """Open the publish transaction (python sqlite: implicit — the
        first write BEGINs; the native engine needs an explicit BEGIN)."""

    def _tx_commit(self) -> None:
        self._conn.commit()

    def _tx_rollback(self) -> None:
        self._conn.rollback()

    def close(self) -> None:
        self._conn.close()
        closer = getattr(self._plock, "close", None)
        if closer:
            closer()

    # ------------------------------------------------------------- artifacts

    def put_artifact(self, artifact: Artifact) -> int:
        with self._lock, self._plock:
            if artifact.id:
                self._conn.execute(
                    "UPDATE artifacts SET type_name=?, uri=?, state=?, "
                    "properties=?, fingerprint=?, create_time=? WHERE id=?",
                    artifact.to_row() + (artifact.id,),
                )
            else:
                cur = self._conn.execute(
                    "INSERT INTO artifacts "
                    "(type_name, uri, state, properties, fingerprint, create_time) "
                    "VALUES (?,?,?,?,?,?)",
                    artifact.to_row(),
                )
                artifact.id = cur.lastrowid
            self._commit()
            return artifact.id

    def get_artifact(self, artifact_id: int) -> Optional[Artifact]:
        row = self._conn.execute(
            "SELECT * FROM artifacts WHERE id=?", (artifact_id,)
        ).fetchone()
        return Artifact.from_row(row) if row else None

    def get_artifacts(
        self, type_name: Optional[str] = None, state: Optional[ArtifactState] = None
    ) -> List[Artifact]:
        q, args = "SELECT * FROM artifacts", []
        clauses = []
        if type_name:
            clauses.append("type_name=?")
            args.append(type_name)
        if state:
            clauses.append("state=?")
            args.append(state.value)
        if clauses:
            q += " WHERE " + " AND ".join(clauses)
        return [Artifact.from_row(r) for r in self._conn.execute(q, args)]

    def get_artifacts_by_uri(self, uri: str) -> List[Artifact]:
        rows = self._conn.execute("SELECT * FROM artifacts WHERE uri=?", (uri,))
        return [Artifact.from_row(r) for r in rows]

    # ------------------------------------------------------------ executions

    def put_execution(self, execution: Execution) -> int:
        execution.update_time = time.time()
        with self._lock, self._plock:
            if execution.id:
                self._conn.execute(
                    "UPDATE executions SET type_name=?, node_id=?, state=?, "
                    "properties=?, cache_key=?, create_time=?, update_time=? "
                    "WHERE id=?",
                    execution.to_row() + (execution.id,),
                )
            else:
                cur = self._conn.execute(
                    "INSERT INTO executions (type_name, node_id, state, "
                    "properties, cache_key, create_time, update_time) "
                    "VALUES (?,?,?,?,?,?,?)",
                    execution.to_row(),
                )
                execution.id = cur.lastrowid
            self._commit()
            return execution.id

    def get_execution(self, execution_id: int) -> Optional[Execution]:
        row = self._conn.execute(
            "SELECT * FROM executions WHERE id=?", (execution_id,)
        ).fetchone()
        return Execution.from_row(row) if row else None

    def get_executions(
        self,
        node_id: Optional[str] = None,
        state: Optional[ExecutionState] = None,
    ) -> List[Execution]:
        q, args = "SELECT * FROM executions", []
        clauses = []
        if node_id:
            clauses.append("node_id=?")
            args.append(node_id)
        if state:
            clauses.append("state=?")
            args.append(state.value)
        if clauses:
            q += " WHERE " + " AND ".join(clauses)
        q += " ORDER BY id"
        return [Execution.from_row(r) for r in self._conn.execute(q, args)]

    # ---------------------------------------------------------------- events

    def put_events(self, events: Iterable[Event]) -> None:
        with self._lock, self._plock:
            self._conn.executemany(
                "INSERT INTO events (artifact_id, execution_id, type, path, idx, ts) "
                "VALUES (?,?,?,?,?,?)",
                [(e.artifact_id, e.execution_id, e.type.value, e.path, e.index, e.ts)
                 for e in events],
            )
            self._commit()

    def get_events_by_execution(self, execution_id: int) -> List[Event]:
        rows = self._conn.execute(
            "SELECT artifact_id, execution_id, type, path, idx, ts FROM events "
            "WHERE execution_id=? ORDER BY rowid",
            (execution_id,),
        )
        return [
            Event(r[0], r[1], EventType(r[2]), r[3], r[4], r[5]) for r in rows
        ]

    def get_events_by_artifact(self, artifact_id: int) -> List[Event]:
        rows = self._conn.execute(
            "SELECT artifact_id, execution_id, type, path, idx, ts FROM events "
            "WHERE artifact_id=? ORDER BY rowid",
            (artifact_id,),
        )
        return [
            Event(r[0], r[1], EventType(r[2]), r[3], r[4], r[5]) for r in rows
        ]

    # -------------------------------------------------------------- contexts

    def put_context(self, context: Context) -> int:
        """Insert or fetch-by-unique-name; returns the context id."""
        with self._lock, self._plock:
            row = self._conn.execute(
                "SELECT id FROM contexts WHERE type_name=? AND name=?",
                (context.type_name, context.name),
            ).fetchone()
            if row:
                context.id = row[0]
                return context.id
            cur = self._conn.execute(
                "INSERT INTO contexts (type_name, name, properties, create_time) "
                "VALUES (?,?,?,?)",
                (
                    context.type_name,
                    context.name,
                    json.dumps(context.properties, sort_keys=True, default=str),
                    context.create_time,
                ),
            )
            context.id = cur.lastrowid
            self._commit()
            return context.id

    def get_contexts(self, type_name: Optional[str] = None) -> List[Context]:
        """All contexts, optionally filtered by type (e.g. "pipeline_run")."""
        q, args = (
            "SELECT id, type_name, name, properties, create_time FROM contexts",
            [],
        )
        if type_name:
            q += " WHERE type_name=?"
            args.append(type_name)
        q += " ORDER BY id"
        out = []
        for row in self._conn.execute(q, args):
            ctx = Context(
                type_name=row[1], name=row[2], properties=json.loads(row[3]),
                create_time=row[4],
            )
            ctx.id = row[0]
            out.append(ctx)
        return out

    def get_context(self, type_name: str, name: str) -> Optional[Context]:
        row = self._conn.execute(
            "SELECT id, type_name, name, properties, create_time FROM contexts "
            "WHERE type_name=? AND name=?",
            (type_name, name),
        ).fetchone()
        if not row:
            return None
        ctx = Context(
            type_name=row[1], name=row[2], properties=json.loads(row[3]),
            create_time=row[4],
        )
        ctx.id = row[0]
        return ctx

    def associate(self, context_id: int, execution_id: int) -> None:
        with self._lock, self._plock:
            self._conn.execute(
                "INSERT OR IGNORE INTO associations (context_id, execution_id) "
                "VALUES (?,?)",
                (context_id, execution_id),
            )
            self._commit()

    def attribute(self, context_id: int, artifact_id: int) -> None:
        with self._lock, self._plock:
            self._conn.execute(
                "INSERT OR IGNORE INTO attributions (context_id, artifact_id) "
                "VALUES (?,?)",
                (context_id, artifact_id),
            )
            self._commit()

    def get_executions_by_context(self, context_id: int) -> List[Execution]:
        rows = self._conn.execute(
            "SELECT e.* FROM executions e "
            "JOIN associations a ON a.execution_id = e.id "
            "WHERE a.context_id=? ORDER BY e.id",
            (context_id,),
        )
        return [Execution.from_row(r) for r in rows]

    def get_artifacts_by_context(self, context_id: int) -> List[Artifact]:
        rows = self._conn.execute(
            "SELECT ar.* FROM artifacts ar "
            "JOIN attributions at ON at.artifact_id = ar.id "
            "WHERE at.context_id=? ORDER BY ar.id",
            (context_id,),
        )
        return [Artifact.from_row(r) for r in rows]

    # ---------------------------------------------------- composite publish

    # Contention policy for the composite publish: SQLITE_BUSY under N
    # concurrent process writers clears in milliseconds once the holder
    # commits, so short jittered waits; ~6s worst-case total budget.
    PUBLISH_RETRY_ATTEMPTS = 5
    PUBLISH_RETRY_BASE_S = 0.05
    PUBLISH_RETRY_MAX_S = 2.0

    @staticmethod
    def _is_transient_store_error(exc: BaseException) -> bool:
        if isinstance(exc, sqlite3.OperationalError):
            msg = str(exc).lower()
            return "locked" in msg or "busy" in msg
        from tpu_pipelines_torch.robustness import is_transient

        return is_transient(exc)

    def publish_execution(
        self,
        execution: Execution,
        input_artifacts: Dict[str, Sequence[Artifact]],
        output_artifacts: Dict[str, Sequence[Artifact]],
        contexts: Sequence[Context] = (),
    ) -> Execution:
        """Atomically record an execution with its I/O events and contexts.

        Output artifacts are persisted (assigned ids) and marked LIVE when the
        execution completed, ABANDONED when it failed.  The whole publish is a
        single SQLite transaction under the cross-process writer lock: a
        crash mid-publish leaves no COMPLETE execution without its output
        events (which would poison the cache), and concurrent process
        writers serialize instead of corrupting each other.  Transient
        failures (SQLITE_BUSY past the flock, injected store-contention
        faults) retry with jittered backoff; ids assigned by a rolled-back
        attempt are reset first so the retry re-inserts instead of
        UPDATE-ing rows the rollback erased.
        """
        from tpu_pipelines_torch.robustness import RetryPolicy, record_retry

        policy = RetryPolicy(
            max_attempts=self.PUBLISH_RETRY_ATTEMPTS,
            base_delay_s=self.PUBLISH_RETRY_BASE_S,
            max_delay_s=self.PUBLISH_RETRY_MAX_S,
        )
        with self._lock:
            saved_ex_id = execution.id
            saved_art_ids = [
                (a, a.id)
                for arts in output_artifacts.values()
                for a in arts
            ]
            saved_ctx_ids = [(c, c.id) for c in contexts]
            failures = 0
            while True:
                try:
                    with self._plock:
                        self._in_tx = True
                        try:
                            self._tx_begin()
                            self._publish_locked(
                                execution, input_artifacts,
                                output_artifacts, contexts,
                            )
                            self._tx_commit()
                        except BaseException:
                            self._tx_rollback()
                            raise
                        finally:
                            self._in_tx = False
                    return execution
                except Exception as exc:
                    failures += 1
                    if (
                        failures >= policy.max_attempts
                        or not self._is_transient_store_error(exc)
                    ):
                        raise
                    # The rolled-back attempt may have assigned row ids;
                    # reset them so the retry inserts fresh rows.
                    execution.id = saved_ex_id
                    for art, aid in saved_art_ids:
                        art.id = aid
                    for ctx, cid in saved_ctx_ids:
                        ctx.id = cid
                    record_retry("metadata.publish")
                    time.sleep(policy.backoff_s(failures))

    def _publish_locked(
        self,
        execution: Execution,
        input_artifacts: Dict[str, Sequence[Artifact]],
        output_artifacts: Dict[str, Sequence[Artifact]],
        contexts: Sequence[Context] = (),
    ) -> Execution:
        with self._lock:
            self.put_execution(execution)
            events: List[Event] = []
            for path, arts in input_artifacts.items():
                for i, art in enumerate(arts):
                    assert art.id, f"input artifact {path}[{i}] not persisted"
                    events.append(
                        Event(art.id, execution.id, EventType.INPUT, path, i)
                    )
            ok = execution.state in (ExecutionState.COMPLETE, ExecutionState.CACHED)
            for path, arts in output_artifacts.items():
                for i, art in enumerate(arts):
                    art.state = (
                        ArtifactState.LIVE if ok else ArtifactState.ABANDONED
                    )
                    self.put_artifact(art)
                    events.append(
                        Event(art.id, execution.id, EventType.OUTPUT, path, i)
                    )
            self.put_events(events)
            for ctx in contexts:
                self.put_context(ctx)
                self.associate(ctx.id, execution.id)
                for arts in output_artifacts.values():
                    for art in arts:
                        self.attribute(ctx.id, art.id)
            return execution

    # -------------------------------------------------------- cache queries

    def get_cached_outputs(
        self, cache_key: str
    ) -> Optional[Dict[str, List[Artifact]]]:
        """Outputs of the latest COMPLETE execution with this cache key.

        Returns None on cache miss, or if any cached output artifact is no
        longer LIVE (e.g. garbage-collected payload).
        """
        if not cache_key:
            return None
        exec_id = self._latest_cached_execution_id(cache_key)
        if not exec_id:
            return None
        outputs: Dict[str, List[Artifact]] = {}
        for ev in self.get_events_by_execution(exec_id):
            if ev.type != EventType.OUTPUT:
                continue
            art = self.get_artifact(ev.artifact_id)
            if art is None or art.state != ArtifactState.LIVE:
                return None
            outputs.setdefault(ev.path, []).append((ev.index, art))
        if not outputs:
            # A COMPLETE execution with no recorded outputs is corrupt
            # state (interrupted legacy publish), never a usable hit.
            return None
        return {
            path: [a for _, a in sorted(pairs, key=lambda p: p[0])]
            for path, pairs in outputs.items()
        }

    def _latest_cached_execution_id(self, cache_key: str) -> int:
        """Id of the newest COMPLETE execution with this key; 0 = miss."""
        row = self._conn.execute(
            "SELECT id FROM executions WHERE cache_key=? AND state=? "
            "ORDER BY id DESC LIMIT 1",
            (cache_key, ExecutionState.COMPLETE.value),
        ).fetchone()
        return row[0] if row else 0
