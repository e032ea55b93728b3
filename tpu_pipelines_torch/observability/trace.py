"""RunTrace: run-scoped structured tracing, the port of
``tpu_pipelines/observability/trace.py`` (same event schema, same files).

The metadata store records *what* a run published; this module records
*where its time went*.  A :class:`TraceRecorder` appends one JSON object
per line to ``<pipeline_root>/.runs/<run_id>/trace/events.jsonl``:

  ===========  ==========================================================
  cat          emitted by
  ===========  ==========================================================
  run          LocalDagRunner run start/end
  scheduler    per-node span (status, queue wait, device-gate wait),
               driver phase, cache hit/miss
  executor     executor attempts, retries, output fingerprinting, publish
  metadata     MetadataStore op latencies (publish/put/cache lookup)
  data         one span per shard task (``thread_map`` and the resilient
               pool, whose forked workers append with their own pid) and
               one per resilient fan-out
  trainer      window breakdowns, goodput and telemetry summaries from
               the train loop
  ===========  ==========================================================

  * **Crash durability.**  Every event is one line, flushed at once
    (append mode).  A kill can truncate at most the final line; readers
    (:func:`tpu_pipelines_torch.observability.export.read_events`) skip
    unparsable lines.
  * **Thread and fork safety.**  One lock per recorder serializes writer
    threads; a forked shard-pool child reopens the file and takes a
    fresh lock on its first event.
  * **Zero cost when off.**  ``TPP_TRACE=0`` disables tracing: no
    recorder, no ``.runs/`` directory, and every module-level helper is a
    null context costing one global read.  Tracing never touches the
    metadata store.

``ts`` is the wall clock (epoch seconds), ``mono`` the monotonic clock at
the same instant; span durations are monotonic differences.

:func:`install_log_correlation` stamps ``run_id`` and ``node_id`` onto
every ``tpu_pipelines_torch.*`` log record (through the record factory), so the
concurrent scheduler's interleaved logs stay attributable.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import os
import threading
import time
from typing import Any, Dict, Iterator, Optional

ENV_TRACE = "TPP_TRACE"

SCHEMA_VERSION = 1


def trace_enabled() -> bool:
    """Tracing is on unless TPP_TRACE=0 (default on: the <2%% overhead is
    the price of always having a profile for the run that just crashed)."""
    return os.environ.get(ENV_TRACE, "1").strip() != "0"


class TraceRecorder:
    """Append-only JSONL span/event writer for one pipeline run.

    Construct via :meth:`maybe_create` (respects ``TPP_TRACE``) or
    directly for tests.  Safe to share across the scheduler thread, the
    worker pool, and forked shard-pool processes.
    """

    def __init__(self, run_dir: str, run_id: str):
        self.run_id = run_id
        self.run_dir = run_dir
        self.trace_dir = os.path.join(run_dir, "trace")
        self.events_path = os.path.join(self.trace_dir, "events.jsonl")
        os.makedirs(self.trace_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._pid = os.getpid()
        # A SIGKILLed writer can leave a torn final line with no newline;
        # a resumed run appends to the same file, so start it on a fresh
        # line or its first event would merge into (and die with) the
        # torn tail.
        needs_newline = False
        try:
            with open(self.events_path, "rb") as f:
                f.seek(-1, os.SEEK_END)
                needs_newline = f.read(1) != b"\n"
        except (OSError, ValueError):
            pass  # missing or empty file
        self._fh = open(self.events_path, "a", encoding="utf-8")
        if needs_newline:
            self._fh.write("\n")
            self._fh.flush()
        self._closed = False

    @classmethod
    def maybe_create(
        cls, run_dir: str, run_id: str
    ) -> Optional["TraceRecorder"]:
        return cls(run_dir, run_id) if trace_enabled() else None

    # ------------------------------------------------------------- emitters

    def _write(self, record: Dict[str, Any]) -> None:
        line = json.dumps(record, separators=(",", ":"), default=str)
        if os.getpid() != self._pid:
            # Forked shard-pool child: the inherited handle shares the
            # parent's userspace buffer, so reopen (its own O_APPEND
            # descriptor: kernel-atomic line appends); and the inherited
            # lock may have been held by a parent thread at the fork,
            # which does not exist here to release it.
            self._pid = os.getpid()
            self._lock = threading.Lock()
            self._fh = open(self.events_path, "a", encoding="utf-8")
        with self._lock:
            if self._closed:
                return
            # Per-event flush: the crash-durability contract — an event
            # that was emitted is on disk before the next statement runs.
            self._fh.write(line + "\n")
            self._fh.flush()

    def _base(self, ev: str, name: str, cat: str, node: str) -> Dict[str, Any]:
        t = threading.current_thread()
        return {
            "v": SCHEMA_VERSION,
            "ev": ev,
            "name": name,
            "cat": cat,
            "node": node,
            "run": self.run_id,
            "pid": os.getpid(),
            "tid": t.ident or 0,
            "thread": t.name,
            "ts": time.time(),
            "mono": time.monotonic(),
        }

    def instant(
        self,
        name: str,
        cat: str = "",
        node: str = "",
        args: Optional[Dict[str, Any]] = None,
    ) -> None:
        rec = self._base("instant", name, cat, node)
        if args:
            rec["args"] = args
        self._write(rec)

    def complete(
        self,
        name: str,
        cat: str,
        node: str,
        ts: float,
        mono: float,
        dur_s: float,
        args: Optional[Dict[str, Any]] = None,
    ) -> None:
        """A span whose start (wall ``ts`` / monotonic ``mono``) and
        duration the caller measured itself (the scheduler's per-node
        span, whose start and settle happen in different loop turns)."""
        rec = self._base("span", name, cat, node)
        rec["ts"] = ts
        rec["mono"] = mono
        rec["dur"] = round(max(0.0, dur_s), 6)
        if args:
            rec["args"] = args
        self._write(rec)

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        cat: str = "",
        node: str = "",
        args: Optional[Dict[str, Any]] = None,
    ) -> Iterator[Dict[str, Any]]:
        """Measure the with-block; yields a dict merged into ``args`` at
        exit (executors drop e.g. the attempt's verdict in)."""
        extra: Dict[str, Any] = {}
        ts, mono = time.time(), time.monotonic()
        try:
            yield extra
        finally:
            merged = dict(args or {})
            merged.update(extra)
            self.complete(
                name, cat, node, ts, mono, time.monotonic() - mono,
                args=merged or None,
            )

    def close(self) -> None:
        with self._lock:
            self._closed = True
            try:
                self._fh.close()
            except OSError:
                pass


# -------------------------------------------------------- active recorder

# Module-global rather than a contextvar: worker threads must all see the
# run's recorder without explicit plumbing, and one process hosts at most
# one traced run at a time.
_ACTIVE: Optional[TraceRecorder] = None


def active_recorder() -> Optional[TraceRecorder]:
    return _ACTIVE


@contextlib.contextmanager
def activate(recorder: Optional[TraceRecorder]) -> Iterator[None]:
    """Install ``recorder`` as the process-wide active recorder for the
    block (None = leave tracing off; nested runs restore the outer one)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = recorder
    try:
        yield
    finally:
        _ACTIVE = prev


def span(
    name: str,
    cat: str = "",
    node: str = "",
    args: Optional[Dict[str, Any]] = None,
):
    """Span against the active recorder; a cheap null context when
    tracing is off (instrumented hot paths pay one global read)."""
    rec = _ACTIVE
    if rec is None:
        return contextlib.nullcontext({})
    return rec.span(name, cat=cat, node=node, args=args)


def instant(
    name: str,
    cat: str = "",
    node: str = "",
    args: Optional[Dict[str, Any]] = None,
) -> None:
    rec = _ACTIVE
    if rec is not None:
        rec.instant(name, cat=cat, node=node, args=args)


def run_trace_dir(pipeline_root: str, run_id: str) -> str:
    """Canonical run directory: ``<pipeline_root>/.runs/<run_id>``.

    The ``.runs`` prefix keeps run-scoped artifacts (trace, future run
    reports) out of the component output tree the lineage/fingerprint
    machinery walks."""
    return os.path.join(pipeline_root, ".runs", run_id)


def events_path(pipeline_root: str, run_id: str) -> str:
    return os.path.join(
        run_trace_dir(pipeline_root, run_id), "trace", "events.jsonl"
    )


# ------------------------------------------------------- log correlation

_current_run_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "tpp_run_id", default=""
)
_current_node_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "tpp_node_id", default=""
)


def set_run_id(run_id: str) -> contextvars.Token:
    return _current_run_id.set(run_id)


@contextlib.contextmanager
def node_log_context(node_id: str, run_id: str = "") -> Iterator[None]:
    """Attribute log records in the block to ``node_id`` (and, for worker
    threads whose context never saw the runner's set_run_id, ``run_id``)."""
    tok_n = _current_node_id.set(node_id)
    tok_r = _current_run_id.set(run_id) if run_id else None
    try:
        yield
    finally:
        _current_node_id.reset(tok_n)
        if tok_r is not None:
            _current_run_id.reset(tok_r)


class RunContextFilter(logging.Filter):
    """Stamps ``record.run_id`` / ``record.node_id`` from the current
    context.  Usable directly on handlers; :func:`install_log_correlation`
    applies the same stamping process-wide via the record factory (a
    filter on the ``tpu_pipelines`` logger would miss child loggers —
    logger-level filters do not apply to propagated child records)."""

    def filter(self, record: logging.LogRecord) -> bool:
        record.run_id = _current_run_id.get()
        record.node_id = _current_node_id.get()
        return True


_factory_installed = False


def install_log_correlation() -> None:
    """Stamp run_id/node_id onto every ``tpu_pipelines_torch.*`` log record
    (the port's loggers only: records of other packages keep what their
    own factories stamped).

    Idempotent; installed by the runner at run start, so any handler
    format using ``%(run_id)s``/``%(node_id)s`` — or a log aggregator
    keying on the attributes — can attribute interleaved scheduler logs.
    """
    global _factory_installed
    if _factory_installed:
        return
    _factory_installed = True
    previous = logging.getLogRecordFactory()

    def factory(*fargs: Any, **fkwargs: Any) -> logging.LogRecord:
        record = previous(*fargs, **fkwargs)
        if record.name.startswith("tpu_pipelines_torch"):
            record.run_id = _current_run_id.get()
            record.node_id = _current_node_id.get()
        return record

    logging.setLogRecordFactory(factory)
