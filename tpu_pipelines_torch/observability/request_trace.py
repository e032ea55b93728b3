"""Request-scoped serving traces: where one request's latency went.

The port of ``tpu_pipelines/observability/request_trace.py``.  A W3C
``traceparent``-compatible trace id is accepted (or generated) at the REST
and gRPC front doors, and every layer the request crosses emits spans
against it:

  ================  ====================================================
  span / instant    emitted by
  ================  ====================================================
  request           front door (root span: endpoint, status code)
  admission         ModelServer._admit (queue depth vs bound)
  route             ReplicaPool.submit / ServingFleet.generate_submit
                    (chosen replica, each replica's routing cost)
  batch.wait        RequestBatcher worker (enqueue -> group dispatch)
  model.step        RequestBatcher worker (the device call; the version
                    leased for it, through :func:`note`)
  decode            GenerativeEngine (whole generation, eviction included)
  decode.join/.step/.spec/.eos/.evict   per decode-round slot events
  exemplar          /metrics scrape (slowest request per interval)
  slo/burn_alert    SLOMonitor breach (observability/slo.py)
  drift/alert       TrafficSampler alert (observability/drift.py)
  ================  ====================================================

  * **Off by default.**  ``TPP_REQUEST_TRACE`` (``off | sample:N | all``)
    defaults to ``off``: no tracer, no file, no metric family.  Every
    instrumented path pays one ``None`` check, and :func:`note` one global
    int read.
  * **Bounded.**  Events land in a per-process ring (``deque(maxlen=
    capacity)``); head sampling (``sample:N``) bounds the rate.
  * **The file.**  With a trace dir (``TPP_REQUEST_TRACE_DIR``) every event
    is also appended to ``<trace_dir>/serving/events.jsonl`` in the
    reference's schema, by the run trace's :class:`TraceRecorder`.  The
    appends run on a writer thread of the tracer's own, so no serving
    thread waits on the disk; that thread touches host records only and
    never launches CUDA work (every span argument is a host number).
    :meth:`RequestTracer.flush` waits for it; ``trace serve`` and the
    Perfetto exporter read the file.

Propagation: the front door installs the trace in a context var for the
handler thread (admission and the route decision run there); a batcher or
engine worker thread sees the context only through the queue item or the
sequence that carries it.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import os
import queue
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from tpu_pipelines_torch.observability.trace import TraceRecorder

ENV_REQUEST_TRACE = "TPP_REQUEST_TRACE"      # off | sample:N | all
ENV_REQUEST_TRACE_DIR = "TPP_REQUEST_TRACE_DIR"

SCHEMA_VERSION = 1
DEFAULT_RING_CAPACITY = 4096

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


# ------------------------------------------------------------ trace ids


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


def parse_traceparent(header: Optional[str]) -> Optional[Tuple[str, str]]:
    """``(trace_id, parent_span_id)`` from a W3C traceparent header, or
    None for a missing/malformed one (a bad header starts a fresh trace
    rather than failing the request — tracing must never 4xx anyone)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    version, trace_id, span_id = m.group(1), m.group(2), m.group(3)
    # All-zero ids are invalid per spec; version ff is reserved.
    if version == "ff" or set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None
    return trace_id, span_id


def format_traceparent(
    trace_id: str, span_id: str, sampled: bool = True
) -> str:
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


def parse_mode(value: Optional[str]) -> Tuple[str, int]:
    """``(mode, n)`` from a ``TPP_REQUEST_TRACE`` value: ``off`` (the
    default; also any unparsable value — misconfiguration must not turn
    tracing ON), ``all``, or ``sample:N`` (head-sample every Nth
    request; ``sample`` alone means ``sample:10``)."""
    value = (value or "").strip().lower()
    if value in ("", "off", "0", "false", "no"):
        return "off", 0
    if value in ("all", "1", "on"):
        return "all", 1
    if value.startswith("sample"):
        _, _, n = value.partition(":")
        try:
            n = max(1, int(n or "10"))
        except ValueError:
            return "off", 0
        return "sample", n
    return "off", 0


# ------------------------------------------------ cross-thread plumbing

_CURRENT: "contextvars.ContextVar[Optional[RequestTrace]]" = (
    contextvars.ContextVar("tpp_request_trace", default=None)
)

# Live tracer count: the cheap global guard for instrumentation that has
# no ctx in hand (the version-lease note below).  0 = fully off.
_ACTIVE_TRACERS = 0
_ACTIVE_LOCK = threading.Lock()

_notes = threading.local()


def tracing_active() -> bool:
    return _ACTIVE_TRACERS > 0


def current() -> Optional["RequestTrace"]:
    """The handler thread's request trace (None off / unsampled).  Worker
    threads see None — their context rides the queue item instead."""
    return _CURRENT.get()


def push(ctx: Optional["RequestTrace"]):
    return _CURRENT.set(ctx)


def pop(token) -> None:
    _CURRENT.reset(token)


@contextlib.contextmanager
def use(ctx: Optional["RequestTrace"]):
    token = _CURRENT.set(ctx)
    try:
        yield ctx
    finally:
        _CURRENT.reset(token)


def note(key: str, value: Any) -> None:
    """Thread-local annotation for code that runs inside a worker's
    synchronous call chain but below the span emitter (the fleet's
    version lease runs inside ``predict_fn``, the batcher emits the
    ``model.step`` span around it).  One global int read when off."""
    if not _ACTIVE_TRACERS:
        return
    d = getattr(_notes, "d", None)
    if d is None:
        d = _notes.d = {}
    d[key] = value


def take_notes() -> Dict[str, Any]:
    d = getattr(_notes, "d", None)
    if not d:
        return {}
    _notes.d = {}
    return d


# ------------------------------------------------------------ exemplars


class ExemplarStore:
    """Slowest request per endpoint since the last scrape: the latency
    histogram's link back into the span tree.  ``offer`` keeps the max;
    ``drain`` returns-and-resets (one exemplar per scrape interval)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._worst: Dict[str, Tuple[float, str]] = {}

    def offer(self, endpoint: str, latency_s: float, trace_id: str) -> None:
        with self._lock:
            prev = self._worst.get(endpoint)
            if prev is None or latency_s > prev[0]:
                self._worst[endpoint] = (float(latency_s), trace_id)

    def drain(self) -> Dict[str, Tuple[float, str]]:
        with self._lock:
            out, self._worst = self._worst, {}
        return out


# -------------------------------------------------------------- tracer


class RequestTracer:
    """Per-server request-trace sink: sampling decision, bounded ring,
    optional crash-durable file, exemplar store.

    Construct via :meth:`create` (returns None when the mode is off, so
    the off path allocates nothing).  Thread-safe: the front door calls
    :meth:`start` concurrently, spans are emitted from handler, batcher
    and engine threads.
    """

    def __init__(
        self,
        mode: str = "all",
        sample_n: int = 1,
        trace_dir: str = "",
        capacity: int = DEFAULT_RING_CAPACITY,
        service: str = "serving",
        registry=None,
    ):
        global _ACTIVE_TRACERS
        self.mode = mode
        self.sample_n = max(1, int(sample_n))
        self.service = service
        self.ring: "collections.deque" = collections.deque(
            maxlen=max(16, int(capacity))
        )
        self.exemplars = ExemplarStore()
        self._count = 0
        self._lock = threading.Lock()
        self._recorder: Optional[TraceRecorder] = None
        self._closed = False
        self._pending: "queue.Queue" = queue.Queue()
        self._writer: Optional[threading.Thread] = None
        if trace_dir:
            serving_dir = os.path.join(trace_dir, "serving")
            # The run trace's append (single-line O_APPEND, per-event
            # flush, torn-tail newline repair), driven from the writer
            # thread below.
            self._recorder = TraceRecorder(
                serving_dir, service,
                events_path=os.path.join(serving_dir, "events.jsonl"),
            )
            self._writer = threading.Thread(
                target=self._write_loop, name="request-trace-writer",
                daemon=True,
            )
            self._writer.start()
        self._m_traced = None
        if registry is not None:
            # Registered ONLY when a tracer exists: with tracing off the
            # scrape stays byte-identical to a build without tracing.
            self._m_traced = registry.counter(
                "serving_traced_requests_total",
                "Requests whose spans were recorded (head sampling "
                "admitted them).",
            )
        with _ACTIVE_LOCK:
            _ACTIVE_TRACERS += 1

    @classmethod
    def create(
        cls,
        mode_value: str,
        trace_dir: str = "",
        *,
        capacity: int = DEFAULT_RING_CAPACITY,
        service: str = "serving",
        registry=None,
    ) -> Optional["RequestTracer"]:
        mode, n = parse_mode(mode_value)
        if mode == "off":
            return None
        return cls(
            mode, n, trace_dir=trace_dir, capacity=capacity,
            service=service, registry=registry,
        )

    # ----------------------------------------------------------- sampling

    def _sampled(self) -> bool:
        """Head sampling: decided once per request at the front door;
        everything downstream inherits the verdict (a request is traced
        whole or not at all — partial trees are worse than none)."""
        if self.mode == "all":
            return True
        with self._lock:
            self._count += 1
            return (self._count - 1) % self.sample_n == 0

    def start(
        self, endpoint: str, traceparent: Optional[str] = None
    ) -> Optional["RequestTrace"]:
        """Begin a request trace (None = not sampled).  An incoming
        ``traceparent`` keeps its trace id (distributed callers see one
        tree); otherwise a fresh id is generated."""
        if self._closed or not self._sampled():
            return None
        parsed = parse_traceparent(traceparent)
        if parsed is not None:
            trace_id, parent = parsed
        else:
            trace_id, parent = new_trace_id(), ""
        if self._m_traced is not None:
            self._m_traced.inc()
        return RequestTrace(self, trace_id, parent, endpoint)

    # ----------------------------------------------------------- emission

    def emit(self, record: Dict[str, Any]) -> None:
        if self._closed:
            return
        self.ring.append(record)          # deque.append is atomic
        if self._writer is not None:
            self._pending.put(record)

    def _write_loop(self) -> None:
        """The file writer: appends queued records until the close
        sentinel.  Host work only."""
        while True:
            record = self._pending.get()
            try:
                if record is None:
                    return
                self._recorder.emit(record)
            finally:
                self._pending.task_done()

    def flush(self) -> None:
        """Wait until every record emitted so far is in the file."""
        if self._writer is not None and self._writer.is_alive():
            self._pending.join()

    def events(self) -> List[Dict[str, Any]]:
        """Snapshot of the in-memory ring (newest last)."""
        return list(self.ring)

    def instant(
        self, name: str, trace_id: str = "", **args: Any
    ) -> None:
        """A trace-level instant with no parent request (SLO alerts,
        exemplar markers)."""
        t = threading.current_thread()
        rec: Dict[str, Any] = {
            "v": SCHEMA_VERSION, "ev": "instant", "name": name,
            "cat": "request", "trace": trace_id, "span": new_span_id(),
            "parent": "", "service": self.service,
            "pid": os.getpid(), "tid": t.ident or 0, "thread": t.name,
            "ts": time.time(), "mono": time.monotonic(),
        }
        if args:
            rec["args"] = args
        self.emit(rec)

    def exemplar_exposition(self) -> str:
        """Drain the exemplar store into Prometheus-comment lines the
        /metrics handler appends after the registry exposition.  Comment
        lines are ignored by every scrape parser, so turning exemplars
        on never breaks a consumer; turning tracing off emits nothing —
        the scrape is byte-identical.  Each drained exemplar also lands
        in the trace ring/file (``trace serve --exemplars`` reads it)."""
        drained = self.exemplars.drain()
        if not drained:
            return ""
        lines = []
        for endpoint in sorted(drained):
            latency_s, trace_id = drained[endpoint]
            lines.append(
                f'# exemplar serving_request_latency_seconds'
                f'{{endpoint="{endpoint}"}} trace_id="{trace_id}" '
                f"value={latency_s:.6f}"
            )
            self.instant(
                "exemplar", trace_id=trace_id,
                endpoint=endpoint, latency_s=round(latency_s, 6),
            )
        return "\n".join(lines) + "\n"

    def close(self) -> None:
        global _ACTIVE_TRACERS
        if self._closed:
            return
        self._closed = True
        if self._writer is not None:
            self._pending.put(None)
            self._writer.join(timeout=5.0)
        if self._recorder is not None:
            self._recorder.close()
        with _ACTIVE_LOCK:
            _ACTIVE_TRACERS = max(0, _ACTIVE_TRACERS - 1)


# -------------------------------------------------------- request trace


class RequestTrace:
    """One sampled request's trace context: the root span plus emitters
    for child spans/instants.  Crosses threads explicitly (batcher queue
    items, engine sequences carry it); all methods are thread-safe."""

    __slots__ = (
        "tracer", "trace_id", "root_span", "parent", "endpoint",
        "_t0_wall", "_t0_mono", "_annotations", "_lock", "_finished",
    )

    def __init__(
        self,
        tracer: RequestTracer,
        trace_id: str,
        parent: str,
        endpoint: str,
    ):
        self.tracer = tracer
        self.trace_id = trace_id
        self.root_span = new_span_id()
        self.parent = parent
        self.endpoint = endpoint
        self._t0_wall = time.time()
        self._t0_mono = time.monotonic()
        self._annotations: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self._finished = False

    def traceparent(self) -> str:
        """The header value to hand back (and onward): this request's
        root span becomes the downstream parent."""
        return format_traceparent(self.trace_id, self.root_span)

    # ----------------------------------------------------------- emitters

    def _base(self, ev: str, name: str) -> Dict[str, Any]:
        t = threading.current_thread()
        return {
            "v": SCHEMA_VERSION, "ev": ev, "name": name, "cat": "request",
            "trace": self.trace_id, "span": new_span_id(),
            "parent": self.root_span, "endpoint": self.endpoint,
            "service": self.tracer.service,
            "pid": os.getpid(), "tid": t.ident or 0, "thread": t.name,
            "ts": time.time(), "mono": time.monotonic(),
        }

    def instant(self, name: str, **args: Any) -> None:
        rec = self._base("instant", name)
        if args:
            rec["args"] = args
        self.tracer.emit(rec)

    def complete_span(
        self,
        name: str,
        t0_wall: float,
        t0_mono: float,
        dur_s: float,
        **args: Any,
    ) -> None:
        """A span whose start/duration the caller measured (the batcher
        measured the enqueue instant; the span is emitted at dispatch)."""
        rec = self._base("span", name)
        rec["ts"] = t0_wall
        rec["mono"] = t0_mono
        rec["dur"] = round(max(0.0, dur_s), 6)
        if args:
            rec["args"] = args
        self.tracer.emit(rec)

    def span_from_mono(self, name: str, t0_mono: float, **args: Any) -> None:
        """Span ending NOW whose start is a monotonic instant captured
        earlier (possibly on another thread); the wall start is derived
        from the current clock pair so cross-thread spans still align."""
        now_w, now_m = time.time(), time.monotonic()
        dur = max(0.0, now_m - t0_mono)
        self.complete_span(name, now_w - dur, t0_mono, dur, **args)

    @contextlib.contextmanager
    def span(self, name: str, **args: Any):
        extra: Dict[str, Any] = {}
        t0w, t0m = time.time(), time.monotonic()
        try:
            yield extra
        finally:
            merged = dict(args)
            merged.update(extra)
            self.complete_span(
                name, t0w, t0m, time.monotonic() - t0m, **merged
            )

    def annotate(self, **kv: Any) -> None:
        """Merged into the root span's args at finish (the version lease,
        the replica) — facts discovered after the root opened."""
        with self._lock:
            self._annotations.update(kv)

    def finish(self, code: Any = 200) -> float:
        """Close the root span; returns the request latency (seconds).
        Idempotent — gRPC abort paths can race the finally."""
        with self._lock:
            if self._finished:
                return 0.0
            self._finished = True
            annotations = dict(self._annotations)
        dur = max(0.0, time.monotonic() - self._t0_mono)
        rec = self._base("span", "request")
        rec["ts"] = self._t0_wall
        rec["mono"] = self._t0_mono
        rec["dur"] = round(dur, 6)
        rec["parent"] = self.parent
        rec["span"] = self.root_span
        args: Dict[str, Any] = {"endpoint": self.endpoint, "code": code}
        args.update(annotations)
        rec["args"] = args
        self.tracer.emit(rec)
        self.tracer.exemplars.offer(self.endpoint, dur, self.trace_id)
        return dur
