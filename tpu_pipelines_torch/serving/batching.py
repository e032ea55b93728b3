"""Request micro-batching for the serving path.

The port of ``bucket_sizes``, ``pad_to_bucket``,
``validate_generation_params``, ``token_deadline_s`` and ``RequestBatcher``
from ``tpu_pipelines/serving/batching.py``:

  - concurrent requests coalesce into one device call (per-call launch
    and host overhead amortized, bigger matmuls on the card);
  - the coalesced batch is padded by row repetition up to a fixed bucket
    (powers of two up to ``max_batch_size``), so the device sees a handful
    of shapes.

Rows are padded with copies of the batch's first row (always a valid
feature row) and the pad tail is sliced off before replies fan back out.
The batch closes after the gather window or at ``max_batch_size`` rows.
The window is fixed (``batch_timeout_s``, the TF-Serving
``batch_timeout_micros`` knob) or, with ``slo_p99_s``, derived from the p99
budget minus the observed step time (``gather_window_s``).  The fleet's
supervisor reads ``oldest_work_age_s`` as its wedge signal, and its pool
closes every replica batcher in two phases (``request_close`` /
``join_close``) against one deadline.

Request traces (``observability/request_trace.py``): ``submit`` takes the
caller's trace context (or the calling thread's current one) onto the queue
item, because the worker thread does not see the caller's contextvars; the
worker emits each traced request's ``batch.wait`` and ``model.step`` spans
for the group it rode (:meth:`RequestBatcher._emit_group_spans`).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from tpu_pipelines_torch.observability import request_trace

Batch = Dict[str, np.ndarray]


def bucket_sizes(max_batch_size: int) -> List[int]:
    """[1, 2, 4, ..., max_batch_size] — the batch shapes the device sees."""
    sizes = []
    b = 1
    while b < max_batch_size:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch_size)
    return sizes


def pad_to_bucket(batch: Batch, n_rows: int, buckets: Sequence[int]) -> Batch:
    """Pad every feature to the smallest bucket >= n_rows by repeating row 0.

    A request larger than the top bucket passes through unpadded (it runs
    alone, unsplit — its shape is the caller's to manage)."""
    target = next((b for b in buckets if b >= n_rows), n_rows)
    if target == n_rows:
        return batch
    pad = target - n_rows

    def _pad(v: np.ndarray) -> np.ndarray:
        reps = np.repeat(v[:1], pad, axis=0)
        return np.concatenate([v, reps], axis=0)

    return {k: _pad(np.asarray(v)) for k, v in batch.items()}


# The generate-request parameter surface, validated at submit time so that
# a malformed request is refused with a caller-classified error (HTTP 400)
# instead of failing inside a decode step shared with other sequences.
GENERATION_PARAM_KEYS = frozenset({"max_new_tokens"})


def validate_generation_params(
    raw: Optional[Dict[str, Any]], *, max_decode_len: int
) -> Dict[str, int]:
    """Validate and normalize a generate request's parameters.

    Raises ``ValueError`` for unknown keys and for a non-integer or
    out-of-range ``max_new_tokens``.  Returns ``{"max_new_tokens": int}``
    with the default (the model's full decode budget) filled in."""
    raw = dict(raw or {})
    unknown = sorted(set(raw) - GENERATION_PARAM_KEYS)
    if unknown:
        raise ValueError(
            f"unknown generation parameter(s) {unknown}; "
            f"supported: {sorted(GENERATION_PARAM_KEYS)}"
        )
    m = raw.get("max_new_tokens", max_decode_len)
    if isinstance(m, bool) or not isinstance(m, (int, np.integer)):
        raise ValueError(
            f"max_new_tokens must be an integer, got {type(m).__name__}"
        )
    m = int(m)
    if not 1 <= m <= int(max_decode_len):
        raise ValueError(
            f"max_new_tokens must be in [1, {max_decode_len}], got {m}"
        )
    return {"max_new_tokens": m}


def token_deadline_s(
    arrival_s: float, max_new_tokens: int, slo_ms_per_token: float
) -> Optional[float]:
    """Per-token SLO deadline for one generation: a request decoding N
    tokens earns N x the per-token budget from its arrival instant.  None
    when no per-token SLO is configured."""
    if slo_ms_per_token <= 0:
        return None
    return arrival_s + max_new_tokens * slo_ms_per_token / 1e3


class RequestBatcher:
    """Coalesces concurrent ``submit`` calls into padded device batches.

    One daemon worker drains the queue: it blocks for the first pending
    request, then gathers more until the group's deadline (the oldest
    request's enqueue time + the gather window, fixed or SLO-derived) or
    until ``max_batch_size`` rows, concatenates, pads to a bucket, runs
    ``predict_fn`` ONCE, and distributes row slices back to each caller's
    future.  A request bigger than ``max_batch_size`` runs alone, unsplit.
    """

    # The deadline budgets two step times: the request's own device call
    # plus, worst case, the batch already in flight ahead of it.
    SLO_STEP_BUDGET = 2.0
    # Share of the p99 budget the gather window may spend; the rest is
    # margin for latency the model does not see (transport, scheduling,
    # the scrape histogram's bucket rounding of up to 2x).
    SLO_WINDOW_FRAC = 0.35
    # EWMA smoothing of the observed step time.
    STEP_EWMA_ALPHA = 0.25

    def __init__(
        self,
        predict_fn: Callable[[Batch], Any],
        *,
        max_batch_size: int = 64,
        batch_timeout_s: float = 0.005,
        slo_p99_s: float = 0.0,
        registry=None,
        name: str = "",
    ):
        if max_batch_size < 1:
            raise ValueError(f"max_batch_size must be >= 1, got {max_batch_size}")
        self.predict_fn = predict_fn
        self.max_batch_size = max_batch_size
        self.batch_timeout_s = batch_timeout_s
        self.slo_p99_s = max(0.0, slo_p99_s)
        # Names this batcher in request-trace spans (the replica's name in
        # a fleet); group ids are "<name>-<batch index>".
        self.name = name
        self._last_window_s = batch_timeout_s
        self._step_ewma_s: Optional[float] = None
        self.buckets = bucket_sizes(max_batch_size)
        self.batches_run = 0          # device calls issued
        self.requests_served = 0
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = False
        self._close_lock = threading.Lock()
        # Futures of the group currently inside predict_fn: what close()
        # fails if the worker never comes back.  Written only by the worker.
        self._inflight: List["Future[np.ndarray]"] = []
        # Enqueue instant of the oldest request of that group: the
        # supervisor's wedge signal.  Written only by the worker.
        self._inflight_since: Optional[float] = None
        self._m_batch_size = None
        self._m_batches = None
        self._m_requests = None
        self._m_deadline = None
        self._m_step = None
        if registry is not None:
            registry.gauge(
                "serving_batcher_queue_depth",
                "Requests waiting in the micro-batcher queue.",
            ).set_function(self._queue.qsize)
            self._m_batch_size = registry.gauge(
                "serving_batch_size",
                "Rows in the most recent coalesced device batch.",
            )
            self._m_batches = registry.counter(
                "serving_batches_total",
                "Coalesced device calls issued by the micro-batcher.",
            )
            self._m_requests = registry.counter(
                "serving_batched_requests_total",
                "Requests served through the micro-batcher.",
            )
            self._m_deadline = registry.gauge(
                "serving_batch_deadline_seconds",
                "Effective batch-gather window (SLO-derived when "
                "slo_p99_s is configured, else the fixed timeout).",
            )
            self._m_step = registry.gauge(
                "serving_model_step_seconds",
                "EWMA wall time of one coalesced device call.",
            )
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # --------------------------------------------------- SLO batch window

    def gather_window_s(self) -> float:
        """The wait budget for coalescing the batch that opens now: with
        ``slo_p99_s``, the spendable share of the p99 budget less
        ``SLO_STEP_BUDGET`` observed step times; unconfigured (or before
        the first step) the fixed ``batch_timeout_s``."""
        if self.slo_p99_s <= 0 or self._step_ewma_s is None:
            window = self.batch_timeout_s
        else:
            window = max(
                0.0,
                self.slo_p99_s * self.SLO_WINDOW_FRAC
                - self.SLO_STEP_BUDGET * self._step_ewma_s,
            )
        self._last_window_s = window
        if self._m_deadline is not None:
            self._m_deadline.set(window)
        return window

    def _observe_step(self, step_s: float) -> None:
        if self._step_ewma_s is None:
            self._step_ewma_s = step_s
        else:
            a = self.STEP_EWMA_ALPHA
            self._step_ewma_s = (1 - a) * self._step_ewma_s + a * step_s
        if self._m_step is not None:
            self._m_step.set(self._step_ewma_s)

    def queue_depth(self) -> int:
        return self._queue.qsize()

    @property
    def closed(self) -> bool:
        return self._closed

    # ------------------------------------------------------------- client

    def submit(
        self, batch: Batch, n_rows: int, timeout_s: float = 300.0, ctx=None,
    ) -> np.ndarray:
        """Blocking predict for one request's feature batch (n_rows rows).

        ``timeout_s`` bounds the wait (a first call that builds kernels
        fits with room to spare); a closed batcher raises immediately.
        ``ctx`` is the request trace riding the queue item; None takes the
        calling thread's current trace."""
        if ctx is None:
            ctx = request_trace.current()
        fut: "Future[np.ndarray]" = Future()
        with self._close_lock:
            # Checked under the close lock: a submit racing close() must
            # either enqueue before the worker's final drain or raise — never
            # land in a queue nobody services.
            if self._closed:
                raise RuntimeError("batcher is closed")
            # The enqueue instant anchors the gather deadline.
            self._queue.put((batch, n_rows, fut, time.monotonic(), ctx))
        return fut.result(timeout=timeout_s)

    def oldest_work_age_s(self) -> float:
        """Age of the oldest request this batcher owes an answer, queued or
        inside the current device call: near the gather window when
        healthy, growing without bound behind a wedged device call (the
        supervisor's wedge signal)."""
        oldest = self._inflight_since
        with self._queue.mutex:
            for item in self._queue.queue:
                if item is not None:  # skip the close sentinel
                    if oldest is None or item[3] < oldest:
                        oldest = item[3]
                    break  # FIFO: the first real entry is the oldest
        if oldest is None:
            return 0.0
        return max(0.0, time.monotonic() - oldest)

    def close(self, timeout_s: float = 5.0) -> None:
        """Shut down: reject new submits, serve-or-fail everything queued.

        Every pre-close ``submit`` either completes normally (the worker
        drains the queue ahead of the close sentinel) or gets a
        ``RuntimeError``.  If the worker does not come back within
        ``timeout_s`` (predict_fn wedged), the in-flight group's futures
        are failed too.  The fleet's pool runs the two halves,
        :meth:`request_close` and :meth:`join_close`, over all replicas
        against one deadline."""
        self.request_close()
        self.join_close(timeout_s)

    def request_close(self) -> None:
        """Phase 1 (non-blocking): reject new submits and sentinel the
        worker so it starts draining.  Idempotent."""
        with self._close_lock:
            if not self._closed:
                self._closed = True
                self._queue.put(None)  # wake the worker

    def join_close(self, timeout_s: float = 5.0) -> None:
        """Phase 2: wait for the drain started by :meth:`request_close`;
        past the deadline, fail the wedged in-flight futures."""
        self._worker.join(timeout=timeout_s)
        if self._worker.is_alive():
            for fut in list(self._inflight):
                if not fut.done():
                    try:
                        fut.set_exception(RuntimeError(
                            "batcher closed while request was in flight"
                        ))
                    except Exception:  # noqa: BLE001 — lost the race: done
                        pass
        self._drain_failures("batcher closed")  # anything the worker missed

    # ------------------------------------------------------------- worker

    @staticmethod
    def _signature(batch: Batch):
        """Feature names + per-row shapes + dtype kinds: what must agree for
        requests to share one concatenated device batch."""
        return tuple(sorted(
            (k, np.asarray(v).shape[1:], np.asarray(v).dtype.kind)
            for k, v in batch.items()
        ))

    def _run(self) -> None:
        carry = None  # request popped but deferred to keep batches in budget
        while True:
            item = carry if carry is not None else self._queue.get()
            carry = None
            if item is None:
                self._drain_failures("batcher closed")
                return
            group = [item]
            rows = item[1]
            sig = self._signature(item[0])
            # The window is anchored at the OLDEST request's enqueue
            # instant, so time a request already spent queued behind the
            # previous group counts against it (per-request wait stays
            # bounded by ~one window, not one per preceding group).  A
            # group whose window has already passed closes at once.
            t_end = item[3] + self.gather_window_s()
            while rows < self.max_batch_size:
                remaining = t_end - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._queue.put(None)  # re-post the close sentinel
                    break
                if (
                    rows + nxt[1] > self.max_batch_size
                    or self._signature(nxt[0]) != sig
                ):
                    # Over budget or schema-incompatible (a malformed request
                    # must not poison whoever it queued next to): defer it to
                    # open the next group.
                    carry = nxt
                    break
                group.append(nxt)
                rows += nxt[1]
            self._inflight = [entry[2] for entry in group]
            self._inflight_since = group[0][3]
            try:
                self._execute(group)
            finally:
                self._inflight = []
                self._inflight_since = None

    def _predict_group(self, group) -> None:
        merged = {
            k: np.concatenate(
                [np.asarray(b[k])[:n] for b, n, *_ in group], axis=0
            )
            for k in group[0][0]
        }
        total = sum(n for _, n, *_ in group)
        padded = pad_to_bucket(merged, total, self.buckets)
        group_id = f"{self.name or 'b'}-{self.batches_run}"
        t0_wall = time.time()
        t0 = time.monotonic()
        preds = np.asarray(self.predict_fn(padded))[:total]
        step_s = time.monotonic() - t0
        self._emit_group_spans(group, group_id, total, t0_wall, t0, step_s)
        self._observe_step(step_s)
        self.batches_run += 1
        self.requests_served += len(group)
        if self._m_batches is not None:
            self._m_batches.inc()
            self._m_requests.inc(len(group))
            self._m_batch_size.set(total)
        offset = 0
        for _, n, fut, *_ in group:
            if not fut.done():  # close() may have failed a wedged group
                try:
                    fut.set_result(preds[offset:offset + n])
                except Exception:  # noqa: BLE001 — lost the close race
                    pass
            offset += n

    def _emit_group_spans(
        self, group, group_id: str, total: int,
        t0_wall: float, t0_mono: float, step_s: float,
    ) -> None:
        """Each traced request's spans for one dispatched group: the gather
        wait it paid (enqueue -> dispatch) and the shared device call, with
        the version the fleet leased for it (``request_trace.note`` from
        inside ``predict_fn``).  No-op for untraced requests."""
        if not any(entry[4] is not None for entry in group):
            if request_trace.tracing_active():
                request_trace.take_notes()  # the leased version, now stale
            return
        notes = request_trace.take_notes()
        for _batch, n, _fut, t_enq, ctx in group:
            if ctx is None:
                continue
            wait_s = max(0.0, t0_mono - t_enq)
            ctx.complete_span(
                "batch.wait", t0_wall - wait_s, t_enq, wait_s,
                group=group_id, replica=self.name,
                window_s=round(self._last_window_s, 6),
                requests=len(group),
            )
            ctx.complete_span(
                "model.step", t0_wall, t0_mono, step_s,
                group=group_id, replica=self.name, rows=total,
                request_rows=n, **notes,
            )
            if notes:
                ctx.annotate(**notes)

    def _execute(self, group) -> None:
        try:
            self._predict_group(group)
        except Exception:  # noqa: BLE001 — isolate, then fail only the culprit
            # Same-signature requests can still differ in value validity
            # (out-of-vocab ids): retry one-by-one so a bad request fails
            # alone, TF-Serving style.
            for entry in group:
                try:
                    self._predict_group([entry])
                except Exception as e:  # noqa: BLE001
                    if not entry[2].done():
                        entry[2].set_exception(e)

    def _drain_failures(self, msg: str) -> None:
        sentinel = False
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is None:
                sentinel = True
            else:
                item[2].set_exception(RuntimeError(msg))
        if sentinel:
            # join_close drained the queue while a wedged worker was still
            # inside predict_fn: it must find the sentinel when it returns,
            # or it waits on the queue forever.
            self._queue.put(None)
