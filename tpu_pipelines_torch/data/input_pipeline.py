"""Windowed, double-buffered infeed for the train loop.

The port's copy of ``_prefetched`` and ``windowed_infeed`` from
``tpu_pipelines/data/input_pipeline.py``, with the reference's schedule,
its partial tail and its exhaustion behaviour: host batches are stacked
into windows (leading axis = step in window) by a background thread, and
each window is staged on the device one window ahead of the consumer.

:class:`WindowStager` is the port's ``stage_global`` for one device.  On
CUDA it copies the stacked window into pinned host memory and from there
to the device with ``non_blocking=True`` on a stream of its own, and
records an event after the copy; the consumer's stream waits on that
event (:meth:`StagedWindow.wait`) before it reads the window, so the copy
of window k+1 overlaps the steps of window k.  The pinned buffers stay
referenced until :meth:`StagedWindow.release` has seen the copy's event
complete, so no host buffer is reused or freed under a copy in flight.
On the CPU a window is the plain stack, with no pinning and no stream.
The port's ``BatchIterator`` and ``InputConfig`` wait for the taxi slice
(``ROADMAP.md`` A4).
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

Batch = Dict[str, np.ndarray]


class _PrefetchError:
    """Carrier for an exception raised in the prefetch thread."""

    def __init__(self, exc: BaseException):
        self.exc = exc


_PREFETCH_DONE = object()


def _prefetched(source: Iterator[Batch], depth: int) -> Iterator[Batch]:
    """Run ``source`` in a background thread, up to ``depth`` items ahead.

    Order-preserving single producer; an exception re-raises at the
    consumer's matching position.  The consumer abandoning the iterator
    (break, close, GC) sets the stop event, which the producer's bounded
    put observes, so no thread is left behind on an endless source."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def produce() -> None:
        try:
            for item in source:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                else:
                    return
            item = _PREFETCH_DONE
        except BaseException as e:  # noqa: BLE001 — re-raised at the consumer
            item = _PrefetchError(e)
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    thread = threading.Thread(target=produce, name="tpp-prefetch", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _PREFETCH_DONE:
                return
            if isinstance(item, _PrefetchError):
                raise item.exc
            yield item
    finally:
        stop.set()


def windowed_infeed(
    batches: Iterator[Batch],
    window_lengths: Iterator[int],
    stage: Callable[[Batch], Any],
    prefetch: int = 2,
) -> Iterator[Any]:
    """Stack host batches into windows of ``window_lengths`` steps and
    stage each window one ahead of the consumer.

    ``stage`` takes one stacked window (a dict of ``[w, ...]`` arrays) and
    returns its staged form; it runs on the consumer's thread, one window
    ahead, while the stacking runs in :func:`_prefetched`'s thread.  A
    source that ends mid-window yields the partial stack, then ends.
    Yields ``(window_len, staged_window)``."""
    def stacks() -> Iterator[Batch]:
        it = iter(batches)
        for want in window_lengths:
            buf = []
            for _ in range(want):
                nxt = next(it, None)
                if nxt is None:
                    break
                buf.append(nxt)
            if not buf:
                return
            yield {k: np.stack([b[k] for b in buf]) for k in buf[0]}
            if len(buf) < want:
                return

    src = _prefetched(stacks(), prefetch) if prefetch > 0 else stacks()
    pending: "deque" = deque()
    for stacked in src:
        n = len(next(iter(stacked.values())))
        pending.append((n, stage(stacked)))
        if len(pending) > 1:
            yield pending.popleft()
    while pending:
        yield pending.popleft()


class StagedWindow:
    """One stacked window on ``device``: ``tensors`` maps each feature to
    a ``[w, ...]`` tensor.  ``event`` (CUDA only) completes when the
    host-to-device copy has landed; ``host`` holds the pinned buffers the
    copy reads until then."""

    def __init__(self, device: torch.device, tensors: Dict[str, torch.Tensor],
                 event: Optional[Any] = None,
                 host: Optional[Dict[str, torch.Tensor]] = None):
        self.device = device
        self.tensors = tensors
        self.event = event
        self.host = host

    def wait(self) -> None:
        """Make the current stream wait for the copy (no host sync), and
        tell the allocator that stream reads the window's tensors."""
        if self.event is None:
            return
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(self.event)
        for t in self.tensors.values():
            t.record_stream(stream)

    def step(self, i: int) -> Dict[str, torch.Tensor]:
        """Step ``i``'s batch: a view of each stacked tensor."""
        return {k: v[i] for k, v in self.tensors.items()}

    def release(self) -> None:
        """Drop the pinned host buffers once the copy that reads them has
        completed (a wait only if it has not)."""
        if self.event is not None:
            self.event.synchronize()
        self.host = None


class WindowStager:
    """``stage`` for :func:`windowed_infeed` on one device (see the
    module docstring)."""

    def __init__(self, device: Any):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def __call__(self, stacked: Batch) -> StagedWindow:
        host = {k: torch.from_numpy(v) for k, v in stacked.items()}
        if self.stream is None:
            return StagedWindow(self.device,
                                {k: t.to(self.device) for k, t in host.items()})
        host = {k: t.pin_memory() for k, t in host.items()}
        with torch.cuda.stream(self.stream):
            tensors = {k: t.to(self.device, non_blocking=True)
                       for k, t in host.items()}
            event = torch.cuda.Event()
            event.record(self.stream)
        return StagedWindow(self.device, tensors, event, host)
