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

:class:`BatchIterator` and :class:`InputConfig` are the port's copies of
the reference's split reader: dict-of-numpy batches over one split of an
Examples artifact (``data/examples_io.py``), with the same per-epoch
shuffle (``np.random.default_rng((seed, epoch))``), ``drop_remainder``,
``num_epochs``, ``columns`` projection, multi-host shard assignment and
prefetch, so the same seed gives the same batches row for row.  The
reference's Grain backend is not ported.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from tpu_pipelines_torch.data import examples_io

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


def assigned_shard_files(
    shard_rows: list, config: "InputConfig"
) -> Optional[list]:
    """File-granular shard assignment: the shard-file indices this host
    reads (round-robin by file index), or None when file granularity does
    not apply (single host, or fewer files than hosts) and the reader falls
    back to strided rows."""
    if config.num_shards <= 1 or len(shard_rows) < config.num_shards:
        return None
    return list(
        range(config.shard_index, len(shard_rows), config.num_shards)
    )


def per_host_input_config(config: "InputConfig") -> "InputConfig":
    """This host's shard of the input: the port runs one process, so the
    identity (multi-process runs wait, ``ROADMAP.md`` A10)."""
    return config


@dataclasses.dataclass
class InputConfig:
    batch_size: int = 128
    shuffle: bool = True
    seed: int = 0
    drop_remainder: bool = True      # one batch shape
    num_epochs: Optional[int] = None  # None = loop forever
    shard_index: int = 0             # this host's shard (multi-host DP)
    num_shards: int = 1
    # Splits larger than this many rows stream through a shuffle buffer
    # instead of materializing in RAM.
    max_in_memory_rows: int = 2_000_000
    # Shuffle-buffer rows for the streaming path (within-buffer shuffling).
    shuffle_buffer_rows: int = 65536
    # Batches decoded ahead by a background thread (0 = strictly lazy).
    prefetch: int = 2


class BatchIterator:
    """Iterates dict-of-numpy batches over one split of an Examples artifact."""

    def __init__(
        self,
        uri: str,
        split: str,
        config: InputConfig,
        columns: Optional[list] = None,
    ):
        self.config = config
        self._uri, self._split, self._columns = uri, split, columns
        shard_rows = examples_io.shard_row_counts(uri, split)
        n_total = sum(shard_rows)
        self._shard_files = assigned_shard_files(shard_rows, config)
        if self._shard_files is not None:
            shard_n = sum(shard_rows[i] for i in self._shard_files)
        else:
            shard_n = len(range(config.shard_index, n_total, config.num_shards))
        self.streaming = n_total > config.max_in_memory_rows
        if self.streaming:
            self._data = None
            self._indices = None
        else:
            data = examples_io.read_split(
                uri, split, columns, shards=self._shard_files
            )
            if not data:
                raise ValueError(f"empty split {split!r} at {uri}")
            self._data = data
            self._indices = (
                np.arange(shard_n) if self._shard_files is not None
                else np.arange(config.shard_index, n_total, config.num_shards)
            )
        self._n = shard_n
        if self._n < config.batch_size and config.drop_remainder:
            raise ValueError(
                f"split {split!r}: shard has {self._n} rows < batch_size "
                f"{config.batch_size} with drop_remainder"
            )

    @property
    def num_examples(self) -> int:
        return self._n

    def steps_per_epoch(self) -> int:
        if self.config.drop_remainder:
            return self._n // self.config.batch_size
        return -(-self._n // self.config.batch_size)

    def __iter__(self) -> Iterator[Batch]:
        if self.config.prefetch > 0:
            return _prefetched(self._batches(), self.config.prefetch)
        return self._batches()

    def _batches(self) -> Iterator[Batch]:
        cfg = self.config
        epoch = 0
        while cfg.num_epochs is None or epoch < cfg.num_epochs:
            it = (
                self._stream_epoch(epoch) if self.streaming
                else self._memory_epoch(epoch)
            )
            yield from it
            epoch += 1

    def _memory_epoch(self, epoch: int) -> Iterator[Batch]:
        cfg = self.config
        order = self._indices
        if cfg.shuffle:
            rng = np.random.default_rng((cfg.seed, epoch))
            order = rng.permutation(order)
        limit = (
            (self._n // cfg.batch_size) * cfg.batch_size
            if cfg.drop_remainder
            else self._n
        )
        for start in range(0, limit, cfg.batch_size):
            rows = order[start : start + cfg.batch_size]
            yield {k: v[rows] for k, v in self._data.items()}

    def _stream_epoch(self, epoch: int) -> Iterator[Batch]:
        """One pass over the split through a shuffle buffer: every shard
        row once per epoch (modulo the drop_remainder tail), shuffled
        within the buffer."""
        cfg = self.config
        rng = np.random.default_rng((cfg.seed, epoch, 1))
        buffer_rows = max(cfg.batch_size, cfg.shuffle_buffer_rows)
        pending: Optional[Batch] = None
        offset = 0

        def rows_in(pool: Batch) -> int:
            return len(next(iter(pool.values())))

        def drain(pool: Batch, flush: bool):
            n = rows_in(pool)
            order = rng.permutation(n) if cfg.shuffle else np.arange(n)
            usable = n if flush else (n // cfg.batch_size) * cfg.batch_size
            batches = []
            for start in range(0, usable, cfg.batch_size):
                rows = order[start:start + cfg.batch_size]
                if len(rows) < cfg.batch_size and cfg.drop_remainder:
                    break
                batches.append({k: v[rows] for k, v in pool.items()})
            leftover = order[usable:]
            return batches, {k: v[leftover] for k, v in pool.items()}

        for chunk in examples_io.iter_column_chunks(
            self._uri, self._split, self._columns,
            shards=self._shard_files,
        ):
            if self._shard_files is None:
                n = rows_in(chunk)
                take = (
                    np.arange(offset, offset + n) % cfg.num_shards
                ) == cfg.shard_index
                offset += n
                if not take.all():
                    chunk = {k: v[take] for k, v in chunk.items()}
            if rows_in(chunk) == 0:
                continue
            pending = chunk if pending is None else {
                k: np.concatenate([pending[k], chunk[k]]) for k in pending
            }
            if rows_in(pending) >= buffer_rows:
                batches, pending = drain(pending, flush=False)
                yield from batches
        if pending is not None and rows_in(pending):
            batches, _ = drain(pending, flush=True)
            yield from batches
