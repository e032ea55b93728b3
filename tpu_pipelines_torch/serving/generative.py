"""Continuous batching for autoregressive decode: the generative engine.

The port of the core of ``tpu_pipelines/serving/generative.py``.  The
engine batches at the decode-step level (iteration-level scheduling):
sequences join the running batch the moment a slot is free and leave the
moment they emit EOS or reach ``max_new_tokens``, so every step serves
exactly the sequences that still need tokens.

  * **Arena.**  One device-resident state pool of ``max_batch_size`` rows:
    the decode cache (self-attention K/V at ``max_decode_len``,
    cross-attention K/V at the encoder length), and per row the last
    token, position, live flag, encoder output and mask.  Live sequences
    occupy the compacted prefix ``[0, n_live)``: a departure copies the
    last live row into the hole, an arrival's prefill lands at ``n_live``.
    Every update is an in-place copy into the arena's tensors.
  * **Bucketed steps.**  Each step runs the batch bucket (the smallest
    power of two >= the live count) against the KV bucket (the smallest
    page multiple covering the deepest live position): the decode contract
    gets ``arena[:b, :kv]`` views and writes this step's K/V through them.
    ``warm()`` runs every (batch, kv) bucket once before traffic, on a copy
    of the arena, so that no step pays a first run (cuBLAS's kernel choice,
    lazy module loading) mid-traffic; ``compiles_after_warm`` counts the
    buckets whose first run came after ``warm()``.  Pages are the unit of
    ``serving_decode_cache_pages_in_use``.
  * **Identity.**  The per-row math is the scalar-position math greedy
    runs, and masked positions weigh exactly zero, so on the CPU a
    sequence's tokens equal its isolated greedy decode whoever it shared
    steps with.  On the card cuBLAS may pick other kernels at another batch
    size, so there the streams are compared, not required equal.
  * **Admission** counts outstanding tokens (``max_queue_tokens``): live
    remainders plus queued budgets; past the bound a submit raises
    ``EngineOverloaded``.

Each of the reference's decode levers (``prefix_cache_entries``,
``prefill_chunk_pages``, ``spec_tokens`` / ``draft_fns``, per-token SLO
deadlines ``slo_ms_per_token`` / ``hard_deadline``, ``fault_hook``) raises
``NotImplementedError`` naming ROADMAP A8, where they wait with the fleet.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from tpu_pipelines_torch.observability.metrics import fine_latency_buckets
from tpu_pipelines_torch.serving.batching import (
    bucket_sizes,
    validate_generation_params,
)
from tpu_pipelines_torch.trainer.export import resolve_device

log = logging.getLogger("tpu_pipelines_torch.serving")


class EngineOverloaded(RuntimeError):
    """Token-level admission control refused the sequence: outstanding
    decode work (live + queued tokens) would exceed the configured bound
    (an HTTP 429 once the generative fleet serves the engine, ROADMAP A8)."""


class GenerationEvicted(RuntimeError):
    """The sequence was evicted before finishing (the engine closed)."""


@dataclass
class _Sequence:
    """Host-side bookkeeping for one generation.  ``tokens`` mirrors the
    device state: its length is the sequence's next decode position."""

    inputs: np.ndarray              # [max_input_len] padded token ids
    input_mask: np.ndarray          # [max_input_len] 1/0 validity
    max_new_tokens: int
    arrival_s: float
    tokens: List[int] = field(default_factory=list)
    _done: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[BaseException] = None

    def finish(self, error: Optional[BaseException] = None) -> None:
        if self._done.is_set():
            return
        if error is not None:
            self.error = error
        else:
            self.result = np.asarray(self.tokens, np.int32)
        self._done.set()

    def wait(self, timeout_s: float) -> np.ndarray:
        if not self._done.wait(timeout_s):
            raise TimeoutError("generation did not complete in time")
        if self.error is not None:
            raise self.error
        return self.result


def kv_bucket_sizes(max_decode_len: int, page_size: int) -> List[int]:
    """KV-cache length buckets: page, 2*page, 4*page, ... capped at the
    full cache.  ``page_size <= 0`` means one bucket, the whole cache."""
    max_decode_len = int(max_decode_len)
    if max_decode_len <= 0:
        raise ValueError(
            f"max_decode_len must be positive, got {max_decode_len}"
        )
    if page_size <= 0 or page_size >= max_decode_len:
        return [max_decode_len]
    out = []
    k = int(page_size)
    while k < max_decode_len:
        out.append(k)
        k *= 2
    out.append(max_decode_len)
    return sorted(set(out))


def _is_enc_leaf(name: str) -> bool:
    """Cross-attention K/V keep the encoder length on axis 1 and are never
    written by a decode step."""
    return "cached_enc" in name


class GenerativeEngine:
    """One continuous-batching decode engine over one (model, params).

    ``fns`` is the decode contract (``models/t5.py
    make_continuous_decode_fns``): ``prefill``/``step`` plus geometry
    constants; ``params`` are on ``device``.  One worker thread does all
    device work (prefill, bucketed steps, arena copies).  ``submit`` blocks;
    ``submit_nowait`` returns a handle with ``wait(timeout_s)``."""

    # EWMA smoothing of the observed step wall time.
    STEP_EWMA_ALPHA = 0.25

    def __init__(
        self,
        fns,
        params: Dict[str, torch.Tensor],
        *,
        max_batch_size: int = 8,
        page_size: int = 0,
        max_queue_tokens: int = 0,
        slo_ms_per_token: float = 0.0,
        hard_deadline: bool = False,
        prefix_cache_entries: int = 0,
        prefill_chunk_pages: int = 0,
        spec_tokens: int = 0,
        draft_fns: Any = None,
        device: Any = "cuda",
        registry=None,
        replica: str = "0",
        fault_hook: Any = None,
    ):
        deferred = {
            "prefix_cache_entries": prefix_cache_entries,
            "prefill_chunk_pages": prefill_chunk_pages,
            "spec_tokens": spec_tokens,
            "draft_fns": draft_fns,
            "slo_ms_per_token": slo_ms_per_token,
            "hard_deadline": hard_deadline,
            "fault_hook": fault_hook,
        }
        for name, value in deferred.items():
            if value:
                raise NotImplementedError(
                    f"GenerativeEngine({name}=...): the engine's decode levers "
                    "wait for ROADMAP A8"
                )
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        held = sorted({str(t.device) for t in params.values()})
        if held != [str(dev)]:
            raise ValueError(
                f"GenerativeEngine: params on {held}, engine on {dev}; load "
                "the payload onto the engine's device"
            )
        self.fns = fns
        self.params = params
        self.max_decode_len = int(fns.max_decode_len)
        self.eos_id = int(fns.eos_id)
        self.pad_id = int(fns.pad_id)
        self.max_input_len = int(getattr(fns, "max_input_len", 64))
        self.max_batch_size = max(1, int(max_batch_size))
        self.page_size = int(page_size)
        self.max_queue_tokens = max(0, int(max_queue_tokens))
        self.batch_buckets = bucket_sizes(self.max_batch_size)
        self.kv_buckets = kv_bucket_sizes(self.max_decode_len, self.page_size)
        self._page = (
            self.page_size if 0 < self.page_size < self.max_decode_len
            else self.max_decode_len
        )
        self.telemetry = DecodeTelemetry(registry, replica)

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._arena_lock = threading.Lock()
        self._queue: "collections.deque[_Sequence]" = collections.deque()
        self._slots: List[Optional[_Sequence]] = [None] * self.max_batch_size
        self._n_live = 0
        self._closed = False
        # Worker died (device fault): reject new submits at once.
        self._dead = False
        self._arena: Optional[Tuple[Dict[str, torch.Tensor], torch.Tensor,
                                    torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor]] = None
        self._buckets_run: Set[Tuple[int, int]] = set()
        self._warmed = False
        self.compiles_after_warm = 0
        # Traffic's decoder passes: steps, and prefills (each runs one
        # step-0 pass); warm() and the arena's shaping prefill not counted.
        self.steps_run = 0
        self.prefills_run = 0
        # Live rows and bucket rows summed over steps: their ratio is the
        # mean batch occupancy.
        self.live_rows_total = 0
        self.bucket_rows_total = 0
        self.step_ewma_s: Optional[float] = None

        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- device

    def _prefill(self, inputs: np.ndarray, input_mask: np.ndarray):
        """One sequence's encoder pass + step-0 decoder pass; returns
        (cache [1, ...], encoded [1, ...], mask [1, enc_len], first token)."""
        ids = torch.as_tensor(inputs[None], device=self.device).long()
        mask = torch.as_tensor(input_mask[None], device=self.device)
        cache, encoded, logits = self.fns.prefill(self.params, ids, mask)
        return cache, encoded, mask, int(logits[0].argmax())

    def _ensure_arena(self) -> None:
        with self._arena_lock:
            if self._arena is not None:
                return
            zin = np.full((self.max_input_len,), self.pad_id, np.int32)
            zmask = np.zeros((self.max_input_len,), np.int32)
            cache1, encoded1, _, _ = self._prefill(zin, zmask)
            B = self.max_batch_size
            cache = {name: x.new_zeros((B,) + tuple(x.shape[1:]))
                     for name, x in cache1.items()}
            dev = self.device
            # Free rows keep an all-ones encoder mask: cross-attention over
            # their zero K/V then averages zeros instead of softmaxing an
            # all-masked row.  Live rows overwrite it on insert.
            self._arena = (
                cache,
                torch.full((B,), self.pad_id, dtype=torch.long, device=dev),
                torch.zeros((B,), dtype=torch.long, device=dev),
                torch.zeros((B,), dtype=torch.bool, device=dev),
                encoded1.new_zeros((B,) + tuple(encoded1.shape[1:])),
                torch.ones((B, self.max_input_len), dtype=torch.int32,
                           device=dev),
            )

    def _run_step(self, arena, b: int, kv: int) -> torch.Tensor:
        """One decode step of bucket (b, kv) on ``arena``, in place; returns
        the next tokens [b] (pad for dead rows)."""
        cache, tok, pos, live, encoded, enc_mask = arena
        sub = {name: a[:b] if _is_enc_leaf(name) else a[:b, :kv]
               for name, a in cache.items()}
        new, logits = self.fns.step(
            self.params, sub, tok[:b], pos[:b], encoded[:b], enc_mask[:b], kv
        )
        for name, view in sub.items():
            # A contract that returns new tensors instead of writing the
            # views it was given still lands in the arena.
            if new[name] is not view:
                view.copy_(new[name])
        nxt = torch.where(live[:b], logits.argmax(dim=-1), self.pad_id)
        tok[:b] = nxt
        pos[:b] += live[:b].long()
        return nxt

    def _note_bucket(self, b: int, kv: int) -> None:
        if (b, kv) in self._buckets_run:
            return
        self._buckets_run.add((b, kv))
        if self._warmed:
            # The warmup contract: every bucket runs once before traffic.
            self.compiles_after_warm += 1
            self.telemetry.on_compile_after_warm()
            log.warning("generative engine: first run of bucket (%d, %d) "
                        "AFTER warmup: bucket missed by warm()", b, kv)

    def warm(self) -> None:
        """Run the prefill and every ``(batch_bucket, kv_bucket)`` step once
        before traffic, on a copy of the arena (results discarded, the
        arena untouched)."""
        with torch.inference_mode():
            self._ensure_arena()
            zin = np.full((self.max_input_len,), self.pad_id, np.int32)
            self._prefill(zin, np.zeros((self.max_input_len,), np.int32))
            cache, *rest = self._arena
            scratch = ({n: a.clone() for n, a in cache.items()},
                       *(a.clone() for a in rest))
            for b in self.batch_buckets:
                for kv in self.kv_buckets:
                    self._note_bucket(b, kv)
                    self._run_step(scratch, b, kv)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self._warmed = True

    # ------------------------------------------------------------- client

    def outstanding_tokens(self) -> int:
        """Decode work still owed: remaining tokens of live sequences plus
        every queued sequence's full budget."""
        with self._lock:
            return self._outstanding_locked()

    def _outstanding_locked(self) -> int:
        live = sum(
            max(0, s.max_new_tokens - len(s.tokens))
            for s in self._slots[: self._n_live] if s is not None
        )
        return live + sum(s.max_new_tokens for s in self._queue)

    def idle(self) -> bool:
        with self._lock:
            return self._n_live == 0 and not self._queue

    def submit_nowait(
        self,
        inputs,
        *,
        max_new_tokens: Optional[int] = None,
        input_mask=None,
    ) -> _Sequence:
        params = validate_generation_params(
            {} if max_new_tokens is None
            else {"max_new_tokens": max_new_tokens},
            max_decode_len=self.max_decode_len,
        )
        m = params["max_new_tokens"]
        inputs = np.asarray(inputs, np.int32).reshape(-1)
        if inputs.size == 0 or inputs.size > self.max_input_len:
            raise ValueError(
                f"input length must be in [1, {self.max_input_len}], "
                f"got {inputs.size}"
            )
        if input_mask is None:
            mask = np.ones(inputs.shape, np.int32)
        else:
            mask = np.asarray(input_mask, np.int32).reshape(-1)
        pad = self.max_input_len - inputs.size
        inputs = np.pad(inputs, (0, pad), constant_values=self.pad_id)
        mask = np.pad(mask, (0, pad))
        seq = _Sequence(inputs=inputs, input_mask=mask, max_new_tokens=m,
                        arrival_s=time.monotonic())
        with self._cond:
            if self._closed:
                raise RuntimeError("engine is closed")
            if self._dead:
                raise RuntimeError("engine worker died")
            if self.max_queue_tokens > 0:
                owed = self._outstanding_locked()
                if owed + m > self.max_queue_tokens:
                    self.telemetry.on_shed()
                    raise EngineOverloaded(
                        f"outstanding decode tokens {owed} + {m} exceed the "
                        f"bound {self.max_queue_tokens}"
                    )
            self._queue.append(seq)
            self.telemetry.on_queue(self._outstanding_locked())
            self._cond.notify_all()
        return seq

    def submit(
        self,
        inputs,
        *,
        max_new_tokens: Optional[int] = None,
        input_mask=None,
        timeout_s: float = 300.0,
    ) -> np.ndarray:
        """Blocking generate for one sequence; returns the emitted token
        ids (EOS included when hit within budget)."""
        return self.submit_nowait(
            inputs, max_new_tokens=max_new_tokens, input_mask=input_mask
        ).wait(timeout_s)

    def close(self, timeout_s: float = 5.0) -> None:
        """Reject new submits and fail everything unfinished with
        ``GenerationEvicted``."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._worker.join(timeout=timeout_s)
        with self._lock:
            pending = list(self._queue) + [
                s for s in self._slots[: self._n_live] if s is not None
            ]
            self._queue.clear()
            self._n_live = 0
            self._slots = [None] * self.max_batch_size
        for seq in pending:
            seq.finish(GenerationEvicted("engine closed"))

    # ------------------------------------------------------------- worker

    def _run(self) -> None:
        try:
            with torch.inference_mode():
                while True:
                    with self._cond:
                        while (not self._closed and not self._queue
                               and self._n_live == 0):
                            self._cond.wait()
                        if self._closed:
                            return
                    self._admit()
                    if self._n_live:
                        self._step_once()
        except Exception as e:  # noqa: BLE001 — device fault: fail loudly
            log.exception("generative engine worker died")
            with self._lock:
                self._dead = True
                pending = list(self._queue) + [
                    s for s in self._slots[: self._n_live] if s is not None
                ]
                self._queue.clear()
                self._n_live = 0
            for seq in pending:
                seq.finish(e)

    def _admit(self) -> None:
        """Fill free slots from the queue between two decode steps: one
        prefill per admitted sequence, then one copy into the arena."""
        while True:
            with self._lock:
                if not self._queue or self._n_live >= self.max_batch_size:
                    return
                seq = self._queue.popleft()
            self._ensure_arena()
            cache1, enc1, mask1, t0 = self._prefill(seq.inputs, seq.input_mask)
            self.prefills_run += 1
            seq.tokens.append(t0)
            if t0 == self.eos_id or seq.max_new_tokens <= 1:
                self._complete(seq)
                continue
            slot = self._n_live
            cache, tok, pos, live, enc, mask = self._arena
            for name, a in cache.items():
                a[slot].copy_(cache1[name][0])
            tok[slot] = t0
            pos[slot] = 1
            live[slot] = True
            enc[slot].copy_(enc1[0])
            mask[slot].copy_(mask1[0])
            with self._lock:
                self._slots[slot] = seq
                self._n_live += 1

    def _step_once(self) -> None:
        n = self._n_live
        b = next(bk for bk in self.batch_buckets if bk >= n)
        deepest = max(
            len(s.tokens) for s in self._slots[:n] if s is not None
        )
        kv = next(k for k in self.kv_buckets if k >= deepest + 1)
        self._note_bucket(b, kv)
        t0 = time.perf_counter()
        toks = self._run_step(self._arena, b, kv).cpu().numpy()  # the sync
        dt = time.perf_counter() - t0
        if self.step_ewma_s is None:
            self.step_ewma_s = dt
        else:
            a = self.STEP_EWMA_ALPHA
            self.step_ewma_s = (1 - a) * self.step_ewma_s + a * dt
        self.steps_run += 1
        self.live_rows_total += n
        self.bucket_rows_total += b
        pages = sum(
            -(-(len(s.tokens) + 1) // self._page)
            for s in self._slots[:n] if s is not None
        )
        self.telemetry.on_step(self.step_ewma_s, n, b, pages)
        for slot in range(n - 1, -1, -1):
            seq = self._slots[slot]
            t = int(toks[slot])
            seq.tokens.append(t)
            self.telemetry.on_token()
            # Retire the slot BEFORE waking the waiter: the client resumes
            # to consistent accounting.
            if t == self.eos_id or len(seq.tokens) >= seq.max_new_tokens:
                self._retire(slot)
                self._complete(seq)

    def _retire(self, slot: int) -> None:
        """Free ``slot``: the last live row moves into it, then the last
        row is cleared."""
        last = self._n_live - 1
        cache, tok, pos, live, enc, mask = self._arena
        if slot != last:
            for a in (*cache.values(), tok, pos, live, enc, mask):
                a[slot].copy_(a[last])
        tok[last] = self.pad_id
        pos[last] = 0
        live[last] = False
        with self._lock:
            if slot != last:
                self._slots[slot] = self._slots[last]
            self._slots[last] = None
            self._n_live -= 1

    def _complete(self, seq: _Sequence) -> None:
        latency = time.monotonic() - seq.arrival_s
        self.telemetry.on_done(latency, len(seq.tokens))
        seq.finish()


class DecodeTelemetry:
    """The engine's ``serving_decode_*`` series, one label set per replica.
    All methods are no-ops without a registry."""

    def __init__(self, registry=None, replica: str = "0"):
        self.replica = str(replica)
        self._steps = self._tokens = self._seqs = self._shed = None
        self._occ = self._pages = self._active = self._queue_tokens = None
        self._step_s = self._per_token = self._compiles = None
        if registry is None:
            return
        lab = ("replica",)
        self._steps = registry.counter(
            "serving_decode_steps_total",
            "Continuous-batch decode steps executed.", labels=lab,
        ).labels(self.replica)
        self._tokens = registry.counter(
            "serving_decode_tokens_total",
            "Tokens emitted by the continuous-batch engine.", labels=lab,
        ).labels(self.replica)
        self._seqs = registry.counter(
            "serving_decode_sequences_total",
            "Generations completed (EOS or max_new_tokens).", labels=lab,
        ).labels(self.replica)
        self._shed = registry.counter(
            "serving_decode_shed_total",
            "Sequences refused by token-level admission control.",
            labels=lab,
        ).labels(self.replica)
        self._occ = registry.gauge(
            "serving_decode_batch_occupancy",
            "Live sequences / batch bucket of the most recent step.",
            labels=lab,
        ).labels(self.replica)
        self._pages = registry.gauge(
            "serving_decode_cache_pages_in_use",
            "KV-cache pages covering every live sequence's positions.",
            labels=lab,
        ).labels(self.replica)
        self._active = registry.gauge(
            "serving_decode_sequences_active",
            "Sequences live in the decode arena.", labels=lab,
        ).labels(self.replica)
        self._queue_tokens = registry.gauge(
            "serving_decode_queue_tokens",
            "Outstanding decode tokens (live remainder + queued budgets).",
            labels=lab,
        ).labels(self.replica)
        self._step_s = registry.gauge(
            "serving_decode_step_seconds",
            "EWMA wall time of one continuous-batch decode step.",
            labels=lab,
        ).labels(self.replica)
        self._per_token = registry.histogram(
            "serving_decode_per_token_latency_seconds",
            "Completed-generation latency divided by tokens emitted "
            "(fine sqrt(2) buckets).",
            labels=lab, buckets=fine_latency_buckets(),
        ).labels(self.replica)
        self._compiles = registry.counter(
            "serving_decode_compiles_after_warm_total",
            "Decode-step buckets first run AFTER warm(): each one a broken "
            "warmup contract.", labels=lab,
        ).labels(self.replica)

    def on_step(self, ewma, live, bucket, pages) -> None:
        if self._steps is None:
            return
        self._steps.inc()
        self._occ.set(live / max(1, bucket))
        self._pages.set(pages)
        self._active.set(live)
        self._step_s.set(ewma)

    def on_token(self) -> None:
        if self._tokens is not None:
            self._tokens.inc()

    def on_done(self, latency_s: float, n_tokens: int) -> None:
        if self._seqs is None:
            return
        self._seqs.inc()
        self._per_token.observe(latency_s / max(1, n_tokens))

    def on_shed(self) -> None:
        if self._shed is not None:
            self._shed.inc()

    def on_queue(self, outstanding_tokens: int) -> None:
        if self._queue_tokens is not None:
            self._queue_tokens.set(outstanding_tokens)

    def on_compile_after_warm(self) -> None:
        if self._compiles is not None:
            self._compiles.inc()
