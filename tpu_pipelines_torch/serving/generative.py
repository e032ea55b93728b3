"""Continuous batching for autoregressive decode: the generative engine.

The port of ``tpu_pipelines/serving/generative.py``.  The engine batches at
the decode-step level (iteration-level scheduling): sequences join the
running batch the moment a slot is free and leave the moment they emit EOS
or reach ``max_new_tokens``, so every step serves exactly the sequences
that still need tokens.

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
    of the arena (kernel builds, cuBLAS handles, the model's cached index
    tables), and on CUDA then captures each bucket's step into a
    ``torch.cuda.CUDAGraph`` over the arena itself: capturing runs
    nothing, so the arena is untouched, and each graph holds the arena's
    pointers, the views' strides and the decode kernel's split count of
    its kv bucket.  A step replays its bucket's graph (one pool for the
    engine's graphs, which only the worker replays, one at a time) and
    credits the graph's attention launches to the kernel counters.  A
    bucket first met after ``warm()`` runs eagerly, is captured then and
    counts in ``compiles_after_warm``.  Pages are the unit of
    ``serving_decode_cache_pages_in_use``.
  * **Identity.**  The per-row math is the scalar-position math greedy
    runs, and masked positions weigh exactly zero, so on the CPU a
    sequence's tokens equal its isolated greedy decode whoever it shared
    steps with.  On the card cuBLAS may pick other kernels at another batch
    size, so there the streams are compared, not required equal.
  * **Admission** counts outstanding tokens (``max_queue_tokens``): live
    remainders plus queued budgets; past the bound a submit raises
    ``EngineOverloaded``.  With ``slo_ms_per_token`` each sequence carries
    a token-proportional deadline (``batching.token_deadline_s``);
    ``hard_deadline`` evicts a sequence that passes it
    (``GenerationEvicted``), freeing its slot.

The decode levers, each off by default:

  * **Prefix cache** (``prefix_cache_entries > 0``).  A prompt's key is
    the chain-tip digest of its page-granular blocks of (masked inputs,
    mask) (:meth:`PrefixCache.key_of`).  An entry holds the prefill's
    result (T5: the step-0 cache with the cross-attention K/V, the encoder
    output, the first token); a hit copies it into the arena slot and
    skips the prefill.  The graphs never read an entry.  Entries are
    refcounted: a live sequence admitted from one holds a reader, and
    ``trim`` never evicts an entry with readers.
  * **Chunked prefill** (``prefill_chunk_pages > 0``).  Each decode round
    earns ``prefill_chunk_pages`` admission credits and an admission costs
    the prompt's page count (1 for a hit), so a burst of long prompts is
    spread across rounds.  T5's encoder is bidirectional: chunking bounds
    the admission work between steps, it does not split the encoder's
    math, and the token streams are the same with the knob on or off.
  * **Speculative decoding** (``spec_tokens k > 0``).  A draft lane (a
    second arena mirroring every slot) runs ``k`` chained steps of the
    draft contract (``draft_fns``, or the target's own when None:
    self-draft), then one verify program per (batch, kv) bucket scores the
    ``k`` fed positions (current token + the first k-1 proposals) with the
    contract's ``verify`` (``k`` fused steps when it has none).  Each row
    emits the accepted prefix plus the target's own token at the first
    mismatch, so a wrong draft costs speed, never correctness.  The k-th
    draft step keeps the draft cache gap-free.  The accept then sets both
    lanes' tokens and positions and scrubs every cache position at or
    past a row's new position to zero: rejected speculative KV never
    reaches a logit.  On CUDA ``warm()`` captures every bucket's draft
    step and verify window beside the target's steps, in the engine's one
    pool; the verify window reads its fed tokens from a static device
    buffer and builds its scatter and window bias from device tensors.

The fleet's supervision seam is ``fault_hook``, called once per worker
round while work is live: an exception there kills the worker like a
device fault.  The supervised fleet turns such a death into
``DecodeSessionLost`` and re-prefills the streams onto a surviving
replica.  Request traces ride each sequence (``ctx``): ``decode.join``,
``decode.step`` / ``decode.spec``, ``decode.eos``, ``decode.evict`` and the
whole-lifetime ``decode`` span.
"""

from __future__ import annotations

import collections
import hashlib
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from tpu_pipelines_torch.observability.metrics import fine_latency_buckets
from tpu_pipelines_torch.ops import flash_attention as fa
from tpu_pipelines_torch.serving.aot import capture
from tpu_pipelines_torch.serving.batching import (
    bucket_sizes,
    token_deadline_s,
    validate_generation_params,
)
from tpu_pipelines_torch.trainer.export import resolve_device

log = logging.getLogger("tpu_pipelines_torch.serving")


class EngineOverloaded(RuntimeError):
    """Token-level admission control refused the sequence: outstanding
    decode work (live + queued tokens) would exceed the configured bound.
    HTTP 429 + Retry-After, like ``ServerOverloaded``."""

    retry_after_s = 1


class GenerationEvicted(RuntimeError):
    """The sequence was evicted before finishing: its per-token SLO
    deadline passed under ``hard_deadline``, or the engine closed.  A
    retriable 503."""


class DecodeSessionLost(RuntimeError):
    """A replica died with generations in flight.  Raised by the supervised
    fleet's decode path instead of the raw worker-death error, carrying
    each sequence's committed tokens so the fleet can re-prefill the
    streams onto a surviving replica; greedy decode is deterministic, so
    the recovered stream equals an uninterrupted one."""

    def __init__(self, cause, partial_tokens=None, unfinished=0):
        super().__init__(
            f"decode session lost: {type(cause).__name__}: {cause}"
        )
        self.cause = cause
        self.partial_tokens = list(partial_tokens or [])
        self.unfinished = int(unfinished)


@dataclass
class _Sequence:
    """Host-side bookkeeping for one generation.  ``tokens`` mirrors the
    device state: its length is the sequence's next decode position."""

    inputs: np.ndarray              # [max_input_len] padded token ids
    input_mask: np.ndarray          # [max_input_len] 1/0 validity
    max_new_tokens: int
    arrival_s: float
    deadline_s: Optional[float] = None
    tokens: List[int] = field(default_factory=list)
    _done: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[BaseException] = None
    # The request trace (None = untraced): it rides the sequence into the
    # worker thread, which does not see the caller's contextvars.
    ctx: Any = None
    arrival_wall_s: float = 0.0
    # The prefix-cache entry this live sequence holds a reader on.
    prefix_entry: Any = None

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


class _PrefixEntry:
    """One cached prompt: the prefill's result on the device plus refcount
    and LRU bookkeeping.  ``pages`` is the prompt's page count, the unit of
    ``serving_decode_prefix_pages_in_use`` and of admission credits."""

    __slots__ = (
        "key", "pages", "readers", "tok0", "cache", "encoded",
        "draft_cache", "draft_encoded", "tick",
    )

    def __init__(self, key, pages, tok0, cache, encoded,
                 draft_cache=None, draft_encoded=None):
        self.key = key
        self.pages = int(pages)
        self.readers = 0
        self.tok0 = int(tok0)
        self.cache = cache
        self.encoded = encoded
        self.draft_cache = draft_cache
        self.draft_encoded = draft_encoded
        self.tick = 0


class PrefixCache:
    """Refcounted cache of prefill results keyed by page-granular block
    hashes of the prompt.

    The key is a chain of block digests (block ``i`` folds block ``i-1``'s
    digest with ``page`` positions of masked inputs and mask), so two
    prompts share a key only when the model-visible prompt is identical;
    masked positions are zeroed before hashing.  Every live sequence
    admitted from an entry holds a reader; ``trim`` evicts only entries
    with no readers (least recently used first), so an entry past capacity
    is freed when its last reader retires.  Only the engine's worker
    thread touches it (or the closer, after the worker has been joined)."""

    def __init__(self, capacity: int, page: int):
        self.capacity = max(1, int(capacity))
        self.page = max(1, int(page))
        self._entries: Dict[bytes, _PrefixEntry] = {}
        self._tick = 0
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key_of(
        inputs: np.ndarray, input_mask: np.ndarray, page: int
    ) -> Tuple[bytes, int]:
        """(chain-tip digest, valid-prefix page count) for one padded
        prompt.  The hash covers the full padded width, so the mask's
        structure is part of the key; the page count covers the valid
        tokens only, the prefill work a hit skips."""
        page = max(1, int(page))
        mask = (np.asarray(input_mask) > 0)
        toks = np.asarray(inputs, np.int64) * mask
        m8 = mask.astype(np.int8)
        n_valid = int(mask.sum())
        pages = max(1, -(-n_valid // page))
        h = b""
        for i in range(0, max(toks.size, 1), page):
            h = hashlib.blake2b(
                h + toks[i:i + page].tobytes() + m8[i:i + page].tobytes(),
                digest_size=16,
            ).digest()
        return h, pages

    def __len__(self) -> int:
        return len(self._entries)

    def peek(self, key: bytes) -> Optional[_PrefixEntry]:
        return self._entries.get(key)

    def touch(self, entry: _PrefixEntry) -> None:
        self._tick += 1
        entry.tick = self._tick

    def insert(
        self, key, pages, tok0, cache, encoded,
        draft_cache=None, draft_encoded=None,
    ) -> _PrefixEntry:
        entry = self._entries.get(key)
        if entry is None:
            entry = _PrefixEntry(
                key, pages, tok0, cache, encoded, draft_cache, draft_encoded
            )
            self._entries[key] = entry
        self.touch(entry)
        self.trim()
        return entry

    def acquire(self, entry: _PrefixEntry) -> None:
        entry.readers += 1

    def release(self, entry: _PrefixEntry) -> None:
        entry.readers = max(0, entry.readers - 1)
        self.trim()

    def trim(self) -> None:
        """Evict least recently used reader-free entries down to capacity.
        Entries with readers are pinned, and the most recently touched
        entry is never the victim (a fresh insert into a cache held by
        pinned entries would otherwise evict itself)."""
        while len(self._entries) > self.capacity:
            newest = max(self._entries.values(), key=lambda e: e.tick)
            victims = [
                e for e in self._entries.values()
                if e.readers == 0 and e is not newest
            ]
            if not victims:
                return
            victim = min(victims, key=lambda e: e.tick)
            del self._entries[victim.key]

    def pages_in_use(self) -> int:
        return sum(e.pages for e in self._entries.values())


class _Lane:
    """One arena and the decode contract that steps it: the target lane
    always, the draft lane when speculative.  ``graphs`` maps a (batch, kv)
    bucket to its captured step ``(graph, nxt, logits, tally)``."""

    def __init__(self, name: str, fns, params: Dict[str, torch.Tensor]):
        self.name = name
        self.fns = fns
        self.params = params
        self.arena: Optional[Tuple[Dict[str, torch.Tensor], torch.Tensor,
                                   torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]] = None
        self.graphs: Dict[Tuple[int, int], Tuple[Any, torch.Tensor,
                                                 torch.Tensor,
                                                 Dict[str, int]]] = {}


class GenerativeEngine:
    """One continuous-batching decode engine over one (model, params).

    ``fns`` is the decode contract (``models/t5.py
    make_continuous_decode_fns``): ``prefill``/``step`` (and ``verify``)
    plus geometry constants; ``params`` are on ``device``.  One worker
    thread does all device work (prefill, bucketed steps, arena copies).
    ``submit`` blocks; ``submit_nowait`` returns a handle with
    ``wait(timeout_s)``."""

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
        draft_params: Any = None,
        device: Any = "cuda",
        telemetry: Optional["DecodeTelemetry"] = None,
        registry=None,
        replica: str = "0",
        fault_hook: Any = None,
    ):
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
        self.slo_ms_per_token = max(0.0, float(slo_ms_per_token))
        self.hard_deadline = bool(hard_deadline)
        self.batch_buckets = bucket_sizes(self.max_batch_size)
        self.kv_buckets = kv_bucket_sizes(self.max_decode_len, self.page_size)
        self._page = (
            self.page_size if 0 < self.page_size < self.max_decode_len
            else self.max_decode_len
        )
        # Prompt-side page (prefix hashing, admission credits): the page
        # size, or the whole prompt when unpaged.
        self._ppage = (
            self.page_size if self.page_size > 0 else self.max_input_len
        )
        self.prefix_cache_entries = max(0, int(prefix_cache_entries))
        self._prefix = (
            PrefixCache(self.prefix_cache_entries, self._ppage)
            if self.prefix_cache_entries > 0 else None
        )
        self.prefill_chunk_pages = max(0, int(prefill_chunk_pages))
        self._admit_credits = 0
        self.spec_tokens = max(0, int(spec_tokens))
        self._spec = self.spec_tokens > 0
        self._target = _Lane("target", fns, params)
        self._draft: Optional[_Lane] = None
        if self._spec:
            d = draft_fns if draft_fns is not None else fns
            if (
                int(d.max_decode_len) != self.max_decode_len
                or int(d.eos_id) != self.eos_id
                or int(d.pad_id) != self.pad_id
                or int(getattr(d, "max_input_len", self.max_input_len))
                != self.max_input_len
            ):
                raise ValueError(
                    "draft decode contract must share the target's "
                    "geometry (max_decode_len/eos_id/pad_id/max_input_len)"
                )
            dp = params if draft_params is None else {
                name: t.to(dev) for name, t in draft_params.items()
            }
            self._draft = _Lane("draft", d, dp)
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.telemetry = telemetry or DecodeTelemetry(registry, replica)
        # Supervision seam: called once per worker round while work is live.
        self._fault_hook = fault_hook
        # CUDA: the worker runs every step and arena copy on this stream;
        # the captured programs (target steps, draft steps, verify windows)
        # share one pool.
        self._stream = (torch.cuda.Stream(dev) if dev.type == "cuda"
                        else None)
        self._verify_graphs: Dict[Tuple[int, int],
                                  Tuple[Any, torch.Tensor,
                                        Dict[str, int]]] = {}
        self._pool = None
        # Speculative rounds' device buffers: the fed tokens [B, k] (column
        # 0 the last emitted token, then the draft's proposals) and the
        # accept's new tokens and positions [B].
        self._toks: Optional[torch.Tensor] = None
        self._new_tok: Optional[torch.Tensor] = None
        self._new_pos: Optional[torch.Tensor] = None

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._arena_lock = threading.Lock()
        self._queue: "collections.deque[_Sequence]" = collections.deque()
        self._slots: List[Optional[_Sequence]] = [None] * self.max_batch_size
        self._n_live = 0
        self._closed = False
        # Worker died (device fault): reject new submits at once.
        self._dead = False
        # Buckets run so far: (b, kv) for target steps, ("draft", b, kv)
        # and ("verify", b, kv) for the speculative programs.
        self._buckets_run: Set[Tuple] = set()
        self._warmed = False
        self.compiles_after_warm = 0
        # Traffic's decoder passes: steps (decode rounds), and prefills
        # (each runs one step-0 pass); warm() and the arena's shaping
        # prefill not counted.
        self.steps_run = 0
        self.prefills_run = 0
        self.evictions = 0
        # Traffic's runs of each program kind (a replay or an eager run),
        # and the attention launches their replays credited.
        self.program_runs = {"target": 0, "draft": 0, "verify": 0}
        self.replay_launches = {"target": 0, "draft": 0, "verify": 0}
        # Live rows and bucket rows summed over steps: their ratio is the
        # mean batch occupancy.
        self.live_rows_total = 0
        self.bucket_rows_total = 0
        self.step_ewma_s: Optional[float] = None

        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- device

    def _prefill(self, inputs: np.ndarray, input_mask: np.ndarray,
                 lane: Optional[_Lane] = None):
        """One sequence's encoder pass + step-0 decoder pass; returns
        (cache [1, ...], encoded [1, ...], mask [1, enc_len], first token)."""
        lane = lane or self._target
        ids = torch.as_tensor(inputs[None], device=self.device).long()
        mask = torch.as_tensor(input_mask[None], device=self.device)
        cache, encoded, logits = lane.fns.prefill(lane.params, ids, mask)
        return cache, encoded, mask, int(logits[0].argmax())

    def _blank_arena(self, lane: _Lane):
        zin = np.full((self.max_input_len,), self.pad_id, np.int32)
        zmask = np.zeros((self.max_input_len,), np.int32)
        cache1, encoded1, _, _ = self._prefill(zin, zmask, lane)
        B = self.max_batch_size
        cache = {name: x.new_zeros((B,) + tuple(x.shape[1:]))
                 for name, x in cache1.items()}
        dev = self.device
        # Free rows keep an all-ones encoder mask: cross-attention over
        # their zero K/V then averages zeros instead of softmaxing an
        # all-masked row.  Live rows overwrite it on insert.
        return (
            cache,
            torch.full((B,), self.pad_id, dtype=torch.long, device=dev),
            torch.zeros((B,), dtype=torch.long, device=dev),
            torch.zeros((B,), dtype=torch.bool, device=dev),
            encoded1.new_zeros((B,) + tuple(encoded1.shape[1:])),
            torch.ones((B, self.max_input_len), dtype=torch.int32,
                       device=dev),
        )

    def _ensure_arena(self) -> None:
        with self._arena_lock:
            if self._target.arena is not None:
                return
            self._target.arena = self._blank_arena(self._target)
            if self._spec:
                self._draft.arena = self._blank_arena(self._draft)
                B, dev = self.max_batch_size, self.device
                self._toks = torch.full((B, self.spec_tokens), self.pad_id,
                                        dtype=torch.long, device=dev)
                self._new_tok = torch.full((B,), self.pad_id,
                                           dtype=torch.long, device=dev)
                self._new_pos = torch.zeros((B,), dtype=torch.long,
                                            device=dev)

    @staticmethod
    def _views(arena, b: int, kv: int) -> Dict[str, torch.Tensor]:
        return {name: a[:b] if _is_enc_leaf(name) else a[:b, :kv]
                for name, a in arena[0].items()}

    def _run_step(self, arena, b: int, kv: int, lane: Optional[_Lane] = None):
        """One decode step of bucket (b, kv) on ``arena``, in place; returns
        the next tokens [b] (pad for dead rows) and the step's logits."""
        lane = lane or self._target
        _, tok, pos, live, encoded, enc_mask = arena
        sub = self._views(arena, b, kv)
        new, logits = lane.fns.step(
            lane.params, sub, tok[:b], pos[:b], encoded[:b], enc_mask[:b], kv
        )
        for name, view in sub.items():
            # A contract that returns new tensors instead of writing the
            # views it was given still lands in the arena.
            if new[name] is not view:
                view.copy_(new[name])
        nxt = torch.where(live[:b], logits.argmax(dim=-1), self.pad_id)
        tok[:b] = nxt
        pos[:b] += live[:b].long()
        return nxt, logits

    def _run_verify(self, arena, toks: torch.Tensor, b: int, kv: int):
        """The target's verify window of bucket (b, kv): scores the ``k``
        fed tokens ``toks[:b]`` of each row at positions ``pos .. pos+k-1``
        in one pass (the contract's ``verify``, or ``k`` fused steps
        without it), writing their K/V into the arena in place.  Returns
        the target's greedy picks ``g [b, k]``; tok/pos are left to the
        accept."""
        lane = self._target
        _, _, pos, _, encoded, enc_mask = arena
        sub = self._views(arena, b, kv)
        verify = getattr(lane.fns, "verify", None)
        if verify is not None:
            new, logits = verify(lane.params, sub, toks[:b], pos[:b],
                                 encoded[:b], enc_mask[:b], kv)
        else:
            new, outs = sub, []
            for j in range(toks.shape[1]):
                new, lg = lane.fns.step(lane.params, new, toks[:b, j],
                                        pos[:b] + j, encoded[:b],
                                        enc_mask[:b], kv)
                outs.append(lg)
            logits = torch.stack(outs, dim=1)
        for name, view in sub.items():
            if new[name] is not view:
                view.copy_(new[name])
        return logits.argmax(dim=-1)

    def _accept(self, lane: _Lane) -> None:
        """Set the lane's tokens and positions to ``_new_tok`` /
        ``_new_pos`` and scrub every self-attention cache position at or
        past a row's new position to exact zero, so rejected speculative KV
        never reaches a logit (attention masks those positions anyway)."""
        cache, tok, pos, _, _, _ = lane.arena
        tok.copy_(self._new_tok)
        pos.copy_(self._new_pos)
        for name, a in cache.items():
            if _is_enc_leaf(name):
                continue
            valid = (torch.arange(a.shape[1], device=a.device)[None, :]
                     < self._new_pos[:, None])
            a.mul_(valid.view(valid.shape + (1,) * (a.dim() - 2)).to(a.dtype))

    def _note_bucket(self, key: Tuple, kind: str) -> None:
        if key in self._buckets_run:
            return
        self._buckets_run.add(key)
        if self._warmed:
            # The warmup contract: every bucket runs once before traffic.
            self.compiles_after_warm += 1
            self.telemetry.on_compile_after_warm()
            log.warning("generative engine: first run of %s bucket %s AFTER "
                        "warmup: bucket missed by warm()", kind, key[-2:])

    def _capture_fn(self, fn, what: str, b: int, kv: int):
        try:
            graph, out, tally = capture(fn, stream=self._stream,
                                        pool=self._pool)
        except Exception as e:
            raise RuntimeError(
                f"generative engine: capturing the {what} of bucket "
                f"({b}, {kv}) into a CUDA graph failed: {e}") from e
        if self._pool is None:
            self._pool = graph.pool()
        return graph, out, tally

    def _capture(self, b: int, kv: int, lane: Optional[_Lane] = None) -> None:
        """Capture bucket (b, kv)'s step over the lane's arena (nothing
        runs)."""
        lane = lane or self._target
        what = "decode step" if lane is self._target else "draft step"
        graph, (nxt, logits), tally = self._capture_fn(
            lambda: self._run_step(lane.arena, b, kv, lane), what, b, kv)
        # The logits stay referenced: their pool block is the graph's own,
        # so each replay leaves the step's logits there to be read.
        lane.graphs[(b, kv)] = (graph, nxt, logits, tally)

    def _capture_verify(self, b: int, kv: int) -> None:
        graph, g, tally = self._capture_fn(
            lambda: self._run_verify(self._target.arena, self._toks, b, kv),
            "verify window", b, kv)
        self._verify_graphs[(b, kv)] = (graph, g, tally)

    def _replayed(self, kind: str, graph, tally) -> None:
        graph.replay()
        fa.credit(tally)
        self.replay_launches[kind] += sum(tally.values())
        self.program_runs[kind] += 1

    def _step(self, b: int, kv: int, lane: Optional[_Lane] = None
              ) -> torch.Tensor:
        """Bucket (b, kv)'s step on the lane's arena: its graph's replay,
        or, for a bucket not captured yet, an eager run (then its capture,
        on CUDA)."""
        lane = lane or self._target
        captured = lane.graphs.get((b, kv))
        if captured is not None:
            graph, nxt, _, tally = captured
            self._replayed(lane.name, graph, tally)
            return nxt
        if lane is self._target:
            self._note_bucket((b, kv), "step")
        else:
            self._note_bucket(("draft", b, kv), "draft step")
        self.program_runs[lane.name] += 1
        nxt, _ = self._run_step(lane.arena, b, kv, lane)
        if self._stream is not None and self._warmed:
            self._capture(b, kv, lane)
        return nxt

    def _verify(self, b: int, kv: int) -> torch.Tensor:
        captured = self._verify_graphs.get((b, kv))
        if captured is not None:
            graph, g, tally = captured
            self._replayed("verify", graph, tally)
            return g
        self._note_bucket(("verify", b, kv), "verify")
        self.program_runs["verify"] += 1
        g = self._run_verify(self._target.arena, self._toks, b, kv)
        if self._stream is not None and self._warmed:
            self._capture_verify(b, kv)
        return g

    def warm(self) -> None:
        """Run the prefill and every ``(batch_bucket, kv_bucket)`` program
        once before traffic (target steps; with speculation also the draft
        steps and verify windows), on copies of the arenas (results
        discarded), then, on CUDA, capture every one of them over the
        arenas themselves."""
        def scratch_of(arena):
            cache, *rest = arena
            return ({n: a.clone() for n, a in cache.items()},
                    *(a.clone() for a in rest))

        with torch.inference_mode():
            self._ensure_arena()
            zin = np.full((self.max_input_len,), self.pad_id, np.int32)
            zmask = np.zeros((self.max_input_len,), np.int32)
            self._prefill(zin, zmask)
            scratch = scratch_of(self._target.arena)
            d_scratch = None
            if self._spec:
                self._prefill(zin, zmask, self._draft)
                d_scratch = scratch_of(self._draft.arena)
            for b in self.batch_buckets:
                for kv in self.kv_buckets:
                    self._note_bucket((b, kv), "step")
                    self._run_step(scratch, b, kv)
                    if self._spec:
                        self._note_bucket(("draft", b, kv), "draft step")
                        self._run_step(d_scratch, b, kv, self._draft)
                        self._note_bucket(("verify", b, kv), "verify")
                        self._run_verify(scratch, self._toks, b, kv)
            if self._stream is not None:
                torch.cuda.synchronize(self.device)
                del scratch, d_scratch
                for b in self.batch_buckets:
                    for kv in self.kv_buckets:
                        self._capture(b, kv)
                        if self._spec:
                            self._capture(b, kv, self._draft)
                            self._capture_verify(b, kv)
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

    def active_sequences(self) -> int:
        with self._lock:
            return self._n_live + len(self._queue)

    def idle(self) -> bool:
        with self._lock:
            return self._n_live == 0 and not self._queue

    def submit_nowait(
        self,
        inputs,
        *,
        max_new_tokens: Optional[int] = None,
        input_mask=None,
        ctx=None,
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
        now = time.monotonic()
        seq = _Sequence(
            inputs=inputs, input_mask=mask, max_new_tokens=m, arrival_s=now,
            deadline_s=token_deadline_s(now, m, self.slo_ms_per_token),
            ctx=ctx, arrival_wall_s=time.time(),
        )
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

    def close(self, timeout_s: float = 5.0, *, final_error=None) -> None:
        """Reject new submits and fail everything unfinished with
        ``GenerationEvicted``, or with ``final_error`` when given (the
        supervised rebuild's verdict, so racing waiters recover)."""
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
            self._release_prefix(seq)
            self._trace_end(seq, "evicted")
            seq.finish(final_error or GenerationEvicted("engine closed"))

    # ------------------------------------------------------------- worker

    def _run(self) -> None:
        try:
            with torch.inference_mode(), torch.cuda.stream(self._stream):
                while True:
                    with self._cond:
                        while (not self._closed and not self._queue
                               and self._n_live == 0):
                            self._cond.wait()
                        if self._closed:
                            return
                    if self._fault_hook is not None:
                        self._fault_hook()
                    self._admit()
                    if self._n_live:
                        self._decode_round()
                        if self.prefill_chunk_pages > 0:
                            # Each decode round earns admission credits,
                            # capped at one full prompt so an idle stretch
                            # cannot bank a stall-sized burst.
                            cap = max(
                                self.prefill_chunk_pages,
                                -(-self.max_input_len // self._ppage),
                            )
                            self._admit_credits = min(
                                cap,
                                self._admit_credits + self.prefill_chunk_pages,
                            )
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
                self._release_prefix(seq)
                self._trace_end(seq, "error")
                seq.finish(e)

    def _decode_round(self) -> None:
        """A speculative round when enabled and every live row has
        ``spec_tokens`` positions of cache headroom, else one step."""
        if self._spec:
            deepest = max(len(s.tokens)
                          for s in self._slots[:self._n_live] if s is not None)
            if deepest + self.spec_tokens <= self.max_decode_len:
                self._spec_round()
                return
        self._step_once()

    def _prompt_pages(self, seq: _Sequence) -> int:
        n_valid = int((seq.input_mask > 0).sum())
        return max(1, -(-n_valid // self._ppage))

    def _insert(self, lane: _Lane, slot: int, cache1, enc1, mask1,
                t0: int) -> None:
        cache, tok, pos, live, enc, mask = lane.arena
        for name, a in cache.items():
            a[slot].copy_(cache1[name][0])
        tok[slot] = t0
        pos[slot] = 1
        live[slot] = True
        enc[slot].copy_(enc1[0])
        mask[slot].copy_(mask1[0])

    def _admit(self) -> None:
        """Fill free slots from the queue between two decode rounds: one
        prefill per admitted sequence (or, on a prefix-cache hit, the
        cached result alone) and one copy into each arena, metered by the
        chunked-prefill credits while sequences are live."""
        while True:
            with self._lock:
                if not self._queue or self._n_live >= self.max_batch_size:
                    return
                seq = self._queue[0]
                entry = key = None
                if self._prefix is not None:
                    key, pages = PrefixCache.key_of(
                        seq.inputs, seq.input_mask, self._ppage
                    )
                    entry = self._prefix.peek(key)
                else:
                    pages = self._prompt_pages(seq)
                cost = 1 if entry is not None else pages
                metered = self.prefill_chunk_pages > 0 and self._n_live > 0
                if metered and cost > self._admit_credits:
                    # Not enough credits between rounds: the head stays
                    # queued and decode earns more.
                    return
                self._queue.popleft()
                if metered:
                    self._admit_credits -= cost
            try:
                self._admit_one(seq, entry, key, pages)
            except Exception as e:
                # Out of the queue and in no slot: the worker's death
                # handler would not find it.
                self._release_prefix(seq)
                self._trace_end(seq, "error")
                seq.finish(e)
                raise

    def _admit_one(self, seq: _Sequence, entry, key, pages) -> None:
        """One popped sequence's prefill (or prefix-cache hit) and its copy
        into each arena's next slot."""
        self._ensure_arena()
        mask1 = torch.as_tensor(seq.input_mask[None], device=self.device)
        d_cache1 = d_enc1 = None
        if entry is not None:
            self._prefix.hits += 1
            self._prefix.touch(entry)
            self.telemetry.on_prefix_hit(entry.pages)
            cache1, enc1, t0 = entry.cache, entry.encoded, entry.tok0
            d_cache1, d_enc1 = entry.draft_cache, entry.draft_encoded
        else:
            cache1, enc1, mask1, t0 = self._prefill(seq.inputs,
                                                    seq.input_mask)
            self.prefills_run += 1
            if self._spec:
                d_cache1, d_enc1, _, _ = self._prefill(
                    seq.inputs, seq.input_mask, self._draft)
            if self._prefix is not None:
                self._prefix.misses += 1
                self.telemetry.on_prefix_miss()
                entry = self._prefix.insert(
                    key, pages, t0, cache1, enc1, d_cache1, d_enc1
                )
        seq.tokens.append(t0)
        if t0 == self.eos_id or seq.max_new_tokens <= 1:
            if self._prefix is not None:
                self.telemetry.on_prefix_pages(self._prefix.pages_in_use())
            self._complete(seq)
            return
        if entry is not None:
            self._prefix.acquire(entry)
            seq.prefix_entry = entry
            self.telemetry.on_prefix_pages(self._prefix.pages_in_use())
        slot = self._n_live
        self._insert(self._target, slot, cache1, enc1, mask1, t0)
        if self._spec:
            # The draft lane mirrors the slot: its own prefill cache,
            # the target's first token (the draft always consumes the
            # verified stream).
            self._insert(self._draft, slot, d_cache1, d_enc1, mask1, t0)
        if seq.ctx is not None:
            seq.ctx.span_from_mono(
                "decode.join", seq.arrival_s,
                slot=slot, budget_tokens=seq.max_new_tokens,
                prefix_hit=seq.prefix_entry is not None,
            )
        with self._lock:
            self._slots[slot] = seq
            self._n_live += 1

    def _buckets_for(self, n: int, ahead: int) -> Tuple[int, int]:
        b = next(bk for bk in self.batch_buckets if bk >= n)
        deepest = max(len(s.tokens) for s in self._slots[:n] if s is not None)
        kv = next(k for k in self.kv_buckets if k >= deepest + ahead)
        return b, kv

    def _observe_round(self, dt: float, n: int, b: int) -> None:
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

    def _sync_lane(self, lane: _Lane, new_tok: np.ndarray,
                   new_pos: np.ndarray) -> None:
        self._new_tok.copy_(torch.from_numpy(new_tok))
        self._new_pos.copy_(torch.from_numpy(new_pos))
        self._accept(lane)

    def _spec_round(self) -> None:
        """One speculative round: ``k`` chained draft steps propose, one
        verify window scores all ``k`` fed positions, and each row emits
        the accepted draft prefix plus the target's own token at the first
        mismatch (1..k verified-greedy tokens).  The k-th proposal is never
        judged; its step runs so the draft cache covers every position the
        round can emit."""
        n = self._n_live
        k = self.spec_tokens
        b, kv = self._buckets_for(n, k)
        t0 = time.perf_counter()
        # Column 0: each row's last emitted token (pad for dead rows).
        self._toks[:, 0].copy_(self._target.arena[1])
        for j in range(1, k + 1):
            nxt = self._step(b, kv, self._draft)
            if j < k:
                self._toks[:b, j].copy_(nxt)
        g = self._verify(b, kv)
        fed, gh = torch.stack((self._toks[:b], g)).cpu().numpy()  # the sync
        dt = time.perf_counter() - t0
        self._observe_round(dt, n, b)
        now = time.monotonic()
        B = self.max_batch_size
        new_tok = np.full((B,), self.pad_id, np.int64)
        new_pos = np.zeros((B,), np.int64)
        proposed = accepted = 0
        for i in range(n):
            seq = self._slots[i]
            a = 0
            while a < k - 1 and fed[i, a + 1] == gh[i, a]:
                a += 1
            proposed += k - 1
            accepted += a
            emitted = 0
            for j in range(a + 1):
                t = int(gh[i, j])
                seq.tokens.append(t)
                emitted += 1
                self.telemetry.on_token()
                if t == self.eos_id or len(seq.tokens) >= seq.max_new_tokens:
                    break
            new_tok[i] = seq.tokens[-1]
            new_pos[i] = len(seq.tokens)
            if seq.ctx is not None:
                seq.ctx.instant(
                    "decode.spec", slot=i, token=len(seq.tokens),
                    accepted=a, emitted=emitted, batch_bucket=b,
                    kv_bucket=kv, live=n, step_s=round(dt, 6),
                )
        self.spec_proposed += proposed
        self.spec_accepted += accepted
        self.telemetry.on_spec(proposed, accepted)
        # Both lanes to the emitted stream (rows past n: pad / 0).
        self._sync_lane(self._target, new_tok, new_pos)
        self._sync_lane(self._draft, new_tok, new_pos)
        self._settle(n, now)

    def _step_once(self) -> None:
        n = self._n_live
        b, kv = self._buckets_for(n, 1)
        t0 = time.perf_counter()
        nxt = self._step(b, kv)
        if self._spec:
            # Keeps the draft lane's KV gap-free on the single-step path
            # (no headroom for a speculative round); its guess is then
            # overwritten by the sync below.
            self._step(b, kv, self._draft)
        toks = nxt.cpu().numpy()  # the sync
        if self._spec:
            new_tok = np.full((self.max_batch_size,), self.pad_id, np.int64)
            new_pos = np.zeros((self.max_batch_size,), np.int64)
            for i in range(n):
                new_tok[i] = int(toks[i])
                new_pos[i] = len(self._slots[i].tokens) + 1
            self._sync_lane(self._draft, new_tok, new_pos)
        dt = time.perf_counter() - t0
        self._observe_round(dt, n, b)
        now = time.monotonic()
        for slot in range(n):
            seq = self._slots[slot]
            seq.tokens.append(int(toks[slot]))
            self.telemetry.on_token()
            if seq.ctx is not None:
                seq.ctx.instant(
                    "decode.step", slot=slot, token=len(seq.tokens),
                    batch_bucket=b, kv_bucket=kv, live=n,
                    step_s=round(dt, 6),
                )
        self._settle(n, now)

    def _settle(self, n: int, now: float) -> None:
        """Retire the sequences of the round's ``n`` rows that finished,
        and, under ``hard_deadline``, evict those past their deadline.
        Highest slot first, so a retirement never moves an unvisited row."""
        for slot in range(n - 1, -1, -1):
            seq = self._slots[slot]
            t = seq.tokens[-1]
            # Retire the slot BEFORE waking the waiter: the client resumes
            # to consistent accounting.
            if t == self.eos_id or len(seq.tokens) >= seq.max_new_tokens:
                if seq.ctx is not None and t == self.eos_id:
                    seq.ctx.instant("decode.eos", slot=slot,
                                    tokens=len(seq.tokens))
                self._retire(slot)
                self._complete(seq)
            elif (self.hard_deadline and seq.deadline_s is not None
                  and now > seq.deadline_s):
                self.evictions += 1
                self.telemetry.on_evicted()
                self._retire(slot)
                self._evict_seq(
                    seq, slot,
                    f"per-token SLO deadline exceeded after "
                    f"{len(seq.tokens)}/{seq.max_new_tokens} tokens",
                )

    def _retire(self, slot: int) -> None:
        """Free ``slot`` in every lane: the last live row moves into it,
        then the last row is cleared."""
        last = self._n_live - 1
        lanes = [self._target] + ([self._draft] if self._spec else [])
        for lane in lanes:
            cache, tok, pos, live, enc, mask = lane.arena
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

    def _release_prefix(self, seq: _Sequence) -> None:
        """Drop this sequence's reader on its prefix-cache entry (no-op
        when it holds none); the last reader's release makes an entry past
        capacity evictable."""
        entry = seq.prefix_entry
        if entry is None or self._prefix is None:
            return
        seq.prefix_entry = None
        self._prefix.release(entry)
        self.telemetry.on_prefix_pages(self._prefix.pages_in_use())

    def _complete(self, seq: _Sequence) -> None:
        self._release_prefix(seq)
        latency = time.monotonic() - seq.arrival_s
        self.telemetry.on_done(latency, len(seq.tokens))
        self._trace_end(seq, "complete")
        seq.finish()

    def _evict_seq(self, seq: _Sequence, slot: int, reason: str) -> None:
        self._release_prefix(seq)
        if seq.ctx is not None:
            seq.ctx.instant("decode.evict", slot=slot,
                            tokens=len(seq.tokens), reason=reason)
        self._trace_end(seq, "evicted")
        seq.finish(GenerationEvicted(reason))

    def _trace_end(self, seq: _Sequence, status: str) -> None:
        """The whole-lifetime ``decode`` span (arrival -> end), emitted on
        every terminal edge: EOS, budget, eviction, engine death."""
        if seq.ctx is None:
            return
        seq.ctx.complete_span(
            "decode", seq.arrival_wall_s, seq.arrival_s,
            time.monotonic() - seq.arrival_s,
            status=status, tokens=len(seq.tokens),
            budget_tokens=seq.max_new_tokens,
        )


class DecodeTelemetry:
    """The engine's ``serving_decode_*`` series, one label set per replica.
    All methods are no-ops without a registry."""

    def __init__(self, registry=None, replica: str = "0"):
        self.replica = str(replica)
        self._steps = self._tokens = self._seqs = self._shed = None
        self._occ = self._pages = self._active = self._queue_tokens = None
        self._step_s = self._per_token = self._compiles = None
        self._evicted = None
        self._prefix_hits = self._prefix_misses = None
        self._prefix_hit_pages = self._prefix_pages = None
        self._spec_proposed = self._spec_accept = self._spec_ratio = None
        if registry is None:
            return
        lab = ("replica",)

        def series(kind, name, help_text, **kw):
            return getattr(registry, kind)(
                name, help_text, labels=lab, **kw).labels(self.replica)

        self._steps = series(
            "counter", "serving_decode_steps_total",
            "Continuous-batch decode steps executed.")
        self._tokens = series(
            "counter", "serving_decode_tokens_total",
            "Tokens emitted by the continuous-batch engine.")
        self._seqs = series(
            "counter", "serving_decode_sequences_total",
            "Generations completed (EOS or max_new_tokens).")
        self._evicted = series(
            "counter", "serving_decode_evicted_total",
            "Sequences evicted before finishing (per-token SLO deadline "
            "or engine shutdown).")
        self._shed = series(
            "counter", "serving_decode_shed_total",
            "Sequences refused by token-level admission control.")
        self._occ = series(
            "gauge", "serving_decode_batch_occupancy",
            "Live sequences / batch bucket of the most recent step.")
        self._pages = series(
            "gauge", "serving_decode_cache_pages_in_use",
            "KV-cache pages covering every live sequence's positions.")
        self._active = series(
            "gauge", "serving_decode_sequences_active",
            "Sequences live in the decode arena.")
        self._queue_tokens = series(
            "gauge", "serving_decode_queue_tokens",
            "Outstanding decode tokens (live remainder + queued budgets).")
        self._step_s = series(
            "gauge", "serving_decode_step_seconds",
            "EWMA wall time of one continuous-batch decode step.")
        self._per_token = series(
            "histogram", "serving_decode_per_token_latency_seconds",
            "Completed-generation latency divided by tokens emitted "
            "(fine sqrt(2) buckets).", buckets=fine_latency_buckets())
        self._compiles = series(
            "counter", "serving_decode_compiles_after_warm_total",
            "Decode-step buckets first run AFTER warm(): each one a broken "
            "warmup contract.")
        self._prefix_hits = series(
            "counter", "serving_decode_prefix_hit_total",
            "Admissions served from the prefix cache (prefill skipped).")
        self._prefix_misses = series(
            "counter", "serving_decode_prefix_miss_total",
            "Admissions that ran a full prefill with the prefix cache "
            "enabled.")
        self._prefix_hit_pages = series(
            "counter", "serving_decode_prefix_hit_pages_total",
            "Prompt pages whose prefill was skipped via prefix-cache "
            "hits.")
        self._prefix_pages = series(
            "gauge", "serving_decode_prefix_pages_in_use",
            "Prompt pages resident in the prefix cache (readers pin "
            "entries past capacity until the last one retires).")
        self._spec_proposed = series(
            "counter", "serving_decode_spec_proposed_total",
            "Draft tokens proposed by speculative decoding.")
        self._spec_accept = series(
            "counter", "serving_decode_spec_accept_total",
            "Draft tokens the target verified and accepted.")
        self._spec_ratio = series(
            "gauge", "serving_decode_spec_accept_ratio",
            "Lifetime speculative acceptance rate (accepted / proposed).")

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

    def on_evicted(self) -> None:
        if self._evicted is not None:
            self._evicted.inc()

    def on_shed(self) -> None:
        if self._shed is not None:
            self._shed.inc()

    def on_queue(self, outstanding_tokens: int) -> None:
        if self._queue_tokens is not None:
            self._queue_tokens.set(outstanding_tokens)

    def on_compile_after_warm(self) -> None:
        if self._compiles is not None:
            self._compiles.inc()

    def on_prefix_hit(self, pages: int) -> None:
        if self._prefix_hits is not None:
            self._prefix_hits.inc()
            self._prefix_hit_pages.inc(pages)

    def on_prefix_miss(self) -> None:
        if self._prefix_misses is not None:
            self._prefix_misses.inc()

    def on_prefix_pages(self, pages: int) -> None:
        if self._prefix_pages is not None:
            self._prefix_pages.set(pages)

    def on_spec(self, proposed: int, accepted: int) -> None:
        if self._spec_proposed is None:
            return
        if proposed:
            self._spec_proposed.inc(proposed)
        if accepted:
            self._spec_accept.inc(accepted)
        p = self._spec_proposed.get()
        if p:
            self._spec_ratio.set(self._spec_accept.get() / p)
