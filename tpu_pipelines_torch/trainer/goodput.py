"""Goodput/badput accounting for the train loop.

The port's ``GoodputTracker``, after ``tpu_pipelines/trainer/goodput.py``.
The reference records its events through ``ml_goodput_measurement``'s
recorder and asks the library's calculator for the breakdown.  The port
imports neither that library nor the Cloud Logging client it pulls in: it
keeps the same entry list (the library's entry keys and float epoch
timestamps, so the library's ``GoodputCalculator`` can be fed the very
same entries) and computes goodput and badput with its own copy of the
library's algebra (``GoodputCalculator.get_job_goodput`` with the badput
breakdown, ``ml_goodput_measurement`` 0.0.16), trimmed to the events the
loop records:

  - job start and end, device init (the library's "TPU init"), training
    preparation, data loading, and each step's start;
  - no checkpoint-manager or custom badput events, so those kinds are 0.

The algebra, per segment of steps between restarts: productive time is the
sum of the gaps between consecutive step starts; the first step's excess
over the mean of the others is ``program_startup``; steps started after
the step a restart resumed from are ``wasted_progress_from_disruption``;
the gap from the lost step's start to the restart's job start is
``infrastructure_recovery_from_disruption``.  The first data load (and
the first after each restart) is ``data_loading_sync``, the others
``data_loading_async`` (not counted against goodput); the last step runs
to the job's end.  ``other`` is what is left of the job's wall time.

With a ``jsonl_path`` every entry is mirrored to a JSONL file (the
reference's ``<checkpoint_dir>/goodput_log.jsonl``); a failed write counts
in ``goodput_mirror_failures_total``, backs off, is retried once and then
disables the mirror, never the run.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from tpu_pipelines_torch.observability.metrics import default_registry

log = logging.getLogger("tpu_pipelines_torch.trainer")

# The library's entry keys.
JOB_NAME = "job_name"
STEP_COUNT = "step_count"
STEP_START_TIME = "step_start_time"
JOB_START_TIME = "job_start_time"
JOB_END_TIME = "job_end_time"
TPU_INIT_START_TIME = "tpu_init_start_time"
TPU_INIT_END_TIME = "tpu_init_end_time"
TRAINING_PREP_START_TIME = "training_prep_start_time"
TRAINING_PREP_END_TIME = "training_prep_end_time"
DATA_LOADING_START_TIME = "data_loading_start_time"
DATA_LOADING_END_TIME = "data_loading_end_time"

# Badput kinds, named as the library's ``BadputType`` members (lower case).
TPU_INITIALIZATION = "tpu_initialization"
TRAINING_PREP = "training_prep"
PROGRAM_STARTUP = "program_startup"
DATA_LOADING_SYNC = "data_loading_sync"
DATA_LOADING_ASYNC = "data_loading_async"
WASTED_PROGRESS = "wasted_progress_from_disruption"
INFRASTRUCTURE_RECOVERY = "infrastructure_recovery_from_disruption"
OTHER = "other"
BADPUT_KINDS = (
    TPU_INITIALIZATION, TRAINING_PREP, PROGRAM_STARTUP, DATA_LOADING_SYNC,
    DATA_LOADING_ASYNC, WASTED_PROGRESS, INFRASTRUCTURE_RECOVERY, OTHER,
)


def _segment(steps: Dict[int, float], curr_step: int
             ) -> Tuple[float, Dict[str, float], int]:
    """(productive seconds, unproductive seconds by kind, last productive
    step) of one segment of step starts, up to ``curr_step``."""
    if curr_step == 0:
        return 0.0, {}, 0
    items = list(steps.items())
    min_step = min(steps)
    total = first = wasted = 0.0
    others: List[float] = []
    counted = max_productive = 0
    for (prev_step, prev_t), (step, t) in zip(items, items[1:]):
        delta = t - prev_t
        if step <= curr_step:
            if step - 1 != prev_step:
                continue
            delta = max(0.0, delta)
            total += delta
            if prev_step == min_step:
                first = delta
            else:
                others.append(delta)
            counted += 1
            max_productive = prev_step
        else:
            wasted += delta
    if counted == 0:
        return 0.0, {WASTED_PROGRESS: wasted}, 0
    if not others:
        return first, {WASTED_PROGRESS: wasted, PROGRAM_STARTUP: 0.0}, max_productive
    mean = (total - first) / len(others)
    startup = max(0.0, first - mean)
    return (total - startup,
            {PROGRAM_STARTUP: startup, WASTED_PROGRESS: wasted},
            max_productive)


def _accumulate(segment: Dict[str, float], total: Dict[str, float]) -> None:
    for kind, secs in segment.items():
        total[kind] = total.get(kind, 0.0) + secs


def productive_time(entries: List[Dict[str, Any]]
                    ) -> Tuple[float, Dict[str, float], int, int]:
    """(productive seconds, unproductive seconds by kind, last productive
    step, last recorded step) of an entry list."""
    productive = 0.0
    unproductive: Dict[str, float] = {}
    steps: Dict[int, float] = {}
    job_start = job_end = None
    init_start = prep_start = load_start = None
    init_s = prep_s = load_s = 0.0
    sync_loading = True
    pending_sync: Optional[float] = None
    for e in entries:
        if JOB_START_TIME in e:
            job_start = e[JOB_START_TIME]
        if STEP_START_TIME in e:
            step = int(e[STEP_COUNT])
            if step not in steps:
                steps[step] = e[STEP_START_TIME]
            else:
                # A restart resumed from ``step``: the segment so far ends.
                lost_t = steps[list(steps)[-1]]
                seg_prod, seg_unprod, _ = _segment(steps, step)
                productive += seg_prod
                sync_loading = True
                if pending_sync is not None:
                    seg_unprod[DATA_LOADING_SYNC] = (
                        seg_unprod.get(DATA_LOADING_SYNC, 0.0) + pending_sync)
                    pending_sync = None
                if job_start is not None and job_start > lost_t:
                    seg_unprod[INFRASTRUCTURE_RECOVERY] = (
                        seg_unprod.get(INFRASTRUCTURE_RECOVERY, 0.0)
                        + job_start - lost_t)
                _accumulate(seg_unprod, unproductive)
                steps = {step: e[STEP_START_TIME]}
        if JOB_END_TIME in e:
            job_end = e[JOB_END_TIME]
        if TPU_INIT_START_TIME in e:
            init_start = e[TPU_INIT_START_TIME]
        elif TPU_INIT_END_TIME in e and init_start is not None:
            init_s += e[TPU_INIT_END_TIME] - init_start
            init_start = None
        elif TRAINING_PREP_START_TIME in e:
            prep_start = e[TRAINING_PREP_START_TIME]
        elif TRAINING_PREP_END_TIME in e and prep_start is not None:
            prep_s += e[TRAINING_PREP_END_TIME] - prep_start
            prep_start = None
        elif DATA_LOADING_START_TIME in e:
            load_start = e[DATA_LOADING_START_TIME]
        elif DATA_LOADING_END_TIME in e and load_start is not None:
            pending_sync = e[DATA_LOADING_END_TIME] - load_start
            load_s += pending_sync
            if sync_loading:
                unproductive[DATA_LOADING_SYNC] = (
                    unproductive.get(DATA_LOADING_SYNC, 0.0) + pending_sync)
                sync_loading = False
            load_start = None
    unproductive[TPU_INITIALIZATION] = init_s
    unproductive[TRAINING_PREP] = prep_s
    unproductive[DATA_LOADING_ASYNC] = (
        load_s - unproductive.get(DATA_LOADING_SYNC, 0.0))
    if not steps:
        return 0.0, unproductive, 0, 0
    last_step = max(steps)
    seg_prod, seg_unprod, max_productive = _segment(steps, last_step)
    productive += seg_prod
    _accumulate(seg_unprod, unproductive)
    if job_end is not None:
        productive += job_end - steps[last_step]
        max_productive = last_step
    return productive, unproductive, max_productive, last_step


def _microseconds(t: float) -> float:
    """``t`` through a UTC ``datetime`` and back: rounded to the
    microsecond, as the library keeps the job's start and end."""
    return datetime.datetime.fromtimestamp(
        t, tz=datetime.timezone.utc).timestamp()


def job_goodput(entries: List[Dict[str, Any]], now: Optional[float] = None
                ) -> Tuple[float, Dict[str, float], int]:
    """(goodput %, badput % by kind, last productive step), as the
    library's ``get_job_goodput(include_badput_breakdown=True)``."""
    starts = [e[JOB_START_TIME] for e in entries if JOB_START_TIME in e]
    ends = [e[JOB_END_TIME] for e in entries if JOB_END_TIME in e]
    if not starts:
        raise ValueError("goodput: no job start recorded")
    end = ends[-1] if ends else (time.time() if now is None else now)
    total = _microseconds(end) - _microseconds(starts[0])
    if total == 0.0:
        raise ValueError("goodput: the job's total time is zero")
    productive, unproductive, max_productive, _ = productive_time(entries)
    if productive < 0.0 or productive > total:
        raise ValueError("goodput: productive time outside the job's time")
    for kind, secs in unproductive.items():
        if secs < 0.0 or secs > total:
            unproductive[kind] = 0.0
    flat = sum(s for k, s in unproductive.items()
               if k not in (DATA_LOADING_ASYNC, OTHER))
    unproductive[OTHER] = max(0.0, total - productive - flat)
    badput = {
        kind: (unproductive.get(kind, 0.0) / total * 100
               if 0 < unproductive.get(kind, 0.0) < total else 0.0)
        for kind in BADPUT_KINDS
    }
    return productive / total * 100, badput, max_productive


class GoodputTracker:
    """The train loop's recorder: one entry a call, kept in order (and
    mirrored to ``jsonl_path`` when given); :meth:`summary` computes the
    breakdown."""

    def __init__(self, job_name: str = "train", jsonl_path: str = "",
                 mirror_retry_backoff_s: float = 30.0):
        self.job_name = job_name
        self.entries: List[Dict[str, Any]] = []
        self._jsonl_path = jsonl_path
        self._backoff_s = mirror_retry_backoff_s
        self._retry_at: Optional[float] = None
        self._mirror_dead = False
        self._lock = threading.Lock()
        self._m_mirror_failures = default_registry().counter(
            "goodput_mirror_failures_total",
            "Goodput JSONL mirror write failures (OSError).",
        )

    def _record(self, key: str, **extra: Any) -> None:
        entry = {JOB_NAME: self.job_name, **extra, key: time.time()}
        with self._lock:
            self.entries.append(entry)
        self._mirror(entry)

    def _mirror(self, entry: Dict[str, Any]) -> None:
        if not self._jsonl_path or self._mirror_dead:
            return
        if self._retry_at is not None and time.monotonic() < self._retry_at:
            return  # backing off; the entry stays in memory only
        try:
            parent = os.path.dirname(self._jsonl_path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            with open(self._jsonl_path, "a") as f:
                f.write(json.dumps(entry) + "\n")
        except OSError as e:
            self._m_mirror_failures.inc()
            if self._retry_at is None:
                self._retry_at = time.monotonic() + self._backoff_s
                log.warning("goodput jsonl mirror failed (%s); retrying "
                            "once after %gs", e, self._backoff_s)
            else:
                self._mirror_dead = True
                log.warning("goodput jsonl mirror disabled after retry: %s", e)
        else:
            self._retry_at = None

    def job_start(self) -> None:
        self._record(JOB_START_TIME)

    def job_end(self) -> None:
        self._record(JOB_END_TIME)

    def tpu_init_start(self) -> None:
        """Device initialization starts (the library's "TPU init")."""
        self._record(TPU_INIT_START_TIME)

    def tpu_init_end(self) -> None:
        self._record(TPU_INIT_END_TIME)

    def training_prep_start(self) -> None:
        self._record(TRAINING_PREP_START_TIME)

    def training_prep_end(self) -> None:
        self._record(TRAINING_PREP_END_TIME)

    def data_loading_start(self) -> None:
        self._record(DATA_LOADING_START_TIME)

    def data_loading_end(self) -> None:
        self._record(DATA_LOADING_END_TIME)

    def step_start(self, step: int) -> None:
        self._record(STEP_START_TIME, **{STEP_COUNT: int(step)})

    def summary(self) -> Dict[str, Any]:
        """``{"goodput": fraction, "badput": {kind: fraction}, "last_step":
        n}`` (kinds with a zero share left out, as the reference's summary
        leaves them); ``{}`` when nothing can be computed (no job start, a
        zero-length job)."""
        with self._lock:
            entries = list(self.entries)
        try:
            goodput_pct, badput, last_step = job_goodput(entries)
        except ValueError as e:
            log.warning("goodput calculation failed: %s", e)
            return {}
        return {
            "goodput": round(goodput_pct / 100.0, 4),
            "badput": {k: round(p / 100.0, 4) for k, p in badput.items() if p},
            "last_step": int(last_step),
        }
