"""Span watcher: poll a ``{SPAN}``/``{VERSION}`` pattern for new work.

The port of ``tpu_pipelines/continuous/watcher.py``, the arrival detector
of the continuous controller.  Deliveries are identified by their
``(span, version)`` pair: data inside a delivered directory is immutable,
and corrections arrive as a new ``{VERSION}`` of the same span.  A version
re-delivery of an already-processed span is therefore fresh work; content
edits inside an existing version directory are not watched for (the
execution cache still catches them when the span pipeline runs).

Acknowledgement state is crash-durable when a state path is configured
(``atomic_write_json``): a controller that dies between poll and ack
re-reports the same deliveries on restart, so the loop is at-least-once,
which is safe because the runs it triggers are idempotent through the
execution cache.  An unreadable state file starts from scratch.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Iterable, List, Optional, Tuple

from tpu_pipelines_torch.robustness.atomic import (
    atomic_write_json,
    load_json_tolerant,
)
from tpu_pipelines_torch.utils.span import list_spans

log = logging.getLogger("tpu_pipelines_torch.continuous")


@dataclasses.dataclass(frozen=True)
class SpanDelivery:
    """One (span, version) arrival; ``path`` is the concrete directory."""

    span: int
    version: Optional[int]
    path: str

    @property
    def key(self) -> str:
        return f"{self.span}:{'' if self.version is None else self.version}"


class SpanWatcher:
    """Tracks which ``(span, version)`` deliveries have been processed.

    ``poll()`` returns the unacknowledged deliveries, span-ascending, at
    most one per span: the newest version (superseded versions are
    skipped, not queued).  ``ack()`` marks deliveries processed and
    persists the state.
    """

    def __init__(self, pattern: str, state_path: str = ""):
        self.pattern = pattern
        self.state_path = state_path
        # span -> acknowledged version rank (-1 for a layout without
        # versions; a higher version re-delivery outranks every prior ack).
        self._acked: Dict[int, int] = {}
        if state_path and os.path.exists(state_path):
            raw = load_json_tolerant(state_path) or {}
            try:
                self._acked = {
                    int(k): int(v)
                    for k, v in (raw.get("acked") or {}).items()
                }
            except (AttributeError, TypeError, ValueError):
                log.warning(
                    "span watcher state %r unreadable; starting from "
                    "scratch (at-least-once: already-processed spans "
                    "re-report and cache-hit)", state_path,
                )
                self._acked = {}

    @staticmethod
    def _rank(version: Optional[int]) -> int:
        return -1 if version is None else int(version)

    def seen_spans(self) -> List[int]:
        return sorted(self._acked)

    def poll(self) -> List[SpanDelivery]:
        """Unacknowledged deliveries, one per span, span-ascending."""
        newest: Dict[int, Tuple[Optional[int], str]] = {}
        for span, version, path in list_spans(self.pattern):
            cur = newest.get(span)
            if cur is None or self._rank(version) >= self._rank(cur[0]):
                newest[span] = (version, path)
        return [
            SpanDelivery(span=span, version=version, path=path)
            for span, (version, path) in sorted(newest.items())
            if self._rank(version) > self._acked.get(span, -(1 << 30))
        ]

    def ack(self, deliveries: Iterable[SpanDelivery]) -> None:
        changed = False
        for d in deliveries:
            rank = self._rank(d.version)
            if rank > self._acked.get(d.span, -(1 << 30)):
                self._acked[d.span] = rank
                changed = True
        if changed and self.state_path:
            atomic_write_json(
                self.state_path,
                {"pattern": self.pattern,
                 "acked": {str(k): v for k, v in self._acked.items()}},
            )
