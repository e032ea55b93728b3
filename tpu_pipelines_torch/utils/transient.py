"""Transient platform-error classification for the Evaluator's batch loop
(the port's copy of ``tpu_pipelines/utils/transient.py``).

Network- and runtime-shaped flakes are worth a retry; deterministic
failures (ImportError, shape errors, out of memory) are not.
Classification is two-tier: SPECIFIC phrases, seen only in network or
transport flakes, classify as transient on a single hit; BROAD words
(``internal``, ``connection``, ``socket``, ``deadline``) also appear in
deterministic errors, so they classify as transient only when two of them
agree.
"""

from __future__ import annotations

# One hit suffices: these phrases appear in network/transport flakes.
SPECIFIC_MARKERS = (
    "remote_compile",
    "read body",
    "deadline exceeded",
    "deadline_exceeded",
    "timed out",
    "connection reset",
    "connection refused",
    "connection aborted",
    "broken pipe",
    "unavailable",
    "socket closed",
    "socket hang",
)

# Individually too broad (an XLA "INTERNAL: ..." compile bug is
# deterministic); transient only when two distinct words co-occur.
BROAD_MARKERS = ("internal", "connection", "socket", "deadline")


def is_transient_error(msg: str) -> bool:
    """Platform flakes worth retrying — never RESOURCE_EXHAUSTED (a retry
    at the same size would just burn chip time twice), and never a lone
    broad word like ``internal`` (deterministic XLA bugs match it too)."""
    low = msg.lower()
    if "resource_exhausted" in low:
        return False
    if any(m in low for m in SPECIFIC_MARKERS):
        return True
    return sum(1 for m in BROAD_MARKERS if m in low) >= 2
