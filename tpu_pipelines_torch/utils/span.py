"""Span/version resolution for ExampleGen input patterns.

TFX ExampleGen's span/version convention (SURVEY.md §2a ExampleGen row):
time-partitioned data lands in numbered directories and the pipeline
ingests the newest — ``input_path="/data/span-{SPAN}"`` resolves to the
highest existing span (or a pinned one), and ``{VERSION}`` inside a span
resolves the same way for re-deliveries of the same span.

The local runner resolves the same pattern before content-fingerprinting
external inputs, so a NEW span arriving at an unchanged pattern string
invalidates the execution cache exactly like editing a named file would.
"""

from __future__ import annotations

import glob as _glob
import re
from typing import List, Optional, Tuple

SPAN_TOKEN = "{SPAN}"
VERSION_TOKEN = "{VERSION}"


def has_span_pattern(path: str) -> bool:
    return SPAN_TOKEN in path or VERSION_TOKEN in path


def _prefix_through(path: str, token: str) -> Tuple[str, str]:
    """Split ``path`` at the end of the path segment containing ``token``:
    resolve tokens left-to-right, one directory level at a time, so a later
    {VERSION} segment (not yet resolved) never reaches glob as a literal."""
    seg_end = path.index(token) + len(token)
    nxt = path.find("/", seg_end)
    if nxt == -1:
        return path, ""
    return path[:nxt], path[nxt:]


def _resolve_token(path: str, token: str, pinned: Optional[int]) -> Tuple[str, int]:
    head, tail = _prefix_through(path, token)
    regex = re.compile(
        re.escape(head).replace(re.escape(token), r"(\d+)") + r"$"
    )
    # glob.escape the literal part so a directory named e.g. "run[1]" is
    # matched literally, not as a glob character class; only the token
    # becomes a wildcard.  ("{" / "}" are not glob metacharacters, so the
    # token survives escaping verbatim.)
    glob_pat = _glob.escape(head).replace(token, "*")
    if pinned is not None:
        # Accept any digit-run equal to the pinned value, so zero-padded
        # layouts (span-001) pin by number, not by string.
        for cand in sorted(_glob.glob(glob_pat)):
            m = regex.match(cand)
            if m and int(m.group(1)) == pinned:
                return cand + tail, pinned
        raise FileNotFoundError(f"no match for {path!r} with {token}={pinned}")
    best: Optional[Tuple[int, str]] = None
    for cand in sorted(_glob.glob(glob_pat)):
        m = regex.match(cand)
        if m:
            n = int(m.group(1))
            if best is None or n > best[0]:
                best = (n, cand)
    if best is None:
        raise FileNotFoundError(f"no spans match pattern {path!r}")
    return best[1] + tail, best[0]


def _matches_for(path: str, token: str) -> List[Tuple[int, str, str]]:
    """All ``(number, concrete_path, remaining_tail)`` for one token level."""
    head, tail = _prefix_through(path, token)
    regex = re.compile(
        re.escape(head).replace(re.escape(token), r"(\d+)") + r"$"
    )
    glob_pat = _glob.escape(head).replace(token, "*")
    out: List[Tuple[int, str, str]] = []
    for cand in sorted(_glob.glob(glob_pat)):
        m = regex.match(cand)
        if m:
            out.append((int(m.group(1)), cand, tail))
    return out


def list_spans(path: str) -> List[Tuple[int, Optional[int], str]]:
    """Enumerate every ``(span, version, path)`` a span pattern matches.

    The continuous controller's watcher surface: where
    :func:`resolve_span_pattern` answers "what is the NEWEST span", this
    answers "what spans exist at all" — including every re-delivered
    ``{VERSION}`` of an already-seen span, so a watcher can treat a
    version re-delivery as a changed span rather than old news.

    Ordering contract: ascending ``(span, version)`` — within one span,
    versions sort by their numeric value, so the LAST entry for a span is
    always its newest delivery (zero-padded layouts order numerically,
    not lexically).  ``version`` is None when the pattern has no
    ``{VERSION}`` token.  A span directory matching ``{SPAN}`` but
    containing no ``{VERSION}`` match is omitted: it has delivered
    nothing yet.  An empty list — the pattern matches nothing — is a
    valid answer here (the watcher polls before data lands), unlike
    ``resolve_span_pattern`` which raises.
    """
    out: List[Tuple[int, Optional[int], str]] = []
    if SPAN_TOKEN not in path:
        raise ValueError(f"pattern {path!r} has no {{SPAN}} token")
    for span, span_path, tail in _matches_for(path, SPAN_TOKEN):
        full = span_path + tail
        if VERSION_TOKEN in full:
            for version, vpath, vtail in _matches_for(full, VERSION_TOKEN):
                out.append((span, version, vpath + vtail))
        else:
            out.append((span, None, full))
    out.sort(key=lambda t: (t[0], t[1] if t[1] is not None else -1))
    return out


def resolve_span_pattern(
    path: str,
    span: Optional[int] = None,
    version: Optional[int] = None,
) -> Tuple[str, Optional[int], Optional[int]]:
    """Resolve {SPAN} (then {VERSION} within it) to a concrete path.

    Returns ``(resolved_path, span, version)`` with None for absent tokens.
    ``span``/``version`` pin specific values; None selects the highest.
    """
    out_span = out_version = None
    if SPAN_TOKEN in path:
        path, out_span = _resolve_token(path, SPAN_TOKEN, span)
    if VERSION_TOKEN in path:
        path, out_version = _resolve_token(path, VERSION_TOKEN, version)
    return path, out_span, out_version
