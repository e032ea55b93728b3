"""Error taxonomy: transient vs permanent, decided once, used everywhere
(the port's copy of ``tpu_pipelines/robustness/errors.py``):

  * :class:`TransientError` / :class:`PermanentError` — explicit markers a
    caller can raise to force a classification (an executor that *knows*
    its failure is a preemption wraps it in ``TransientError``; one that
    knows retrying is pointless raises ``PermanentError``).
  * :func:`classify_error` — the shared classifier for everything else:
    connection-level network errors, retriable OS errnos, store
    availability, and dead fork workers are transient; programming and
    configuration errors (TypeError/ValueError/KeyError, missing files,
    permission walls, HTTP responses that *answered*) are permanent.

The default for an unrecognized exception is **transient**: that is the
behavior the runner's legacy ``max_retries`` contract promised (retry
anything), and an executor raising a custom ``FooCrunchError`` over a
flaky device runtime should get its retry.  The permanent list is therefore
a deny-list of failures where a retry provably re-fails: same code, same
inputs, same verdict.
"""

from __future__ import annotations

import errno
from typing import Union

TRANSIENT = "transient"
PERMANENT = "permanent"


class TransientError(RuntimeError):
    """A failure expected to clear on retry (preemption, flaky socket,
    store briefly unavailable).  Raising it — or wrapping a cause in it —
    forces the transient verdict regardless of the wrapped type."""


class PermanentError(RuntimeError):
    """A failure that will reproduce on every retry (bad config, poisoned
    input shard).  Retry loops fail fast on it; quarantine layers treat it
    as an immediate strike-out."""


# OS-level errnos that clear on retry: interrupted syscalls, resource
# pressure, and every flavor of connection-level network failure.  NOT
# here: ENOENT/EACCES/EISDIR/ENOTDIR (configuration), ENOSPC (retrying
# into a full disk re-fails until an operator intervenes).
TRANSIENT_ERRNOS = frozenset(
    getattr(errno, name)
    for name in (
        "EAGAIN", "EINTR", "EBUSY", "EWOULDBLOCK",
        "ECONNREFUSED", "ECONNRESET", "ECONNABORTED", "EPIPE",
        "ETIMEDOUT", "ENETUNREACH", "ENETDOWN", "ENETRESET",
        "EHOSTUNREACH", "EHOSTDOWN", "EADDRINUSE", "EMFILE", "ENFILE",
    )
    if hasattr(errno, name)
)

# Exception types whose retry provably re-fails: the code, config, or
# input is wrong, and running it again changes nothing.
_PERMANENT_TYPES = (
    TypeError, ValueError, KeyError, IndexError, AttributeError,
    AssertionError, NotImplementedError, ImportError, ArithmeticError,
    MemoryError, RecursionError, SyntaxError,
    FileNotFoundError, IsADirectoryError, NotADirectoryError,
    PermissionError, FileExistsError, EOFError,
)


def is_transient(exc: BaseException) -> bool:
    """True when ``exc`` classifies as worth retrying."""
    return classify_error(exc) == TRANSIENT


def classify_error(exc: BaseException) -> str:
    """``"transient"`` or ``"permanent"`` for an exception instance.

    Precedence: explicit markers > exception chain (a TransientError
    anywhere in ``__cause__`` wins) > known families > errno table >
    default-transient.
    """
    # Explicit markers dominate, including via the cause chain: code that
    # does `raise TransientError(...) from oserr` classified the failure
    # itself.
    seen = set()
    node: Union[BaseException, None] = exc
    while node is not None and id(node) not in seen:
        seen.add(id(node))
        if isinstance(node, PermanentError):
            return PERMANENT
        if isinstance(node, TransientError):
            return TRANSIENT
        node = node.__cause__

    # Store-availability and dead-fork-worker failures: the two in-repo
    # families whose whole point is "try again" (imports are lazy so this
    # module stays dependency-light and cycle-free).
    try:
        from tpu_pipelines_torch.metadata.store import StoreUnavailableError

        if isinstance(exc, StoreUnavailableError):
            return TRANSIENT
    except ImportError:  # pragma: no cover - metadata always importable
        pass
    try:
        from concurrent.futures.process import BrokenProcessPool

        if isinstance(exc, BrokenProcessPool):
            return TRANSIENT
    except ImportError:  # pragma: no cover
        pass

    # Network: an HTTP *response* is an answer (the server spoke; its
    # verdict stands — the _urlopen_backoff contract); a connection-level
    # failure is not.
    try:
        import urllib.error

        if isinstance(exc, urllib.error.HTTPError):
            return PERMANENT
        if isinstance(exc, urllib.error.URLError):
            return TRANSIENT
    except ImportError:  # pragma: no cover
        pass
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return TRANSIENT

    if isinstance(exc, _PERMANENT_TYPES):
        return PERMANENT

    if isinstance(exc, OSError):
        # Past the named subclasses above: decide by errno; an errno-less
        # OSError is environmental and gets the retry.
        if exc.errno is None or exc.errno in TRANSIENT_ERRNOS:
            return TRANSIENT
        return PERMANENT

    # Unrecognized (custom executor exceptions, RuntimeError): retry — the
    # legacy max_retries contract.
    return TRANSIENT
