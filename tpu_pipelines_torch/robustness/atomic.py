"""A cross-process writer lock (the port's copy of ``FileLock`` from
``tpu_pipelines/robustness/atomic.py``).

:class:`FileLock` is an ``fcntl.flock``-based inter-process mutex on an
EXISTING path (the metadata SQLite file itself), so it adds no file: no
sidecar ``.lock`` appears next to the store.  flock locks attach to the
open-file-description, so the lock is reopened lazily per pid, and it is
reentrant within a process.  N runners publishing into one store
serialize their transactions instead of racing into ``SQLITE_BUSY``.
"""

from __future__ import annotations

import os
import threading
from typing import Optional


class FileLock:
    """Cross-process exclusive lock via ``flock`` on an existing file.

    Reentrant per process (an internal RLock + depth counter), safe across
    ``fork`` (the fd is reopened lazily in the child — flock state rides
    the open-file-description, so an inherited fd would alias the
    parent's lock).  On platforms without ``fcntl`` (or when the target
    cannot be opened) it degrades to the in-process RLock only, which
    preserves the previous single-process behavior.
    """

    def __init__(self, path: str):
        self.path = path
        self._tlock = threading.RLock()
        self._depth = 0
        self._fd: Optional[int] = None
        self._fd_pid: Optional[int] = None

    def _ensure_fd(self) -> Optional[int]:
        pid = os.getpid()
        if self._fd is not None and self._fd_pid == pid:
            return self._fd
        if self._fd is not None:
            # Forked child: the inherited fd shares the parent's lock
            # state; drop it (close in the child does not release the
            # parent's flock — flock follows the open-file-description,
            # and the parent still holds its own reference).
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None
        try:
            self._fd = os.open(self.path, os.O_RDWR | os.O_CREAT, 0o644)
            self._fd_pid = pid
        except OSError:
            self._fd = None
            self._fd_pid = None
        return self._fd

    def acquire(self) -> None:
        self._tlock.acquire()
        self._depth += 1
        if self._depth > 1:
            return
        fd = self._ensure_fd()
        if fd is None:
            return  # in-process lock only (unopenable path)
        try:
            import fcntl

            fcntl.flock(fd, fcntl.LOCK_EX)
        except (ImportError, OSError):
            pass  # platform without flock: in-process lock only

    def release(self) -> None:
        try:
            if self._depth == 1 and self._fd is not None:
                try:
                    import fcntl

                    fcntl.flock(self._fd, fcntl.LOCK_UN)
                except (ImportError, OSError):
                    pass
        finally:
            self._depth -= 1
            self._tlock.release()

    def close(self) -> None:
        with self._tlock:
            if self._fd is not None and self._fd_pid == os.getpid():
                try:
                    os.close(self._fd)
                except OSError:
                    pass
            self._fd = None
            self._fd_pid = None

    def __enter__(self) -> "FileLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()
