"""Crash-consistent file primitives (the port's copy of
``tpu_pipelines/robustness/atomic.py``): atomic writes and a cross-process
writer lock.

:func:`atomic_write_bytes` / :func:`atomic_write_json` write to a temp file
in the same directory, ``fsync`` it, then ``os.replace`` it over the
destination: a reader sees the old file or the new one, never a torn one.
:func:`load_json_tolerant` is the read side: None for a missing or torn
file.  The autotune table (``ops/autotune.py``) is written and read with
them.

:class:`FileLock` is an ``fcntl.flock``-based inter-process mutex on an
EXISTING path (the metadata SQLite file itself), so it adds no file: no
sidecar ``.lock`` appears next to the store.  flock locks attach to the
open-file-description, so the lock is reopened lazily per pid, and it is
reentrant within a process.  N runners publishing into one store
serialize their transactions instead of racing into ``SQLITE_BUSY``.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Any, Optional


def fsync_dir(path: str) -> None:
    """Best-effort fsync of a directory (rename durability on POSIX)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes, do_fsync: bool = True) -> None:
    """Write ``data`` to ``path`` atomically: temp file in the same
    directory + fsync + rename."""
    parent = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(
        prefix=f".{os.path.basename(path)}.", suffix=".tmp", dir=parent
    )
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            if do_fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if do_fsync:
            fsync_dir(parent)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path: str, obj: Any, do_fsync: bool = True) -> None:
    atomic_write_bytes(
        path,
        (json.dumps(obj, sort_keys=True) + "\n").encode("utf-8"),
        do_fsync=do_fsync,
    )


def load_json_tolerant(path: str) -> Optional[Any]:
    """Parse a JSON control file; None for a missing, empty or torn one."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            raw = f.read()
    except OSError:
        return None
    if not raw.strip():
        return None
    try:
        return json.loads(raw)
    except ValueError:
        return None


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
