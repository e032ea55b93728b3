"""Build the port's native sources into shared libraries at first use.

``csrc/<name>.cu`` becomes ``_build/<name>-<hash>.so``, compiled by
``nvcc`` for ``sm_90a`` with a plain C interface and loaded with
``ctypes``.  The hash covers every file under ``csrc/`` and the compiler
flags, so an edited source gets a new library and a stale one is never
loaded.  Nothing is built when a module is imported: the first kernel
launch builds (or a caller runs :func:`build` ahead of it).

The host cores under ``csrc/host/`` (the metadata store's C++ engine) are
built the same way by :func:`load_host`, with ``g++ -O2 -fPIC -std=c++17
-shared``, into ``_build/<name>-<hash>.so``; the hash covers ``csrc/host/``,
the flags and the libraries linked.  The metadata core links the runtime
``libsqlite3`` (:func:`sqlite_library`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Mapping, Sequence, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# C function name -> (restype, argtypes), set once when the library loads.
Prototypes = Mapping[str, Tuple[object, Sequence[object]]]

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the port's CUDA kernels are built from "
        f"{CSRC_DIR} with it"
    )


def _source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.iterdir()):
        if path.suffix in (".cu", ".cuh", ".h"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_source_digest()}.so"


def build(name: str) -> float:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.

    A failed compile raises with the compiler's output.  Returns the
    seconds the compile took (0.0 when the library was already built)."""
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no CUDA source {src}")
    out = library_path(name)
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return time.perf_counter() - t0


def _load(key: str, build_fn, path_fn, prototypes: Prototypes) -> ctypes.CDLL:
    """Build (``build_fn()``) and load ``path_fn()`` once per process under
    ``key``, with each named C function's ``restype`` / ``argtypes`` set."""
    with _LOCK:
        lib = _LOADED.get(key)
        if lib is None:
            build_fn()
            lib = ctypes.CDLL(str(path_fn()))
            for fn_name, (restype, argtypes) in prototypes.items():
                fn = getattr(lib, fn_name)
                fn.restype = restype
                fn.argtypes = list(argtypes)
            _LOADED[key] = lib
        return lib


def load(name: str, prototypes: Prototypes) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    return _load(name, lambda: build(name), lambda: library_path(name),
                 prototypes)


# ------------------------------------------------------------- host cores

HOST_DIR = CSRC_DIR / "host"
GXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")
# Where the runtime SQLite library usually lives (the JAX package's
# native/Makefile looks in the same places).
_SQLITE_CANDIDATES = (
    "/usr/lib/x86_64-linux-gnu/libsqlite3.so",
    "/lib/x86_64-linux-gnu/libsqlite3.so",
    "/usr/lib/x86_64-linux-gnu/libsqlite3.so.0",
    "/lib/x86_64-linux-gnu/libsqlite3.so.0",
)


def sqlite_library() -> str:
    """The runtime SQLite library to link: a system ``libsqlite3.so*``,
    else the one the interpreter's own ``_sqlite3`` module links (``ldd``).
    Raises when neither exists (an interpreter whose ``_sqlite3`` holds
    SQLite statically and a host without the library)."""
    for path in _SQLITE_CANDIDATES:
        if os.path.exists(path):
            return path
    import _sqlite3

    try:
        out = subprocess.run(
            ["ldd", _sqlite3.__file__], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, timeout=30,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"cannot run ldd on {_sqlite3.__file__}: {e}")
    for line in out.splitlines():
        name, _, rest = line.strip().partition(" => ")
        if name.startswith("libsqlite3.so") and rest.startswith("/"):
            return rest.split(" (")[0]
    raise RuntimeError(
        "no libsqlite3 shared library: none of "
        f"{', '.join(_SQLITE_CANDIDATES)} exists and {_sqlite3.__file__} "
        "links none (ldd)"
    )


def _host_digest(libs: Sequence[str]) -> str:
    h = hashlib.sha256(" ".join((*GXX_FLAGS, *libs)).encode())
    for path in sorted(HOST_DIR.iterdir()):
        if path.suffix in (".cc", ".h"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def host_library_path(name: str, libs: Sequence[str] = ()) -> Path:
    return BUILD_DIR / f"{name}-{_host_digest(libs)}.so"


def build_host(name: str, libs: Sequence[str] = ()) -> float:
    """Compile ``csrc/host/<name>.cc`` with ``g++`` (linking ``libs``)
    unless an up-to-date library exists; raises with the compiler's output
    on failure.  Returns the seconds the compile took (0.0 when built)."""
    src = HOST_DIR / f"{name}.cc"
    if not src.is_file():
        raise FileNotFoundError(f"no host source {src}")
    out = host_library_path(name, libs)
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [os.environ.get("CXX") or "g++", *GXX_FLAGS, "-o", str(tmp),
         str(src), *libs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {name}.cc:\n{proc.stdout}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def load_host(
    name: str, prototypes: Prototypes, libs: Sequence[str] = ()
) -> ctypes.CDLL:
    """The loaded library for ``csrc/host/<name>.cc``, built first if
    needed."""
    return _load(f"host:{name}", lambda: build_host(name, libs),
                 lambda: host_library_path(name, libs), prototypes)
