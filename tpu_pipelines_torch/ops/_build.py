"""Build the port's CUDA sources into shared libraries at first use.

``csrc/<name>.cu`` becomes ``_build/<name>-<hash>.so``, compiled by
``nvcc`` for ``sm_90a`` with a plain C interface and loaded with
``ctypes``.  The hash covers every file under ``csrc/`` and the compiler
flags, so an edited source gets a new library and a stale one is never
loaded.  Nothing is built when a module is imported: the first kernel
launch builds (or a caller runs :func:`build` ahead of it).
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


def load(name: str, prototypes: Prototypes) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed,
    with each named C function's ``restype`` / ``argtypes`` set once."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            for fn_name, (restype, argtypes) in prototypes.items():
                fn = getattr(lib, fn_name)
                fn.restype = restype
                fn.argtypes = list(argtypes)
            _LOADED[name] = lib
        return lib
