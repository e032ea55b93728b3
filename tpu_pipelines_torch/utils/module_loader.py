"""Load user module files by path — the ``build_model`` / ``apply_fn``
contract of an exported payload's ``module_copy.py``.

The port's own copy of ``tpu_pipelines/utils/module_loader.py``.
"""

from __future__ import annotations

import importlib.util
import os
import sys
from typing import Any


def load_module(path: str):
    path = os.path.abspath(path)
    name = f"_tppt_user_{abs(hash(path))}_{os.path.splitext(os.path.basename(path))[0]}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load module file {path!r}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        sys.modules.pop(name, None)
        raise
    return module


def load_fn(module_file: str, fn_name: str) -> Any:
    module = load_module(module_file)
    fn = getattr(module, fn_name, None)
    if fn is None:
        raise AttributeError(
            f"module file {module_file!r} defines no {fn_name!r}"
        )
    return fn
