"""The port stands alone: no JAX, and nothing of the JAX package.

``tpu_pipelines_torch`` and ``chip_smoke.py`` must run on a machine with
PyTorch and no JAX, so they import neither ``jax``/``flax``/``optax``/
``orbax`` nor any ``tpu_pipelines`` module (jax-free ones included).  Two
checks: a fresh interpreter imports every module of the port (and
chip_smoke.py, without running it) and then finds none of those in
``sys.modules``; and a scan of every import statement in the port's source.
"""

import ast
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tpu_pipelines")


def _forbidden(module_name):
    top = module_name.split(".")[0]
    return top in FORBIDDEN


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(os.path.join(REPO, "tpu_pipelines_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


IMPORT_ALL = r"""
import importlib, importlib.util, json, pkgutil, sys
import tpu_pipelines_torch
names = ["tpu_pipelines_torch"] + [
    m.name for m in pkgutil.walk_packages(
        tpu_pipelines_torch.__path__, "tpu_pipelines_torch.")
]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
module = importlib.util.module_from_spec(spec)
sys.modules["chip_smoke"] = module
spec.loader.exec_module(module)       # defines main(); does not run it
print(json.dumps({"imported": names, "modules": sorted(sys.modules)}))
"""


def test_importing_the_port_loads_no_jax_and_no_reference_module():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", IMPORT_ALL], cwd=REPO, env={**env, "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=120, check=True,
    )
    report = json.loads(out.stdout.strip().splitlines()[-1])
    for module in ("serving.server", "ops.flash_attention",
                   "trainer.train_loop", "trainer.fn_args",
                   "observability.health", "examples.bert_module"):
        assert f"tpu_pipelines_torch.{module}" in report["imported"]
    assert "chip_smoke" in report["modules"]
    leaked = [m for m in report["modules"] if _forbidden(m)]
    assert leaked == []


def test_no_port_source_imports_jax_or_the_reference():
    offenders = []
    for path in _port_sources():
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [(os.path.relpath(path, REPO), n)
                          for n in names if _forbidden(n)]
    assert len(_port_sources()) > 10
    assert offenders == []
