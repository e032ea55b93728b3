"""The port stands alone: no JAX, and nothing of the JAX package.

``tpu_pipelines_torch`` and ``chip_smoke.py`` must run on a machine with
PyTorch and no JAX, so they import neither ``jax``/``flax``/``optax``/
``orbax`` nor any ``tpu_pipelines`` module (jax-free ones included), nor
``pyarrow``: the port's data plane is numpy's own ``.npz`` shards, so the
card's machine needs no Parquet reader.  Three
checks: a fresh interpreter imports every module of the port (and
chip_smoke.py, without running it) and then finds none of those in
``sys.modules``; a scan of every import statement in the port's source;
and a scan of every string constant in the port's source (its C++ host
core included) for a path into the JAX package's ``native/`` directory or
a dotted ``tpu_pipelines.`` module name, which an ``importlib`` call or a
build step could reach without an import statement (the analyzer's
reference code names ``tpu_pipelines.ops.autotune`` and
``tpu_pipelines.data.shard_plan``; the port's copy names its own).
"""

import ast
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tpu_pipelines",
             "pyarrow")
# Optional fast paths the reference imports when present; the port runs
# without them, so importing it must not load them.
NOT_AT_IMPORT = ("google_crc32c", "array_record")
# What the reference's trainer extras import (clu's TensorBoard writer,
# which loads TensorFlow; the goodput library): the port writes its event
# files and computes its badput itself, and the card's machine has none of
# these.
NOT_IN_PORT = ("tensorflow", "tensorboard", "clu", "ml_goodput_measurement")


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
phases = sorted(n for n in dir(module) if n.endswith(("_phase", "_setup")))
print(json.dumps({"imported": names, "modules": sorted(sys.modules),
                  "phases": phases}))
"""


def _import_all():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", IMPORT_ALL], cwd=REPO, env={**env, "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=120, check=True,
    )
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_importing_the_port_loads_no_tensorflow_tensorboard_clu_or_goodput():
    report = _import_all()
    for module in ("trainer.goodput", "observability.summary_writer",
                   "trainer.quantize", "components.rewriter",
                   "components.tuner", "components.tuner_algorithms",
                   "components.tuner_trial"):
        assert f"tpu_pipelines_torch.{module}" in report["imported"]
    assert "tune_rewrite_phase" in report["phases"]
    leaked = [m for m in report["modules"] if m.split(".")[0] in NOT_IN_PORT]
    assert leaked == []


def test_no_port_source_imports_tensorflow_tensorboard_clu_or_goodput():
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
            offenders += [(os.path.relpath(path, REPO), n) for n in names
                          if n.split(".")[0] in NOT_IN_PORT]
    assert offenders == []


def test_importing_the_port_loads_no_jax_and_no_reference_module():
    report = _import_all()
    for module in ("serving.server", "ops.flash_attention",
                   "trainer.train_loop", "trainer.fn_args",
                   "observability.health", "examples.bert_module",
                   "models.t5", "serving.generative", "examples.t5_module",
                   "data.input_pipeline", "data.examples_io",
                   "data.statistics", "data.schema", "data.shard_plan",
                   "dsl.compiler", "dsl.component", "metadata.store",
                   "orchestration.local_runner", "transform.graph",
                   "transform.expr", "components.example_gen",
                   "components.statistics_gen", "components.schema_gen",
                   "components.example_validator", "components.transform",
                   "components.trainer", "components.evaluator",
                   "components.infra_validator", "components.pusher",
                   "evaluation.metrics", "models.taxi",
                   "examples.taxi_module", "examples.taxi_pipeline",
                   "examples.taxi_preprocessing", "serving.aot",
                   "serving.fleet", "serving.fleet.fleet",
                   "serving.fleet.pool", "serving.fleet.replica",
                   "serving.fleet.router", "serving.fleet.supervisor",
                   "serving.fleet.versions", "testing.faults",
                   "__main__", "ops.autotune", "observability.trace",
                   "observability.export", "observability.metrics",
                   "data.record_io", "components.importer",
                   "components.resolver", "dsl.cond", "observability.slo",
                   "observability.drift", "continuous",
                   "continuous.controller", "continuous.watcher",
                   "continuous.window", "analysis", "analysis.findings",
                   "analysis.graph_rules", "analysis.code_rules",
                   "metadata.native_store", "ops._build", "models.resnet",
                   "models.mnist", "models.convert", "examples.mnist_module",
                   "examples.mnist_pipeline", "examples.resnet_module",
                   "examples.resnet_pipeline", "parallel.distributed",
                   "parallel.mesh", "parallel.partition",
                   "parallel.collectives", "parallel.ring_attention",
                   "parallel.pipeline_parallel", "models.staged",
                   "examples.staged_module", "examples.staged_pipeline",
                   "trainer.data_parallel", "serving.batching",
                   "observability.request_trace", "observability.federation",
                   "observability.metrics_history", "serving.grpc_server",
                   "serving.prediction_service_pb2", "serving.saved_model"):
        assert f"tpu_pipelines_torch.{module}" in report["imported"]
    assert "chip_smoke" in report["modules"]
    assert {"retrain_dag_phase", "fleet_guard_phase",
            "bert_dag_phase", "continuous_phase",
            "dag_machinery_phase", "vision_train_phase",
            "vision_serving_phase", "vision_dag_phase",
            "dp_train_phase", "engine_levers_phase",
            "serving_surface_phase", "moe_train_phase", "moe_serving_phase",
            "seq_expert_setup", "tp_pp_setup",
            "t5_moe_setup"} <= set(report["phases"])
    leaked = [m for m in report["modules"]
              if _forbidden(m) or m.split(".")[0] in NOT_AT_IMPORT]
    assert leaked == []


DISTRIBUTED = r"""
import json, sys
import torch.distributed as dist
from tpu_pipelines_torch.parallel import (
    collectives, distributed, mesh, partition, pipeline_parallel, ring_attention)
from tpu_pipelines_torch.models import staged
from tpu_pipelines_torch.trainer import data_parallel
m = mesh.make_mesh({"data": 1}, device="cpu")
print(json.dumps({"modules": sorted(sys.modules), "size": m.size,
                  "initialized": dist.is_initialized()}))
"""


def test_torch_distributed_and_the_parallel_modules_load_no_jax():
    """A fresh interpreter imports ``torch.distributed``, the data-,
    sequence-, expert-, tensor- and pipeline-parallel modules
    (``parallel/collectives.py``, ``parallel/pipeline_parallel.py`` and
    ``models/staged.py`` among them) and makes a mesh: nothing of JAX or
    the reference."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", DISTRIBUTED], cwd=REPO,
        env={**env, "PYTHONPATH": REPO}, capture_output=True, text=True,
        timeout=120, check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["size"] == 1 and not report["initialized"]
    assert "torch.distributed" in report["modules"]
    assert [m for m in report["modules"] if _forbidden(m)] == []


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


def _reaches_the_reference(text):
    """A string that names a JAX-package module or its native/ sources."""
    if text.startswith("tpu_pipelines.") or text == "tpu_pipelines":
        return True
    parts = text.replace("\\", "/").split("/")
    return "native" in parts[:-1] or text.startswith("native/") or any(
        p in ("metadata_core.cc", "sqlite3_min.h", "libtppmeta.so",
              "Makefile") and "native" in parts for p in parts)


def test_no_port_source_reads_native_or_names_a_reference_module():
    offenders = []
    for path in _port_sources():
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                if _reaches_the_reference(node.value.strip()):
                    offenders.append((os.path.relpath(path, REPO),
                                      node.lineno, node.value[:60]))
            elif isinstance(node, ast.Call) and (
                getattr(node.func, "attr", "") == "join"
                and any(isinstance(a, ast.Constant) and a.value == "native"
                        for a in node.args)):
                offenders.append((os.path.relpath(path, REPO), node.lineno,
                                  "os.path.join(..., 'native')"))
    host = os.path.join(REPO, "tpu_pipelines_torch", "csrc", "host")
    for name in sorted(os.listdir(host)):
        for i, line in enumerate(open(os.path.join(host, name)), 1):
            if line.lstrip().startswith("#include") and "native/" in line:
                offenders.append((f"csrc/host/{name}", i, line.strip()))
    assert offenders == []
