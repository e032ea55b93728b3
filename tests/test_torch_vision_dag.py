"""Port parity: the MNIST and ResNet pipeline twins against the reference's
pipelines, each through its own package's ``LocalDagRunner`` on the CPU.

  - ``_ensure_data`` of each twin writes the reference's npz byte for byte
    (the same numpy draws from seed 0);
  - both DAGs run once per module in each package, at the sizes of
    ``tests/test_example_pipelines.py`` (MNIST: the default 4096 synthetic
    rows, 4 steps) and ``tests/test_resnet_pipeline.py`` (ResNet-18, width
    8, 4 classes, 8x8 images, 192 rows, 12 steps of 16), and the port's
    a second time, which must be fully cached.  Then: every node
    COMPLETE in both; the hash split puts the same rows in each split; the
    port's payload carries a running mean and variance for every
    BatchNorm (as many values as the reference's ``batch_stats``), moved
    off their init; ``predict`` of raw rows gives [rows, classes] in both;
    the Evaluator's ``metrics.json`` has the reference's keys;
  - a ResNet payload's export, load (eval mode, the buffers bit for bit),
    serving warm-up (no buffer moves) and ``warm_start_init`` carry the
    running statistics.
"""

import contextlib
import filecmp
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from tpu_pipelines.data import examples_io as ref_io
from tpu_pipelines.orchestration import LocalDagRunner as RefRunner
from tpu_pipelines.trainer.export import load_exported_model as ref_load
from tpu_pipelines_torch.data import examples_io as port_io
from tpu_pipelines_torch.examples import mnist_pipeline, resnet_pipeline
from tpu_pipelines_torch.orchestration import LocalDagRunner
from tpu_pipelines_torch.trainer.export import load_exported_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, N_CLASSES, ROWS = 8, 4, 192
RESNET_ENV = {"RESNET_IMAGE_SIZE": str(SIZE), "RESNET_CLASSES": str(N_CLASSES),
              "RESNET_DEPTH": "18", "RESNET_TRAIN_STEPS": "12",
              "RESNET_BATCH": "16"}
RESNET_HPARAMS = {"width": 8, "learning_rate": 0.05}
MNIST_ENV = {"MNIST_TRAIN_STEPS": "4"}


@contextlib.contextmanager
def _env(**values):
    with pytest.MonkeyPatch.context() as mp:
        for k, v in values.items():
            mp.setenv(k, v)
        yield


def _reference(name):
    path = os.path.join(REPO, "examples", name, "pipeline.py")
    spec = importlib.util.spec_from_file_location(f"ref_{name}_pipeline", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _uris(result):
    return {node: {key: arts[0].uri for key, arts in nr.outputs.items()}
            for node, nr in result.nodes.items()}


def _synthetic_npz(path):
    """tests/test_resnet_pipeline.py's images: the mean brightness encodes
    the class."""
    rng = np.random.default_rng(0)
    labels = rng.integers(0, N_CLASSES, size=ROWS)
    base = labels[:, None, None, None] / N_CLASSES
    images = (base + 0.1 * rng.normal(size=(ROWS, SIZE, SIZE, 3))).astype(
        np.float32)
    np.savez(path, image=images.reshape(ROWS, -1), label=labels.astype(np.int64))
    return str(path)


def _with_hparams(pipe, extra):
    trainer = next(c for c in pipe.components if c.id == "Trainer")
    trainer.exec_properties["hyperparameters"] = {
        **trainer.exec_properties["hyperparameters"], **extra}
    return pipe


def test_twins_write_the_reference_npz_bytes(tmp_path):
    with _env(RESNET_IMAGE_SIZE=str(SIZE), RESNET_CLASSES=str(N_CLASSES),
              MNIST_NPZ="", RESNET_NPZ=""):
        for name, twin in (("mnist", mnist_pipeline), ("resnet", resnet_pipeline)):
            want = _reference(name)._ensure_data(str(tmp_path / f"ref_{name}"))
            got = twin._ensure_data(str(tmp_path / f"port_{name}"))
            assert os.path.basename(got) == os.path.basename(want)
            assert filecmp.cmp(got, want, shallow=False), name
    with _env(RESNET_NPZ="/data/given.npz", MNIST_NPZ="/data/mnist.npz"):
        assert resnet_pipeline._ensure_data(str(tmp_path)) == "/data/given.npz"
        assert mnist_pipeline._ensure_data(str(tmp_path)) == "/data/mnist.npz"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (reference result, port cold result, port warm result)}."""
    base = tmp_path_factory.mktemp("vision")
    npz = _synthetic_npz(base / "images.npz")
    out = {}
    for name, twin, env, extra in (
            ("mnist", mnist_pipeline, MNIST_ENV, {}),
            ("resnet", resnet_pipeline, {**RESNET_ENV, "RESNET_NPZ": npz},
             RESNET_HPARAMS)):
        with _env(TPP_TRACE="0", MNIST_NPZ="", **env):
            ref = RefRunner().run(_with_hparams(
                _reference(name).create_pipeline(str(base / f"ref_{name}")), extra))
            port = [LocalDagRunner(device="cpu").run(_with_hparams(
                twin.create_pipeline(str(base / f"port_{name}")), extra))
                for _ in range(2)]
        out[name] = (ref, *port)
    return out


@pytest.mark.parametrize("name", ["mnist", "resnet"])
def test_both_runners_complete_and_the_port_reruns_cached(runs, name):
    ref, cold, warm = runs[name]
    nodes = ["ImportExampleGen", "Trainer", "Evaluator"]
    assert list(ref.nodes) == list(cold.nodes) == nodes
    assert {nr.status for nr in ref.nodes.values()} == {"COMPLETE"}
    assert {nr.status for nr in cold.nodes.values()} == {"COMPLETE"}
    assert {nr.status for nr in warm.nodes.values()} == {"CACHED"}


@pytest.mark.parametrize("name", ["mnist", "resnet"])
def test_hash_split_puts_the_same_rows_in_each_split(runs, name):
    ref, cold, _ = runs[name]
    ref_uri = _uris(ref)["ImportExampleGen"]["examples"]
    port_uri = _uris(cold)["ImportExampleGen"]["examples"]
    for split in ("train", "eval"):
        want = ref_io.read_split(ref_uri, split)
        got = port_io.read_split(port_uri, split)
        np.testing.assert_array_equal(got["label"], np.asarray(want["label"]))
        np.testing.assert_array_equal(
            np.asarray(got["image"]).reshape(len(got["label"]), -1),
            np.stack(np.asarray(want["image"])).reshape(len(got["label"]), -1))


@pytest.mark.parametrize("name,classes,width", [("mnist", 10, 28 * 28),
                                                ("resnet", N_CLASSES, SIZE * SIZE * 3)])
def test_payloads_predict_and_metrics_keys_match(runs, name, classes, width):
    ref, cold, _ = runs[name]
    ref_model = _uris(ref)["Trainer"]["model"]
    port_model = _uris(cold)["Trainer"]["model"]
    want, got = ref_load(ref_model), load_exported_model(port_model, device="cpu")
    assert not got.model.training
    rows = np.random.default_rng(1).normal(size=(4, width)).astype(np.float32)
    assert np.asarray(want.predict({"image": rows})).shape == (4, classes)
    assert got.predict({"image": rows}).shape == (4, classes)

    def metrics(result):
        with open(os.path.join(_uris(result)["Evaluator"]["evaluation"],
                               "metrics.json")) as f:
            return json.load(f)

    got_m, want_m = metrics(cold), metrics(ref)
    assert sorted(got_m) == sorted(want_m) and got_m["problem"] == "multiclass"
    assert [sorted(s["metrics"]) for s in got_m["slices"]] == \
        [sorted(s["metrics"]) for s in want_m["slices"]]
    assert [s["num_examples"] for s in got_m["slices"]] == \
        [s["num_examples"] for s in want_m["slices"]]
    if name != "resnet":
        return
    # The BatchNorm running statistics ship in the payload, moved by
    # training, as many values as the reference's batch_stats.
    buffers = {k: v for k, v in got.params.items()
               if k.endswith(("running_mean", "running_var"))}
    n_ref = sum(np.size(v) for v in
                jax.tree_util.tree_leaves(want.params["batch_stats"]))
    assert sum(v.numel() for v in buffers.values()) == n_ref
    assert len(buffers) == 2 * sum(1 for k in got.params if k.endswith(".bias")
                                   and not k.startswith("head"))
    assert not torch.equal(got.params["bn_init.running_mean"],
                           torch.zeros_like(got.params["bn_init.running_mean"]))
    assert not torch.equal(got.params["bn_init.running_var"],
                           torch.ones_like(got.params["bn_init.running_var"]))


def test_export_load_and_warm_start_carry_the_running_buffers(tmp_path):
    """A ResNet payload's state dict carries every running buffer: the
    loader (``strict=True, assign=True``) puts them on its device with the
    model in eval mode, the serving step reads them, and ``warm_start_init``
    accepts them."""
    from types import SimpleNamespace

    from tpu_pipelines_torch.examples import resnet_module
    from tpu_pipelines_torch.models.resnet import ResNet
    from tpu_pipelines_torch.serving import aot
    from tpu_pipelines_torch.trainer.export import export_model, warm_start_init

    hp = {"depth": 18, "width": 8, "num_classes": N_CLASSES, "image_size": SIZE}
    model = resnet_module.build_model(hp).train()
    images = torch.from_numpy(np.random.default_rng(2).normal(
        size=(16, SIZE, SIZE, 3)).astype(np.float32))
    with torch.no_grad():
        model(images)                  # moves the running statistics
    uri = export_model(serving_model_dir=str(tmp_path / "1"),
                       params=model.state_dict(),
                       module_file=resnet_module.__file__, hyperparameters=hp)
    loaded = load_exported_model(uri, device="cpu")
    want = model.state_dict()
    buffers = [k for k in want if "running" in k]
    assert len(buffers) == 2 * sum(
        1 for m in model.modules() if type(m).__name__ == "BatchNorm")
    for k in buffers:
        assert torch.equal(loaded.params[k], want[k]), k
    assert not loaded.model.training
    rows = images[:4].reshape(4, -1).numpy()
    with torch.no_grad():
        eval_logits = model.eval()(images[:4]).numpy()
    np.testing.assert_array_equal(loaded.predict({"image": rows}), eval_logits)
    stats = aot.warm_loaded(loaded, {"image": rows}, 4)
    assert stats["fallback_warm"] and not loaded.model.training
    for k in buffers:                 # serving never moves the statistics
        assert torch.equal(loaded.params[k], want[k]), k

    fn_args = SimpleNamespace(custom_config={"base_model_uri": uri})
    init = warm_start_init(fn_args, lambda g, b: ResNet(N_CLASSES, 18, 8))
    warm = init(torch.Generator().manual_seed(0), None).state_dict()
    for k, v in want.items():
        assert torch.equal(warm[k], v), k
