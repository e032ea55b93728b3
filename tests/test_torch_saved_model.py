"""The ``torch.export`` artifact of a payload's device step
(``serving/saved_model.py``) on the CPU.

A tiny BERT payload (``tests/test_torch_serving.py``'s, flash attention:
the plain version of the kernel on the CPU) is exported with a symbolic
batch dimension; the loaded artifact's logits must equal the payload's
``predict_transformed`` and ``predict`` at two batch sizes other than the
one it was traced at, bit for bit (the same operators on the same
inputs).  The program holds the ``tpp_flash::fwd`` operator itself, so the
card's kernel runs when the artifact is loaded there.
"""

import numpy as np
import pytest

import test_torch_serving as ts
from tpu_pipelines_torch.serving.saved_model import (
    ARTIFACT_FILE,
    export_saved_model,
    load_saved_model,
)
from tpu_pipelines_torch.trainer.export import load_exported_model


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    base = tmp_path_factory.mktemp("saved_model")
    payload = ts._port_payload(base / "1", seed=0)
    out = export_saved_model(payload, str(base / "artifact"),
                             ts._batch(n=4, seed=3), device="cpu")
    return payload, out


@pytest.mark.parametrize("n", [2, 7])
def test_the_artifact_equals_predict_transformed(exported, n):
    payload, out = exported
    run = load_saved_model(out)
    loaded = load_exported_model(payload, device="cpu")
    batch = ts._batch(n=n, seed=n)
    got = run(batch).numpy()
    assert got.shape == (n, ts.HP["num_classes"])
    np.testing.assert_array_equal(got, loaded.predict_transformed(batch))
    np.testing.assert_array_equal(got, loaded.predict(batch))


def test_the_artifact_keeps_the_flash_operator(exported):
    import torch

    _, out = exported
    program = torch.export.load(f"{out}/{ARTIFACT_FILE}")
    targets = {str(node.target) for node in program.graph.nodes
               if node.op == "call_function"}
    assert "tpp_flash.fwd.default" in targets
