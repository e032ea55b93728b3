"""Port parity: the Rewriter, the Pusher's ``variant`` and the fleet's gate.

The reference's Rewriter test payload (``tests/test_rewriter.py``: an
embedding table of 2000 x 32 and a 32 x 1 projection, mean-pooled ids,
a regression label that is the float model plus noise) is exported by each
package from the same numpy weights, with the same eval rows.  Both
Rewriters run on it:

  - at tolerance 0.5 every variant is blessed in both; at tolerance 0 the
    int8 variant is refused in both, and the same variants are blessed;
  - int8 quality deltas agree to a relative 1e-4 (the same q-values and
    scales, dequantized in f32 on both sides); bf16 deltas to an absolute
    2e-3 (each framework's bf16 mean and product);
  - each variant records latency, resident bytes and deltas; the root
    payload is the selected variant; without examples the gate fails
    closed (float32 only); a pinned refused selection raises; the
    ``aot_warm_buckets`` prewarm raises, naming its ROADMAP item.

Then the Pusher pushes a named variant and skips an unblessed one, the
fleet answers 409 for an unblessed payload while the prior version keeps
serving, and the lint rule TPP112 sees a real Rewriter node.
"""

import json
import os
import shutil
import urllib.error
import urllib.request

import numpy as np
import pytest

from tpu_pipelines.components.rewriter import Rewriter as RefRewriter
from tpu_pipelines.data.examples_io import table_from_columns as ref_table
from tpu_pipelines.data.examples_io import write_split as ref_write_split
from tpu_pipelines.dsl.component import ExecutorContext as RefContext
from tpu_pipelines.metadata.types import Artifact as RefArtifact
from tpu_pipelines.trainer.export import export_model as ref_export
from tpu_pipelines_torch.components.pusher import Pusher
from tpu_pipelines_torch.components.rewriter import (
    Rewriter,
    variant_blessed,
    variant_dirs,
)
from tpu_pipelines_torch.data.examples_io import write_split
from tpu_pipelines_torch.dsl.component import ExecutorContext
from tpu_pipelines_torch.metadata.types import Artifact
from tpu_pipelines_torch.trainer.export import export_model, load_exported_model

REF_TOY = """
import jax.numpy as jnp

def build_model(hp):
    return None

def apply_fn(model, params, batch):
    ids = jnp.asarray(batch['ids'], jnp.int32)
    rows = params['emb'][ids]
    return (rows.mean(axis=1) @ params['w']).squeeze(-1)
"""

PORT_TOY = """
import torch
from torch import nn


class Toy(nn.Module):
    def __init__(self, vocab, dim):
        super().__init__()
        self.emb = nn.Parameter(torch.zeros(vocab, dim))
        self.w = nn.Parameter(torch.zeros(dim, 1))


def build_model(hp):
    return Toy(int(hp.get("vocab", 2000)), int(hp.get("dim", 32)))


def apply_fn(model, params, batch):
    ids = torch.as_tensor(batch["ids"], device=params["emb"].device).long()
    rows = params["emb"][ids]
    return (rows.mean(dim=1) @ params["w"]).squeeze(-1)
"""

PROPS = {
    "variants": ["bfloat16", "aqt_int8"],
    "quality_tolerance": 0.5,
    "quality_metrics": None,
    "label_key": "label",
    "problem": "regression",
    "eval_split": "eval",
    "batch_size": 64,
    "max_eval_examples": 192,
    "selection": "auto",
    "min_quant_size": 1024,
    "latency_batch_size": 4,
    "latency_iters": 3,
    "aot_warm_buckets": 0,
}
INT8_RTOL, BF16_ATOL = 1e-4, 2e-3


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    return {"emb": rng.standard_normal((2000, 32)).astype(np.float32),
            "w": (rng.standard_normal((32, 1)) / 8.0).astype(np.float32)}


def _rows(params, n=192, k=8, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 2000, size=(n, k)).astype(np.int32)
    label = ((params["emb"][ids].mean(axis=1) @ params["w"]).squeeze(-1)
             + 0.01 * rng.standard_normal(n)).astype(np.float32)
    return {"ids": ids, "label": label}


@pytest.fixture()
def payloads(tmp_path):
    import torch

    params = _weights()
    rows = _rows(params)
    (tmp_path / "ref_toy.py").write_text(REF_TOY)
    (tmp_path / "port_toy.py").write_text(PORT_TOY)
    ref_uri = str(tmp_path / "ref_model")
    ref_export(serving_model_dir=ref_uri, params=params,
               module_file=str(tmp_path / "ref_toy.py"))
    port_uri = export_model(
        serving_model_dir=str(tmp_path / "port_model"),
        params={k: torch.from_numpy(v) for k, v in params.items()},
        module_file=str(tmp_path / "port_toy.py"))
    ref_examples = str(tmp_path / "ref_examples")
    ref_write_split(ref_examples, "eval", ref_table(rows))
    port_examples = str(tmp_path / "port_examples")
    write_split(port_examples, "eval", rows)
    return {"ref": (ref_uri, ref_examples), "port": (port_uri, port_examples),
            "root": tmp_path}


def _run(side, payloads, name, examples=True, **props):
    model_uri, examples_uri = payloads[side]
    out_uri = str(payloads["root"] / f"{side}-{name}")
    make_art, make_ctx, comp = (
        (RefArtifact, RefContext, RefRewriter) if side == "ref"
        else (Artifact, ExecutorContext, Rewriter))
    inputs = {"model": [make_art(type_name="Model", uri=model_uri)]}
    if examples:
        inputs["examples"] = [make_art(type_name="Examples", uri=examples_uri)]
    out = make_art(type_name="Model", uri=out_uri)
    ctx = make_ctx(node_id="Rewriter", inputs=inputs, outputs={"model": [out]},
                   exec_properties={**PROPS, **props,
                                    "label_key": "label" if examples else ""})
    if side == "port":
        ctx.extras["device"] = "cpu"
    return comp.EXECUTOR(ctx), out


@pytest.mark.parametrize("tolerance", [0.5, 0.0])
def test_the_same_variants_are_blessed_with_the_same_deltas(payloads, tolerance):
    reports = {side: _run(side, payloads, f"t{tolerance}",
                          quality_tolerance=tolerance)[0]
               for side in ("ref", "port")}
    ref, port = reports["ref"], reports["port"]
    assert sorted(port["variants"]) == sorted(ref["variants"])
    for name, want in ref["variants"].items():
        got = port["variants"][name]
        assert got["blessed"] == want["blessed"], name
        assert got["dtype"] == want["dtype"]
        assert sorted(got["quality_deltas"]) == sorted(want["quality_deltas"])
        for k, d in want["quality_deltas"].items():
            if name == "aqt_int8":
                assert got["quality_deltas"][k] == pytest.approx(d, rel=INT8_RTOL)
            else:
                assert abs(got["quality_deltas"][k] - d) <= BF16_ATOL, (name, k)
        assert got["latency_ms"] > 0 and got["params_bytes"] > 0
    assert port["variants"]["aqt_int8"]["num_quantized_leaves"] == \
        ref["variants"]["aqt_int8"]["num_quantized_leaves"] == 1
    assert (port["variants"]["aqt_int8"]["params_bytes"]
            < 0.3 * port["variants"]["float32"]["params_bytes"])
    if tolerance == 0.0:
        assert port["variants"]["aqt_int8"]["blessed"] is False
        assert port["selected_variant"] != "aqt_int8"


def test_selection_report_root_payload_and_refusals(payloads, tmp_path):
    report, out = _run("port", payloads, "auto")
    assert report["selected_variant"] in report["variants"]
    assert out.properties["selected_variant"] == report["selected_variant"]
    assert sorted(variant_dirs(out.uri)) == ["aqt_int8", "bfloat16", "float32"]
    root = load_exported_model(out.uri, device="cpu")
    assert root.dtype == report["variants"][report["selected_variant"]]["dtype"]
    assert os.path.exists(os.path.join(out.uri, "rewrite_report.json"))
    # The Trainer's payload is not annotated through the hardlink.
    with open(os.path.join(payloads["port"][0], "model_spec.json")) as f:
        assert "rewriter" not in json.load(f)

    _, refused = _run("port", payloads, "zero", quality_tolerance=0.0)
    vdir = variant_dirs(refused.uri)["aqt_int8"]
    assert not variant_blessed(vdir)
    assert os.path.exists(os.path.join(vdir, "REWRITE_NOT_BLESSED"))
    with pytest.raises(ValueError, match="quality gate"):
        _run("port", payloads, "pinned", quality_tolerance=0.0,
             selection="int8")
    pinned, _ = _run("port", payloads, "pinned-ok", selection="bf16")
    assert pinned["selected_variant"] == "bfloat16"
    closed, closed_out = _run("port", payloads, "noeval", examples=False)
    assert closed["selected_variant"] == "float32"
    assert closed_out.properties["blessed_variants"] == ["float32"]
    assert "fails closed" in closed["variants"]["aqt_int8"]["reason"]
    with pytest.raises(NotImplementedError, match="cross-process executable"):
        _run("port", payloads, "aot", aot_warm_buckets=4)


def _push(out_uri, variant, dest, tmp_path):
    pushed = Artifact(type_name="PushedModel",
                      uri=str(tmp_path / f"pushed-{variant}-{os.path.basename(dest)}"))
    ctx = ExecutorContext(
        node_id="Pusher",
        inputs={"model": [Artifact(type_name="Model", uri=out_uri)]},
        outputs={"pushed_model": [pushed]},
        exec_properties={"push_destination": str(dest),
                         "serving_push_url": "", "variant": variant})
    return Pusher.EXECUTOR(ctx), pushed


def test_pusher_pushes_a_variant_and_skips_an_unblessed_one(payloads, tmp_path):
    _, out = _run("port", payloads, "push")
    result, pushed = _push(out.uri, "int8", tmp_path / "dest", tmp_path)
    assert result["pushed"] is True and pushed.properties["variant"] == "aqt_int8"
    with open(os.path.join(result["destination"], "model_spec.json")) as f:
        assert json.load(f)["dtype"] == "aqt_int8"
    with pytest.raises(ValueError, match="unknown rewriter variant"):
        _push(out.uri, "float32x", tmp_path / "d2", tmp_path)
    _, refused = _run("port", payloads, "push0", quality_tolerance=0.0)
    result, _ = _push(refused.uri, "aqt_int8", tmp_path / "d3", tmp_path)
    assert result["pushed"] is False and "NOT_BLESSED" in result["skip_reason"]
    assert not (tmp_path / "d3").exists() or not [
        d for d in os.listdir(tmp_path / "d3") if d.isdigit()]


def _post(url, body=b"{}"):
    with urllib.request.urlopen(urllib.request.Request(url, data=body),
                                timeout=60) as r:
        return r.status, json.loads(r.read())


def test_fleet_refuses_an_unblessed_variant_with_409(payloads, tmp_path):
    from tpu_pipelines_torch.serving.server import ModelServer

    _, refused = _run("port", payloads, "fleet", quality_tolerance=0.0)
    base = tmp_path / "serving"
    base.mkdir()
    shutil.copytree(payloads["port"][0], base / "1")
    server = ModelServer("toy", str(base), replicas=1, max_versions=2,
                         device="cpu")
    port = server.start()
    url = f"http://127.0.0.1:{port}/v1/models/toy"
    body = json.dumps({"instances": [{"ids": [1, 2, 3, 4]}]}).encode()
    try:
        status, first = _post(f"{url}:predict", body)
        assert status == 200
        shutil.copytree(variant_dirs(refused.uri)["aqt_int8"], base / "2")
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(f"{url}:reload")
        assert err.value.code == 409
        assert "NOT_BLESSED" in err.value.read().decode()
        status, again = _post(f"{url}:predict", body)
        assert status == 200 and again == first
    finally:
        server.stop()


def test_the_lint_rule_meets_a_real_rewriter_node(tmp_path):
    from tpu_pipelines_torch.analysis import analyze_pipeline
    from tpu_pipelines_torch.components import Importer, Pusher, Rewriter
    from tpu_pipelines_torch.dsl.pipeline import Pipeline

    model = Importer(source_uri=str(tmp_path), artifact_type="Model")
    rewriter = Rewriter(model=model.outputs["result"])
    bypass = Pusher(model=model.outputs["result"],
                    push_destination=str(tmp_path / "push"))
    wired = Pusher(model=rewriter.outputs["model"],
                   push_destination=str(tmp_path / "push2")).with_id("Pusher2")
    findings = {}
    for name, pusher in (("bypass", bypass), ("wired", wired)):
        pipe = Pipeline(name=f"rw-{name}", pipeline_root=str(tmp_path / name),
                        components=[model, rewriter, pusher],
                        metadata_path=str(tmp_path / f"{name}.sqlite"))
        findings[name] = [f.rule for f in analyze_pipeline(pipe)]
    assert "TPP112" in findings["bypass"]
    assert "TPP112" not in findings["wired"]
