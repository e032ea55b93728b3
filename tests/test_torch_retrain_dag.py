"""The retrain-against-production DAG on the CPU, the port against the JAX
package: ``chip_smoke.py``'s pipeline module (``RETRAIN_PIPELINE``, filled
in with each package) over the same seeded TFRecord spans, warm-starting
from the same tiny BERT (initialised by JAX, exported by the reference and
converted for the port), through each package's runner: run 1 (span 1,
``deploy=true``), run 2 (span 2 added, no deploy) and a warm rerun of run 2.

Held equal between the packages at every run: each node's status (the
Resolver COMPLETE every time, never cached; the Pusher COND_SKIPPED without
deploy), what the Resolver resolved (run 1's model, by artifact id), the
blessing, the push.  The reference's ImportExampleGen reads no ``{SPAN}``
pattern, so it is given the span directory the port's pattern resolves to.
Losses and evaluation metrics within ``tests/test_torch_bert_dag.py``'s
bounds: the Trainer's losses and the Evaluator's loss within 2 x BF16_TOL,
its accuracy apart by no more rows than sit within 2 x BF16_TOL of the
decision margin.
"""

import contextlib
import importlib.util
import json
import os

import jax
import numpy as np
import pytest

from tpu_pipelines.models.bert import build_bert_model as ref_build_bert
from tpu_pipelines.orchestration import LocalDagRunner as RefRunner
from tpu_pipelines.trainer.export import export_model as ref_export
from tpu_pipelines.trainer.export import load_exported_model as ref_load
from tpu_pipelines_torch.models.convert import bert_state_dict_from_flax
from tpu_pipelines_torch.orchestration import LocalDagRunner
from tpu_pipelines_torch.trainer.export import export_model
from tpu_pipelines_torch.utils.module_loader import load_fn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = {
    "port": (os.path.join(REPO, "tpu_pipelines_torch", "examples",
                          "bert_module.py"),
             os.path.join(REPO, "tpu_pipelines_torch", "examples",
                          "bert_preprocessing.py")),
    "ref": (os.path.join(REPO, "examples", "bert", "bert_trainer_module.py"),
            os.path.join(REPO, "examples", "bert", "bert_preprocessing.py")),
}
SEED = 3
ROWS = 150
LEXICON = 60
STEPS = 4
# tests/test_torch_bert_dag.py's tiny BERT, its vocabulary pinned so the
# warm start matches whatever the tokenizer learns.
HP = {"vocab_size": 256, "d_model": 32, "n_layers": 2, "n_heads": 4,
      "d_ff": 64, "max_len": 64, "dropout_rate": 0.0, "num_classes": 2,
      "batch_size": 16, "learning_rate": 1e-3}
BF16_TOL = 5e-2


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_retrain", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def _env(values):
    with pytest.MonkeyPatch.context() as mp:
        for k, v in values.items():
            mp.setenv(k, v)
        yield


@pytest.fixture(scope="module")
def dags(tmp_path_factory):
    cs = _chip_smoke()
    root = tmp_path_factory.mktemp("retrain")
    data = root / "data"
    cs.write_span(str(data / "span-1"), SEED, 1, ROWS, lexicon=LEXICON)
    model = ref_build_bert(HP)
    sample = {"input_ids": np.ones((2, 8), np.int32),
              "attention_mask": np.ones((2, 8), np.int32)}
    params = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.key(0), sample)["params"])
    production = {
        "ref": ref_export(serving_model_dir=str(root / "prod_ref" / "1"),
                          params=params, module_file=MODULES["ref"][0],
                          hyperparameters=HP),
        "port": export_model(serving_model_dir=str(root / "prod_port" / "1"),
                             params=bert_state_dict_from_flax(params),
                             module_file=MODULES["port"][0],
                             hyperparameters=HP),
    }
    out = {"port": [], "ref": [], "bases": {}}
    for run, deploy in ((1, True), (2, False), (3, False)):
        if run == 2:
            cs.write_span(str(data / "span-2"), SEED, 2, ROWS, lexicon=LEXICON)
        for pkg in ("port", "ref"):
            base = root / pkg
            base.mkdir(exist_ok=True)
            module = base / "retrain_pipeline.py"
            module.write_text(cs.RETRAIN_PIPELINE.format(
                pkg="tpu_pipelines_torch" if pkg == "port" else "tpu_pipelines"))
            span = "{SPAN}" if pkg == "port" else str(min(run, 2))
            env = cs.retrain_env(
                str(base), str(data / f"span-{span}"), production[pkg],
                str(base / "pushed"), STEPS, HP, *MODULES[pkg],
                min_accuracy=0.0)
            with _env({**env, "TPP_TRACE": "0"}):
                pipe = load_fn(str(module), "create_pipeline")()
                runner = (LocalDagRunner(device="cpu") if pkg == "port"
                          else RefRunner())
                result = runner.run(pipe, runtime_parameters={"deploy": deploy})
            pushed = sorted(os.listdir(base / "pushed")) if (
                base / "pushed").is_dir() else []
            out[pkg].append((result, cs.node_props(str(base), result), pushed))
            out["bases"][pkg] = str(base)
    return out


def _statuses(result):
    return {k: v.status for k, v in result.nodes.items()}


def test_node_statuses_match_the_reference_run_by_run(dags):
    port = [_statuses(r) for r, _, _ in dags["port"]]
    ref = [_statuses(r) for r, _, _ in dags["ref"]]
    assert port == ref
    executors = ["ImportExampleGen", "StatisticsGen", "SchemaGen", "Transform",
                 "Importer.Model", "Trainer", "Evaluator"]
    assert {port[0][n] for n in executors} == {"COMPLETE"}
    assert port[0]["Resolver"] == "COMPLETE" and port[0]["Pusher"] == "COMPLETE"
    assert port[1]["Importer.Model"] == "CACHED"
    assert port[1]["Pusher"] == "COND_SKIPPED"
    assert {port[2][n] for n in executors} == {"CACHED"}
    assert port[2]["Resolver"] == "COMPLETE"       # never cached
    assert port[2]["Pusher"] == "COND_SKIPPED"     # the skip replays
    for r, _, _ in dags["port"]:
        assert r.succeeded


def test_the_resolver_resolves_run_1s_model_in_both(dags):
    for pkg in ("port", "ref"):
        runs = dags[pkg]
        model1 = runs[0][0].outputs_of("Trainer", "model")[0]
        resolved = [[a.id for a in r.outputs_of("Resolver", "model")]
                    for r, _, _ in runs]
        assert resolved == [[], [model1.id], [model1.id]], pkg
        assert runs[1][1]["Evaluator"]["baseline_model_uri"] == model1.uri
        assert runs[0][1]["Evaluator"]["baseline_model_uri"] == ""
        assert runs[1][1]["Resolver"]["resolved_artifact_ids"] == [model1.id]


def test_blessing_push_and_the_cond_skip_match(dags):
    view = {}
    for pkg in ("port", "ref"):
        runs = dags[pkg]
        base = dags["bases"][pkg]
        pushed = runs[0][2]
        spec_path = os.path.join(base, "pushed", pushed[0], "model_spec.json")
        with open(spec_path) as f:
            stats_uri = json.load(f)["training_statistics_uri"]
        view[pkg] = {
            "blessed": [p["Evaluator"]["blessed"] for _, p, _ in runs[:2]],
            "pushes": [len(p) for _, _, p in runs],
            "pushed": runs[0][1]["Pusher"]["pushed"],
            "stats": stats_uri == runs[0][0].outputs_of(
                "StatisticsGen", "statistics")[0].uri,
            "span": runs[1][0].outputs_of(
                "ImportExampleGen", "examples")[0].properties["split_counts"],
        }
    assert view["port"] == view["ref"]
    # Run 1 blessed on its value threshold alone (0 here: the production
    # model is a random init); run 2 held to a change threshold it cannot
    # meet; one push, by run 1 only.
    assert view["port"]["blessed"] == [True, False]
    assert view["port"]["pushes"] == [1, 1, 1]
    assert view["port"]["stats"] is True
    assert dags["port"][1][0].outputs_of(
        "ImportExampleGen", "examples")[0].properties["span"] == 2


def test_losses_and_eval_metrics_agree_within_the_bert_dag_bounds(dags):
    for run in (0, 1):
        (pr, pp, _), (rr, rp, _) = dags["port"][run], dags["ref"][run]
        for key in ("final_loss", "final_eval_loss"):
            assert np.isfinite(pp["Trainer"][key])
            assert abs(pp["Trainer"][key] - rp["Trainer"][key]) <= 2 * BF16_TOL
        assert pp["Trainer"]["steps_completed"] == STEPS
        pe, re_ = pp["Evaluator"], rp["Evaluator"]
        assert abs(pe["overall_loss"] - re_["overall_loss"]) <= 2 * BF16_TOL
        # Accuracy: apart by at most the rows whose reference margin is
        # within 2 x BF16_TOL.
        from tpu_pipelines.data import examples_io as ref_io

        raw_uri = rr.outputs_of("ImportExampleGen", "examples")[0].uri
        raw = ref_io.read_split(raw_uri, "eval")
        logits = np.asarray(ref_load(rr.outputs_of("Trainer", "model")[0].uri)
                            .predict(raw))
        margin = np.abs(logits[:, 1] - logits[:, 0])
        near = int(np.sum(margin < 2 * BF16_TOL))
        n = len(logits)
        assert abs(pe["overall_accuracy"] - re_["overall_accuracy"]) * n <= (
            near + 1e-6)
