"""Port parity: the Tuner, its algorithms and its trial entry points.

  - grid and random candidates (``enumerate_candidates``), successive
    halving and TPE: with the same seed and the same scores, both packages
    propose the same candidates in the same order, with the same rungs and
    budgets, and pick the same best (plain Python over ``random``);
  - the Tuner component through the port's runner on the CPU: its best
    hyperparameters reach the Trainer, in-process trials record their
    device-memory delta, a subprocess trial (``isolate_trials``) gives the
    in-process trial's metrics and carries its kernel launch counts, and
    the shard CLI's files merge into a Tuner run that re-runs no trial
    (and the reference reads the port's shard files to the same outcomes).
"""

import json
import os

import pytest

from tpu_pipelines.components import tuner as ref_tuner
from tpu_pipelines.components import tuner_algorithms as ref_ta
from tpu_pipelines_torch.components import tuner, tuner_algorithms as ta

SPACE = {"x": list(range(10)), "lr": [1e-3, 3e-3, 1e-2], "act": ["relu", "gelu"]}


def _score(c, steps):
    return (c["x"] - 6) ** 2 + 100 * c["lr"] + (c["act"] == "gelu") + 10.0 / steps


def _fake_run_batch(log):
    def run_batch(cands, steps, first_id):
        log.append([(dict(c), steps) for c in cands])
        return [{"trial": first_id + i, "hyperparameters": c, "status": "ok",
                 "metrics": {"loss": float(_score(c, steps))}}
                for i, c in enumerate(cands)]
    return run_batch


@pytest.mark.parametrize("algorithm,max_trials,seed", [
    ("grid", 0, 0), ("grid", 7, 0), ("random", 8, 0), ("random", 8, 5)])
def test_grid_and_random_candidates_match(algorithm, max_trials, seed):
    props = {"search_space": SPACE, "algorithm": algorithm,
             "max_trials": max_trials, "seed": seed}
    got = tuner.enumerate_candidates(props, "unused.py")
    assert got == ref_tuner.enumerate_candidates(props, "unused.py")
    assert [tuner.candidate_key(c) for c in got] == \
        [ref_tuner.candidate_key(c) for c in got]
    extra = {"train_steps": 7, "custom_config": {"a": 1}, "module_file": "m"}
    assert tuner.trial_config_key(extra) == ref_tuner.trial_config_key(extra)


@pytest.mark.parametrize("seed", [0, 3])
def test_successive_halving_proposes_the_same_candidates(seed):
    runs = {}
    for side, mod in (("ref", ref_ta), ("port", ta)):
        log = []
        trials, best = mod.successive_halving(
            SPACE, run_batch=_fake_run_batch(log), max_steps=20, n0=4, eta=2,
            seed=seed)
        runs[side] = (log, trials, best)
    assert runs["port"] == runs["ref"]
    assert [len(r) for r in runs["port"][0]] == [4, 2, 1]


@pytest.mark.parametrize("seed", [0, 3])
def test_tpe_proposes_the_same_candidates(seed):
    runs = {}
    for side, mod in (("ref", ref_ta), ("port", ta)):
        log = []
        trials, best = mod.tpe(SPACE, run_batch=_fake_run_batch(log),
                               train_steps=10, max_trials=12, batch_size=4,
                               seed=seed)
        runs[side] = (log, trials, best)
    assert runs["port"] == runs["ref"]
    assert sum(len(r) for r in runs["port"][0]) == 12


# ---- the component through the port's runner

TOY_RUN_FN = """
import json
import os

import numpy as np
import torch

from tpu_pipelines_torch.trainer import TrainLoopConfig, train_loop


def init(generator):
    model = torch.nn.Linear(4, 1)
    with torch.no_grad():
        model.weight.copy_(torch.randn(1, 4, generator=generator))
        model.bias.zero_()
    return model


def run_fn(fn_args):
    hp = fn_args.hyperparameters
    os.makedirs(fn_args.model_run_dir, exist_ok=True)
    with open(os.path.join(fn_args.model_run_dir, "hp.json"), "w") as f:
        json.dump(hp, f)
    rng = np.random.default_rng(0)
    w = rng.normal(size=(4, 1)).astype(np.float32)
    batches = []
    for _ in range(fn_args.train_steps):
        x = rng.normal(size=(16, 4)).astype(np.float32)
        batches.append({"x": x, "y": (x @ w)[:, 0]})
    _, result = train_loop(
        loss_fn=lambda m, b, g: (((m(b["x"])[:, 0] - b["y"]) ** 2).mean(), {}),
        init_params_fn=lambda g, s: init(g),
        optimizer=lambda p: torch.optim.SGD(p, lr=hp["learning_rate"]),
        train_iter=iter(batches),
        eval_iter_fn=lambda: iter(batches[:2]),
        config=TrainLoopConfig(train_steps=fn_args.train_steps, batch_size=16,
                               log_every=fn_args.train_steps,
                               seed=int(hp.get("seed", 0))),
        device=fn_args.device)
    return result
"""


def _module(tmp_path, **tuner_kwargs):
    csv = tmp_path / "data.csv"
    csv.write_text("a,b\n" + "\n".join(f"{i},{i * 2}" for i in range(12)) + "\n")
    (tmp_path / "toy_run_fn.py").write_text(TOY_RUN_FN)
    mod = tmp_path / "tune_pipeline.py"
    mod.write_text(
        "from tpu_pipelines_torch.components import CsvExampleGen, Trainer, Tuner\n"
        "from tpu_pipelines_torch.dsl.pipeline import Pipeline\n"
        "def create_pipeline():\n"
        f"    gen = CsvExampleGen(input_path={str(csv)!r})\n"
        f"    module = {str(tmp_path / 'toy_run_fn.py')!r}\n"
        "    tuner = Tuner(examples=gen.outputs['examples'], module_file=module,\n"
        "                  search_space={'learning_rate': [0.3, 0.1, 0.01, 0.001]},\n"
        f"                  **{tuner_kwargs!r})\n"
        "    trainer = Trainer(examples=gen.outputs['examples'], module_file=module,\n"
        "                      hyperparameters=tuner.outputs['best_hyperparameters'],\n"
        "                      train_steps=6)\n"
        "    return Pipeline('tune-toy', [gen, tuner, trainer],\n"
        f"                    pipeline_root={str(tmp_path / 'root')!r},\n"
        f"                    metadata_path={str(tmp_path / 'md.sqlite')!r})\n")
    return str(mod)


def _outputs(result, node, key, name):
    uri = result.outputs_of(node, key)[0].uri
    with open(os.path.join(uri, name)) as f:
        return json.load(f)


def test_tuner_feeds_the_trainer_and_records_memory(tmp_path):
    from tpu_pipelines_torch.orchestration import LocalDagRunner
    from tpu_pipelines_torch.utils.module_loader import load_fn

    mod = _module(tmp_path, algorithm="halving", max_trials=4, halving_eta=2,
                  min_train_steps=4, train_steps=8)
    result = LocalDagRunner(device="cpu").run(load_fn(mod, "create_pipeline")())
    assert result.succeeded
    best = _outputs(result, "Tuner", "best_hyperparameters",
                    "best_hyperparameters.json")
    trials = _outputs(result, "Tuner", "best_hyperparameters", "trials.json")
    assert [t["train_steps"] for t in trials] == [4, 4, 4, 4, 8, 8]
    assert all(t["status"] == "ok" and t["device_memory_delta_bytes"] == 0
               for t in trials)
    assert best == min(trials[4:], key=lambda t: t["score"])["hyperparameters"]
    assert result.nodes["Trainer"].status == "COMPLETE"
    assert _outputs(result, "Trainer", "model_run", "hp.json") == best


def test_subprocess_trial_matches_the_in_process_trial(tmp_path):
    from tpu_pipelines_torch.orchestration import LocalDagRunner
    from tpu_pipelines_torch.utils.module_loader import load_fn

    runs = {}
    for isolate in (False, True):
        base = tmp_path / f"isolate-{isolate}"
        base.mkdir()
        mod = _module(base, algorithm="grid", train_steps=5,
                      isolate_trials=isolate)
        result = LocalDagRunner(device="cpu").run(
            load_fn(mod, "create_pipeline")(), to_nodes=["Tuner"])
        assert result.succeeded
        runs[isolate] = _outputs(result, "Tuner", "best_hyperparameters",
                                 "trials.json")
    inproc, sub = runs[False], runs[True]
    assert [t["metrics"] for t in sub] == [t["metrics"] for t in inproc]
    assert all(set(t["launches"]) == {"launches", "dq_launches", "dkv_launches",
                                      "dvec_launches", "decode_launches"}
               for t in sub)
    assert all("launches" not in t for t in inproc)
    spec = json.load(open(tmp_path / "isolate-True" / "root" / "Tuner" /
                          "best_hyperparameters" / os.listdir(
                              tmp_path / "isolate-True" / "root" / "Tuner" /
                              "best_hyperparameters")[0] / "trials" / "0" /
                          "spec.json"))
    assert spec["fn_args"]["device"] == "cpu"


def test_shard_cli_results_merge_without_rerunning(tmp_path, monkeypatch):
    from tpu_pipelines_torch.components.tuner_trial import main as trial_main
    from tpu_pipelines_torch.orchestration import LocalDagRunner
    from tpu_pipelines_torch.utils.module_loader import load_fn

    mod = _module(tmp_path, algorithm="grid", train_steps=3, trial_shards=2)
    LocalDagRunner(device="cpu").run(load_fn(mod, "create_pipeline")(),
                                     to_nodes=["CsvExampleGen"])
    shard_dir = str(tmp_path / "shards")
    for shard in ("0/2", "1/2"):
        assert trial_main(["shard", "--pipeline-module", mod, "--node-id",
                           "Tuner", "--shard", shard, "--shard-dir", shard_dir,
                           "--device", "cpu"]) == 0
    merged = tuner.load_shard_results(shard_dir, num_shards=2)
    assert merged == ref_tuner.load_shard_results(shard_dir, num_shards=2)
    assert len(merged) == 4
    monkeypatch.setenv("TPP_TUNER_SHARD_DIR", shard_dir)
    calls = []
    real = tuner.run_trial
    monkeypatch.setattr(tuner, "run_trial",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    result = LocalDagRunner(device="cpu").run(
        load_fn(mod, "create_pipeline")(), to_nodes=["Tuner"])
    assert result.succeeded and calls == []
    trials = _outputs(result, "Tuner", "best_hyperparameters", "trials.json")
    assert [t["metrics"] for t in trials] == [
        merged[tuner.candidate_key(t["hyperparameters"])]["metrics"]
        for t in trials]


def test_subprocess_trials_refuse_a_multi_process_run(monkeypatch):
    class Ctx:
        exec_properties = {"parallel_trials": 1, "isolate_trials": True}

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="multi"):
        tuner._trial_exec_mode(Ctx())
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert tuner._trial_exec_mode(Ctx()) == (1, True)
