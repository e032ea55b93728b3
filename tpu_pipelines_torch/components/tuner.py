"""Tuner component: hyperparameter search over the Trainer's run_fn.

The port of ``tpu_pipelines/components/tuner.py`` (TFX Tuner, Katib
HPO): trials run the same ``run_fn(FnArgs)`` contract the Trainer uses,
with grid or random candidates (or successive halving / TPE,
``tuner_algorithms.py``), and the winner is emitted as a
``HyperParameters`` artifact whose ``best_hyperparameters.json`` the
Trainer merges over its own.

Trial execution modes:

  - in-process, one after another (``parallel_trials=1``, default): on
    the card each trial builds its model, optimizer and CUDA-graph pool,
    which are freed when the trial returns.  Each in-process trial's
    outcome records ``device_memory_delta_bytes``: allocated bytes on the
    device after the trial (after a garbage collection) less before it,
    the baseline read once cuBLAS holds its workspaces for this thread and
    the loop's side stream (``train_loop.warm_cublas``), so the delta is
    what the trial kept whatever ran in the process before it.
  - in subprocesses (``parallel_trials>1`` or ``isolate_trials=True``):
    each trial is ``python -m tpu_pipelines_torch.components.tuner_trial
    trial --spec spec.json``, up to ``parallel_trials`` at once.  The
    device travels in the spec (``FnArgs.device``), so a child never picks
    its own; a trial that crashes fails that trial only.  The child writes
    its kernel launch counts (``ops.flash_attention.COUNTERS``) into its
    result file, and the outcome carries them as ``launches``: launches in
    another process are not on this process's counters.
  - shard results: ``tuner_trial shard --shard i/k`` writes
    ``shard_i_of_k.json`` under a shard dir, and a Tuner run with
    ``TPP_TUNER_SHARD_DIR`` set reuses the matching scores.  The cluster
    runner's pod fan-out is not ported (ROADMAP.md A10).

Only rank 0 (``RANK``, default 0) writes the result files; subprocess
trials are refused when ``WORLD_SIZE`` > 1.
"""

from __future__ import annotations

import dataclasses
import gc
import glob
import itertools
import json
import logging
import os
import random
import subprocess
import sys
from typing import Any, Dict, List, Optional

import torch

from tpu_pipelines_torch.dsl.component import Parameter, component
from tpu_pipelines_torch.ops import flash_attention as fa
from tpu_pipelines_torch.trainer.fn_args import (
    FnArgs,
    TrainResult,
    ctx_data_uris,
    make_fn_args,
)
from tpu_pipelines_torch.trainer.train_loop import warm_cublas
from tpu_pipelines_torch.utils.module_loader import load_fn, load_module

logger = logging.getLogger(__name__)

BEST_FILE = "best_hyperparameters.json"
TRIALS_FILE = "trials.json"
ENV_SHARD_DIR = "TPP_TUNER_SHARD_DIR"

SPEC_FILE = "spec.json"
RESULT_FILE = "result.json"
ERROR_FILE = "error.log"


def _grid(space: Dict[str, List[Any]]) -> List[Dict[str, Any]]:
    keys = sorted(space)
    return [
        dict(zip(keys, combo))
        for combo in itertools.product(*(space[k] for k in keys))
    ]


def _random(space: Dict[str, List[Any]], n: int, seed: int) -> List[Dict[str, Any]]:
    rng = random.Random(seed)
    keys = sorted(space)
    seen = set()
    out: List[Dict[str, Any]] = []
    # Bounded rejection sampling; falls back to duplicates-allowed if the
    # space is smaller than n.
    attempts = 0
    while len(out) < n and attempts < 50 * n:
        cand = {k: rng.choice(space[k]) for k in keys}
        key = json.dumps(cand, sort_keys=True, default=str)
        if key not in seen or len(seen) >= _space_size(space):
            seen.add(key)
            out.append(cand)
        attempts += 1
    return out


def _space_size(space: Dict[str, List[Any]]) -> int:
    size = 1
    for v in space.values():
        size *= max(1, len(v))
    return size


def candidate_key(cand: Dict[str, Any]) -> str:
    return json.dumps(cand, sort_keys=True, default=str)


def trial_config_key(exec_properties: Dict[str, Any]) -> str:
    """Canonical key over everything (besides the candidate hyperparameters,
    which the merged candidate_key covers) that changes what a shard trial
    trains: budgets, mesh, custom_config, module file.  Shard pods resolve
    runtime parameters to their *defaults*, so a run with runtime-overridden
    budgets must not silently reuse shard scores trained under the defaults
    — the merge validates this key against each shard file."""
    return json.dumps(
        {
            "train_steps": exec_properties.get("train_steps", 100),
            "eval_steps": exec_properties.get("eval_steps", 0),
            "mesh": exec_properties.get("mesh"),
            "custom_config": exec_properties.get("custom_config"),
            "module_file": exec_properties.get("module_file"),
        },
        sort_keys=True, default=str,
    )


def resolve_search_space(
    exec_properties: Dict[str, Any], module_file: str
) -> Dict[str, List[Any]]:
    space = exec_properties.get("search_space")
    if not space:
        space = getattr(load_module(module_file), "SEARCH_SPACE", None)
    if not space:
        raise ValueError(
            "Tuner needs a search_space parameter or a SEARCH_SPACE dict in "
            f"the module file {module_file!r}"
        )
    space = {k: list(v) for k, v in space.items()}
    empty = sorted(k for k, v in space.items() if not v)
    if empty:
        raise ValueError(f"search_space entries have no candidates: {empty}")
    return space


def enumerate_candidates(
    exec_properties: Dict[str, Any], module_file: str
) -> List[Dict[str, Any]]:
    """Deterministic candidate list — identical in every shard/merge process."""
    space = resolve_search_space(exec_properties, module_file)
    algorithm = exec_properties.get("algorithm", "grid")
    max_trials = exec_properties.get("max_trials", 0)
    if algorithm == "grid":
        candidates = _grid(space)
        if max_trials:
            candidates = candidates[:max_trials]
    elif algorithm == "random":
        n = max_trials or min(10, _space_size(space))
        candidates = _random(space, n, exec_properties.get("seed", 0))
    else:
        raise ValueError(
            f"unknown enumerable tuner algorithm {algorithm!r} "
            "(adaptive algorithms 'halving'/'tpe' are handled by the "
            "component, not by candidate enumeration)"
        )
    if not candidates:
        raise ValueError(
            f"tuner produced no candidates (space={space}, "
            f"max_trials={max_trials})"
        )
    return candidates


def build_trial_fn_args(
    *,
    examples_uri: str,
    transform_graph_uri: str,
    schema_uri: str,
    trial_dir: str,
    hyperparameters: Dict[str, Any],
    exec_properties: Dict[str, Any],
    device: str = "cuda",
) -> FnArgs:
    """One trial's FnArgs — shared by the executor and the shard CLI so the
    run_fn contract cannot drift between local and fanned-out trials."""
    return make_fn_args(
        examples_uri=examples_uri,
        transform_graph_uri=transform_graph_uri,
        schema_uri=schema_uri,
        serving_model_dir=os.path.join(trial_dir, "model"),
        model_run_dir=os.path.join(trial_dir, "model_run"),
        train_steps=exec_properties.get("train_steps", 100),
        eval_steps=exec_properties.get("eval_steps", 0),
        hyperparameters=hyperparameters,
        mesh=exec_properties.get("mesh"),
        custom_config=exec_properties.get("custom_config"),
        device=device,
    )


def run_trial(module_file: str, fn_args: FnArgs) -> Dict[str, float]:
    """Execute one trial in the current process; returns final metrics."""
    run_fn = load_fn(module_file, "run_fn")
    result = run_fn(fn_args)
    if not isinstance(result, TrainResult):
        raise TypeError(
            "run_fn must return TrainResult for tuning, got "
            f"{type(result).__name__}"
        )
    return {k: float(v) for k, v in result.final_metrics.items()}


# ------------------------------------------------------------ trial outcomes

def _outcome(trial: int, cand: Dict[str, Any], *, metrics=None, error=None):
    out: Dict[str, Any] = {
        "trial": trial,
        "hyperparameters": cand,
        "status": "ok" if error is None else "failed",
    }
    if metrics is not None:
        out["metrics"] = metrics
    if error is not None:
        out["error"] = str(error)[:2000]
    return out


def _allocated(device: str) -> int:
    """Bytes allocated on ``device`` after a garbage collection (0 off
    CUDA)."""
    if torch.device(device).type != "cuda":
        return 0
    gc.collect()
    torch.cuda.synchronize(device)
    return int(torch.cuda.memory_allocated(device))


def _run_trials_inprocess(
    todo: List[int], candidates, module_file, make_fn_args, isolate: bool,
) -> Dict[int, Dict[str, Any]]:
    outcomes: Dict[int, Dict[str, Any]] = {}
    for i in todo:
        fn_args = make_fn_args(i)
        if isolate:
            outcomes[i] = _run_trial_subprocess(
                i, candidates[i], module_file, fn_args
            )
            continue
        # In-process: a trial crash propagates (legacy strict mode) — the
        # isolation story lives in the subprocess path.
        warm_cublas(fn_args.device)
        before = _allocated(fn_args.device)
        metrics = run_trial(module_file, fn_args)
        outcomes[i] = _outcome(i, candidates[i], metrics=metrics)
        outcomes[i]["device_memory_delta_bytes"] = (  # tpp: disable=TPP214 (dict key)
            _allocated(fn_args.device) - before)
    return outcomes


def _run_trial_subprocess(
    trial: int, cand: Dict[str, Any], module_file: str, fn_args: FnArgs
) -> Dict[str, Any]:
    trial_dir = os.path.dirname(fn_args.serving_model_dir)
    os.makedirs(trial_dir, exist_ok=True)
    spec_path = os.path.join(trial_dir, SPEC_FILE)
    result_path = os.path.join(trial_dir, RESULT_FILE)
    spec = {
        "module_file": module_file,
        "fn_args": dataclasses.asdict(fn_args),
        "trial": trial,
        "result_path": result_path,
    }
    try:
        # Strict (no default=str): silently stringifying a tuple/ndarray in
        # custom_config would hand subprocess trials different inputs than
        # in-process trials get — the contract drift make_fn_args exists to
        # prevent.
        spec_json = json.dumps(spec, indent=2)
    except TypeError as e:
        raise ValueError(
            "subprocess trial modes (parallel_trials/isolate_trials/"
            "trial_shards) need JSON-serializable hyperparameters and "
            f"custom_config; trial {trial} spec is not: {e}"
        ) from e
    with open(spec_path, "w") as f:
        f.write(spec_json)
    # The child imports this package from where the parent found it.
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH", "")) if p)}
    with open(os.path.join(trial_dir, ERROR_FILE), "w") as errf:
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_pipelines_torch.components.tuner_trial",
             "trial", "--spec", spec_path],
            stdout=errf, stderr=subprocess.STDOUT, env=env,
        )
    if proc.returncode != 0 or not os.path.exists(result_path):
        tail = ""
        try:
            with open(os.path.join(trial_dir, ERROR_FILE)) as f:
                tail = f.read()[-2000:]
        except OSError:
            pass
        logger.warning("tuner trial %d failed (rc=%d)", trial, proc.returncode)
        return _outcome(
            trial, cand,
            error=f"subprocess rc={proc.returncode}: {tail or 'no output'}",
        )
    with open(result_path) as f:
        result = json.load(f)
    out = _outcome(trial, cand, metrics=result["final_metrics"])
    out["launches"] = result.get("launches", {})
    return out


def _run_trials_parallel(
    todo: List[int], candidates, module_file, make_fn_args, parallel: int
) -> Dict[int, Dict[str, Any]]:
    """Up to ``parallel`` concurrent subprocess trials (threads just babysit
    the subprocesses, so the GIL is irrelevant here)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=parallel) as pool:
        futs = {
            i: pool.submit(
                _run_trial_subprocess, i, candidates[i], module_file,
                make_fn_args(i),
            )
            for i in todo
        }
        return {i: fut.result() for i, fut in futs.items()}


# ------------------------------------------------------------ shard files

def shard_file_path(shard_dir: str, shard: int, num_shards: int) -> str:
    return os.path.join(shard_dir, f"shard_{shard}_of_{num_shards}.json")


def write_shard_results(
    shard_dir: str, shard: int, num_shards: int,
    outcomes: List[Dict[str, Any]], *, examples_uri: str = "",
    trial_config: str = "",
) -> str:
    os.makedirs(shard_dir, exist_ok=True)
    path = shard_file_path(shard_dir, shard, num_shards)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"shard": shard, "num_shards": num_shards,
                   "examples_uri": examples_uri,
                   "trial_config": trial_config,
                   "outcomes": outcomes}, f, indent=2, default=str)
    os.replace(tmp, path)  # atomic: mergers never see half a shard
    return path


def load_shard_results(
    shard_dir: str, *, examples_uri: str = "", num_shards: int = 0,
    trial_config: str = "",
) -> Dict[str, Dict[str, Any]]:
    """{candidate_key: outcome} from every *matching* shard file.  Keyed by
    hyperparameter content, not index, so a shard/merge enumeration mismatch
    degrades to re-running a trial instead of mis-scoring it.

    The shard dir is a fixed path under pipeline_root, so files from earlier
    runs (different data, different fan-out degree) can survive there: a
    shard is reused only when its recorded examples_uri matches this run's
    resolved Examples artifact (output uris are execution-unique, so changed
    data means a changed uri) and, when ``num_shards`` is given, its fan-out
    degree matches.  Mismatches are skipped with a warning — the trials
    simply re-run locally."""
    merged: Dict[str, Dict[str, Any]] = {}
    for path in sorted(glob.glob(os.path.join(shard_dir, "shard_*.json"))):
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            logger.warning("ignoring unreadable tuner shard %s: %s", path, e)
            continue
        if num_shards and payload.get("num_shards") != num_shards:
            logger.warning(
                "ignoring stale tuner shard %s (fan-out %s, want %d)",
                path, payload.get("num_shards"), num_shards,
            )
            continue
        if examples_uri and payload.get("examples_uri") != examples_uri:
            logger.warning(
                "ignoring stale tuner shard %s (examples %r, want %r)",
                path, payload.get("examples_uri"), examples_uri,
            )
            continue
        if trial_config and payload.get("trial_config") != trial_config:
            # Shards trained under different budgets/mesh/custom_config (e.g.
            # runtime-parameter overrides the shard pods resolved to
            # defaults) — their scores answer a different question.
            logger.warning(
                "ignoring stale tuner shard %s (trial config mismatch)", path,
            )
            continue
        for outcome in payload.get("outcomes", []):
            merged[candidate_key(outcome["hyperparameters"])] = outcome
    return merged


# ------------------------------------------------------------ component

@component(
    inputs={
        "examples": "Examples",
        "transform_graph": "TransformGraph",
        "schema": "Schema",
    },
    optional_inputs=("transform_graph", "schema"),
    outputs={"best_hyperparameters": "HyperParameters"},
    parameters={
        "module_file": Parameter(type=str, required=True),
        # {name: [candidate values]}; falls back to module SEARCH_SPACE.
        "search_space": Parameter(type=dict, default=None),
        # grid | random | halving (successive halving, the Hyperband inner
        # loop) | tpe (Tree-structured Parzen Estimator) — the latter two
        # are the KerasTuner/Katib adaptive equivalents (tuner_algorithms.py)
        "algorithm": Parameter(type=str, default="grid"),
        "max_trials": Parameter(type=int, default=0),      # 0 = all (grid)
        # halving: initial candidate count (defaults to max_trials or 9),
        # reduction factor, and the smallest rung budget (0 = derived).
        "halving_eta": Parameter(type=int, default=3),
        "min_train_steps": Parameter(type=int, default=0),
        # tpe: proposal batch size, good-fraction, random startup trials.
        "tpe_batch": Parameter(type=int, default=4),
        "tpe_gamma": Parameter(type=float, default=0.25),
        "tpe_startup": Parameter(type=int, default=0),
        "train_steps": Parameter(type=int, default=100),
        "eval_steps": Parameter(type=int, default=0),
        # Metric key from TrainResult.final_metrics; "" = eval_loss if
        # present else loss.
        "objective": Parameter(type=str, default=""),
        "direction": Parameter(type=str, default="min"),   # min | max
        "base_hyperparameters": Parameter(type=dict, default=None),
        "mesh": Parameter(type=dict, default=None),
        "custom_config": Parameter(type=dict, default=None),
        "seed": Parameter(type=int, default=0),
        # Concurrent subprocess trials (1 = in-process sequential).
        "parallel_trials": Parameter(type=int, default=1),
        # Subprocess-isolate even when sequential (crash tolerance).
        "isolate_trials": Parameter(type=bool, default=False),
        # Shard fan-out degree (0 = none): the executor consumes matching
        # shard files; the cluster runner's pod fan-out is ROADMAP.md A10.
        "trial_shards": Parameter(type=int, default=0),
    },
    external_input_parameters=("module_file",),
    resource_class="tpu",
    lint_module_fns=("run_fn",),
)
def Tuner(ctx):
    module_file = ctx.exec_properties["module_file"]

    direction = ctx.exec_properties["direction"]
    if direction not in ("min", "max"):
        raise ValueError(f"direction must be 'min' or 'max', got {direction!r}")
    objective = ctx.exec_properties["objective"]
    base_hp = dict(ctx.exec_properties["base_hyperparameters"] or {})
    out = ctx.output("best_hyperparameters")

    uris = ctx_data_uris(ctx)
    device = str(ctx.extras.get("device", "cuda"))

    algorithm = ctx.exec_properties.get("algorithm", "grid")
    if algorithm in ("halving", "hyperband", "tpe"):
        return _adaptive_tuner(
            ctx, algorithm, module_file, uris, out, base_hp, objective,
            direction, device,
        )

    candidates = enumerate_candidates(ctx.exec_properties, module_file)

    def trial_fn_args(i: int) -> FnArgs:
        return build_trial_fn_args(
            **uris,
            trial_dir=os.path.join(out.uri, "trials", str(i)),
            hyperparameters={**base_hp, **candidates[i]},
            exec_properties=ctx.exec_properties,
            device=device,
        )

    # Results precomputed by shard workers (``tuner_trial shard``),
    # validated against this run's data and fan-out degree.
    shard_dir = os.environ.get(ENV_SHARD_DIR, "")
    precomputed = load_shard_results(
        shard_dir,
        examples_uri=uris["examples_uri"],
        num_shards=int(ctx.exec_properties["trial_shards"] or 0),
        trial_config=trial_config_key(ctx.exec_properties),
    ) if shard_dir else {}
    outcomes: Dict[int, Dict[str, Any]] = {}
    todo: List[int] = []
    for i, cand in enumerate(candidates):
        # Merged-key lookup only: shards write {**base_hp, **cand} keys, so a
        # raw-cand fallback could silently resurrect a shard score computed
        # under DIFFERENT base_hyperparameters (shard files live at a fixed
        # path and survive base_hp changes).  A miss degrades to a local
        # re-run, which is always correct.
        pre = precomputed.get(candidate_key({**base_hp, **cand}))
        if pre is not None:
            outcomes[i] = {**pre, "trial": i}
        else:
            todo.append(i)
    if precomputed:
        logger.info(
            "tuner: %d/%d trials reused from shards in %s",
            len(outcomes), len(candidates), shard_dir,
        )

    parallel, isolate = _trial_exec_mode(ctx)
    if todo and parallel > 1:
        outcomes.update(_run_trials_parallel(
            todo, candidates, module_file, trial_fn_args, parallel
        ))
    elif todo:
        outcomes.update(_run_trials_inprocess(
            todo, candidates, module_file, trial_fn_args, isolate,
        ))

    # One objective for ALL trials — resolved from the first success when
    # unset; never compare across metrics.
    obj = objective
    trials: List[Dict[str, Any]] = []
    best_idx = -1
    best_score: Optional[float] = None
    for i in range(len(candidates)):
        o = outcomes[i]
        if o["status"] != "ok":
            trials.append(o)
            continue
        metrics = o["metrics"]
        if not obj:
            obj = "eval_loss" if "eval_loss" in metrics else "loss"
        if obj not in metrics:
            raise KeyError(
                f"objective {obj!r} not in trial metrics {sorted(metrics)}"
            )
        score = float(metrics[obj])
        trials.append({**o, "objective": obj, "score": score})
        better = (
            best_score is None
            or (direction == "min" and score < best_score)
            or (direction == "max" and score > best_score)
        )
        if better:
            best_score, best_idx = score, i

    n_failed = sum(1 for t in trials if t["status"] != "ok")
    if best_idx < 0:
        raise RuntimeError(
            f"all {len(trials)} tuner trials failed; see trial error logs "
            f"under {out.uri}/trials/"
        )
    if n_failed:
        logger.warning(
            "tuner: %d/%d trials failed; best of the %d survivors wins",
            n_failed, len(trials), len(trials) - n_failed,
        )

    best = {**base_hp, **candidates[best_idx]}
    return _publish_results(out, best, trials, best_idx, best_score, n_failed)


def _trial_exec_mode(ctx) -> "tuple[int, bool]":
    parallel = max(1, int(ctx.exec_properties["parallel_trials"]))
    isolate = bool(ctx.exec_properties["isolate_trials"]) or parallel > 1
    if isolate:
        # Subprocess trials are a single-controller mechanism: under a
        # multi-process run every rank would race on the same spec/result
        # files.  Read from the torchrun env.
        if int(os.environ.get("WORLD_SIZE", "1") or 1) > 1:
            raise ValueError(
                "parallel_trials/isolate_trials cannot run under multi-host "
                "SPMD (every host would spawn colliding trial subprocesses); "
                "use trial_shards for cluster fan-out instead"
            )
    return parallel, isolate


def _publish_results(out, best, trials, best_idx, best_score, n_failed):
    os.makedirs(out.uri, exist_ok=True)
    # Every rank of a multi-process run ran the trials, but these plain-file
    # writes land in the shared output dir: rank 0 only (torchrun's RANK).
    if int(os.environ.get("RANK", "0") or 0) == 0:
        with open(os.path.join(out.uri, BEST_FILE), "w") as f:
            json.dump(best, f, indent=2, sort_keys=True, default=str)
        with open(os.path.join(out.uri, TRIALS_FILE), "w") as f:
            json.dump(trials, f, indent=2, sort_keys=True, default=str)
    out.properties["num_trials"] = len(trials)
    out.properties["failed_trials"] = n_failed
    out.properties["best_trial"] = best_idx
    out.properties["best_score"] = best_score
    return {
        "num_trials": len(trials),
        "failed_trials": n_failed,
        "best_trial": best_idx,
        "best_score": best_score,
    }


def _adaptive_tuner(ctx, algorithm, module_file, uris, out, base_hp,
                    objective, direction, device):
    """Successive-halving / TPE flow: rounds of trials through the same
    subprocess/parallel machinery, budgets and proposals driven by earlier
    scores (tuner_algorithms.py)."""
    from tpu_pipelines_torch.components import tuner_algorithms as ta

    if int(ctx.exec_properties["trial_shards"] or 0):
        raise ValueError(
            f"algorithm {algorithm!r} is sequential-by-round and cannot use "
            "trial_shards fan-out; use parallel_trials for within-round "
            "concurrency"
        )
    space = resolve_search_space(ctx.exec_properties, module_file)
    parallel, isolate = _trial_exec_mode(ctx)
    train_steps = int(ctx.exec_properties.get("train_steps", 100))
    max_trials = int(ctx.exec_properties["max_trials"] or 0)

    def run_batch(cands, steps, first_id):
        overlaid = {**ctx.exec_properties, "train_steps": steps}

        def fn_args(i: int) -> FnArgs:
            return build_trial_fn_args(
                **uris,
                trial_dir=os.path.join(out.uri, "trials", str(first_id + i)),
                hyperparameters={**base_hp, **cands[i]},
                exec_properties=overlaid,
                device=device,
            )

        todo = list(range(len(cands)))
        if parallel > 1:
            outcomes = _run_trials_parallel(
                todo, cands, module_file, fn_args, parallel
            )
        else:
            outcomes = _run_trials_inprocess(
                todo, cands, module_file, fn_args, isolate
            )
        ordered = []
        for i in todo:
            o = outcomes[i]
            o["trial"] = first_id + i
            ordered.append(o)
        return ordered

    if algorithm in ("halving", "hyperband"):
        n0 = max_trials or 9
        trials, best = ta.successive_halving(
            space,
            run_batch=run_batch,
            max_steps=train_steps,
            n0=n0,
            eta=int(ctx.exec_properties["halving_eta"]),
            min_steps=int(ctx.exec_properties["min_train_steps"]),
            objective=objective,
            direction=direction,
            seed=int(ctx.exec_properties["seed"]),
        )
    else:
        trials, best = ta.tpe(
            space,
            run_batch=run_batch,
            train_steps=train_steps,
            max_trials=max_trials or 16,
            batch_size=int(ctx.exec_properties["tpe_batch"]),
            startup=int(ctx.exec_properties["tpe_startup"]),
            gamma=float(ctx.exec_properties["tpe_gamma"]),
            objective=objective,
            direction=direction,
            seed=int(ctx.exec_properties["seed"]),
        )

    n_failed = sum(1 for t in trials if t["status"] != "ok")
    if best is None:
        raise RuntimeError(
            f"all {len(trials)} tuner trials failed; see trial error logs "
            f"under {out.uri}/trials/"
        )
    if n_failed:
        logger.warning(
            "tuner: %d/%d trials failed; best of the %d survivors wins",
            n_failed, len(trials), len(trials) - n_failed,
        )
    best_hp = {**base_hp, **best["hyperparameters"]}
    return _publish_results(
        out, best_hp, trials, best["trial"], best.get("score"), n_failed
    )
