"""Adaptive hyperparameter search: successive halving and TPE.

The port's copy of ``tpu_pipelines/components/tuner_algorithms.py``: plain
Python over ``random``, so with the same seed both packages propose the
same candidates.  The Tuner supplies ``run_batch``, which runs a batch of
trials in-process or in subprocesses (``components/tuner.py``):

  - ``successive_halving``: the inner loop of Hyperband.  Start n0 random
    candidates at a small step budget, keep the best 1/eta at eta x the
    budget, repeat until the full budget.
  - ``tpe``: a Tree-structured Parzen Estimator over the discrete space.
    After a random startup batch, candidates are sampled per dimension in
    proportion to l(v)/g(v), where l counts the value among the best
    ``gamma`` fraction of finished trials and g among the rest (Laplace
    smoothed).

Both are single-controller algorithms: promotion and proposal depend on
earlier scores, so they cannot ride precomputed shard files (the Tuner
refuses ``trial_shards`` with an adaptive algorithm).
"""

from __future__ import annotations

import json
import logging
import random
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

# run_batch(candidates, train_steps, first_trial_id) -> [outcome, ...]
# (one outcome dict per candidate, status "ok" with metrics or "failed").
RunBatch = Callable[[List[Dict[str, Any]], int, int], List[Dict[str, Any]]]


def _resolve_objective(
    outcomes: Sequence[Dict[str, Any]], objective: str
) -> str:
    for o in outcomes:
        if o["status"] == "ok":
            m = o["metrics"]
            if objective:
                if objective not in m:
                    raise KeyError(
                        f"objective {objective!r} not in trial metrics "
                        f"{sorted(m)}"
                    )
                return objective
            return "eval_loss" if "eval_loss" in m else "loss"
    return objective  # every outcome failed; caller raises anyway


def _score(outcome: Dict[str, Any], objective: str,
           direction: str) -> Optional[float]:
    """Comparable score (higher = better) or None for failed trials."""
    if outcome["status"] != "ok":
        return None
    v = float(outcome["metrics"][objective])
    return -v if direction == "min" else v


def _annotate(outcomes, objective, direction) -> None:
    for o in outcomes:
        if o["status"] == "ok":
            o["objective"] = objective
            o["score"] = float(o["metrics"][objective])


def successive_halving(
    space: Dict[str, List[Any]],
    *,
    run_batch: RunBatch,
    max_steps: int,
    n0: int,
    eta: int = 3,
    min_steps: int = 0,
    objective: str = "",
    direction: str = "min",
    seed: int = 0,
) -> Tuple[List[Dict[str, Any]], Optional[Dict[str, Any]]]:
    """Returns (all_trials, best_outcome).  Rung r runs the surviving
    ``n0 / eta^r`` candidates at ``max_steps / eta^(rungs-1-r)`` steps."""
    if eta < 2:
        raise ValueError(f"halving eta must be >= 2, got {eta}")
    from tpu_pipelines_torch.components.tuner import _random

    rungs = 1
    while n0 // (eta ** rungs) >= 1 and rungs < 10:
        rungs += 1
    if min_steps <= 0:
        min_steps = max(1, max_steps // (eta ** (rungs - 1)))

    # Budget schedule upfront, capped at max_steps: once a rung reaches the
    # full budget there is nothing further to promote INTO — re-running the
    # survivor at the same budget would buy zero information — so the
    # schedule ends there even if the width plan had more rungs.
    budgets: List[int] = []
    for r in range(rungs):
        steps = min(max_steps, max(min_steps, min_steps * (eta ** r)))
        if r == rungs - 1:
            steps = max_steps
        budgets.append(steps)
        if steps >= max_steps:
            break
    rungs = len(budgets)

    survivors = _random(space, n0, seed)
    trials: List[Dict[str, Any]] = []
    obj = objective
    best: Optional[Dict[str, Any]] = None
    best_score: Optional[float] = None
    trial_id = 0
    for r, steps in enumerate(budgets):
        outcomes = run_batch(survivors, steps, trial_id)
        trial_id += len(outcomes)
        obj = obj or _resolve_objective(outcomes, objective)
        if obj:
            _annotate(outcomes, obj, direction)
        for o in outcomes:
            o["rung"] = r
            o["train_steps"] = steps
        trials.extend(outcomes)

        scored = [
            (s, o) for o in outcomes
            if (s := _score(o, obj, direction)) is not None
        ] if obj else []
        if not scored:
            logger.warning("halving rung %d: every trial failed", r)
            break
        scored.sort(key=lambda so: so[0], reverse=True)
        # Best-at-full-budget wins; lower rungs only steer promotion, but
        # keep a fallback in case the last rung fails entirely.  Explicit
        # None check: a 0.0 score is falsy but perfectly valid.
        top_score, top = scored[0]
        if r == rungs - 1 or best_score is None or top_score > best_score:
            best, best_score = top, top_score
        keep = max(1, len(scored) // eta)
        survivors = [o["hyperparameters"] for _, o in scored[:keep]]
    return trials, best


def tpe(
    space: Dict[str, List[Any]],
    *,
    run_batch: RunBatch,
    train_steps: int,
    max_trials: int,
    batch_size: int = 4,
    startup: int = 0,
    gamma: float = 0.25,
    objective: str = "",
    direction: str = "min",
    seed: int = 0,
) -> Tuple[List[Dict[str, Any]], Optional[Dict[str, Any]]]:
    """Returns (all_trials, best_outcome) after ``max_trials`` evaluations."""
    from tpu_pipelines_torch.components.tuner import _random, candidate_key

    rng = random.Random(seed)
    keys = sorted(space)
    startup = startup or min(max_trials, max(4, batch_size))
    trials: List[Dict[str, Any]] = []
    seen: set = set()
    obj = objective
    trial_id = 0

    def run(cands: List[Dict[str, Any]]) -> None:
        nonlocal obj, trial_id
        outcomes = run_batch(cands, train_steps, trial_id)
        trial_id += len(outcomes)
        obj = obj or _resolve_objective(outcomes, objective)
        if obj:
            _annotate(outcomes, obj, direction)
        trials.extend(outcomes)
        for c in cands:
            seen.add(candidate_key(c))

    def propose(n: int) -> List[Dict[str, Any]]:
        finished = [
            (s, o) for o in trials
            if (s := _score(o, obj, direction)) is not None
        ]
        if not finished:
            return _random(space, n, rng.randrange(1 << 30))
        finished.sort(key=lambda so: so[0], reverse=True)
        n_good = max(1, int(len(finished) * gamma))
        good = [o["hyperparameters"] for _, o in finished[:n_good]]
        bad = [o["hyperparameters"] for _, o in finished[n_good:]]

        def weights(dim: str) -> List[float]:
            values = space[dim]
            lg = [1.0] * len(values)    # Laplace smoothing
            gg = [1.0] * len(values)
            enc = [json.dumps(v, sort_keys=True, default=str) for v in values]
            index = {e: i for i, e in enumerate(enc)}
            for cand in good:
                i = index.get(json.dumps(cand.get(dim), sort_keys=True,
                                         default=str))
                if i is not None:
                    lg[i] += 1.0
            for cand in bad:
                i = index.get(json.dumps(cand.get(dim), sort_keys=True,
                                         default=str))
                if i is not None:
                    gg[i] += 1.0
            ln = sum(lg)
            gn = sum(gg)
            return [(lg[i] / ln) / (gg[i] / gn) for i in range(len(values))]

        dim_weights = {k: weights(k) for k in keys}
        out: List[Dict[str, Any]] = []
        attempts = 0
        while len(out) < n and attempts < 100 * n:
            cand = {
                k: rng.choices(space[k], weights=dim_weights[k])[0]
                for k in keys
            }
            ck = candidate_key(cand)
            if ck not in seen or attempts > 50 * n:
                out.append(cand)
                seen.add(ck)
            attempts += 1
        return out

    run(_random(space, min(startup, max_trials), seed))
    while len(trials) < max_trials:
        n = min(batch_size, max_trials - len(trials))
        cands = propose(n)
        if not cands:
            break
        run(cands)

    best = None
    best_score = None
    for o in trials:
        s = _score(o, obj, direction) if obj else None
        if s is not None and (best_score is None or s > best_score):
            best, best_score = o, s
    return trials, best
