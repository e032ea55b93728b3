"""Tuner trial entry points: subprocess isolation and shard fan-out.

The port of ``tpu_pipelines/components/tuner_trial.py``.  Two subcommands
(``python -m tpu_pipelines_torch.components.tuner_trial ...``):

  - ``trial --spec spec.json``: run ONE trial from a JSON FnArgs spec (its
    ``device`` included) and write its metrics, and the flash-attention
    kernel launches the trial made in this process, to the spec's
    ``result_path``.  This is the isolation boundary the Tuner's
    ``parallel_trials`` / ``isolate_trials`` modes spawn: a crash kills
    this process only, and the parent records a failed trial.
  - ``shard --pipeline-module M --node-id N --shard i/k --shard-dir D``:
    rebuild the pipeline, resolve the Tuner node's inputs read-only from
    the metadata store, run candidates[i::k] (each in a subprocess) and
    write ``D/shard_i_of_k.json``.  No store writes happen here: the Tuner
    node (run with ``TPP_TUNER_SHARD_DIR=D``) merges the shard scores and
    publishes.  ``--device`` (default cuda) is the device the trials train
    on.

Runtime parameters resolve to their defaults in shard mode.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

logger = logging.getLogger(__name__)


def _run_single_trial(spec_path: str) -> int:
    from tpu_pipelines_torch.components.tuner import run_trial
    from tpu_pipelines_torch.ops import flash_attention as fa
    from tpu_pipelines_torch.trainer.fn_args import FnArgs

    with open(spec_path) as f:
        spec = json.load(f)
    fn_args = FnArgs(**spec["fn_args"])
    metrics = run_trial(spec["module_file"], fn_args)
    launches = {name: getattr(fa, name) for name in fa.COUNTERS}
    with open(spec["result_path"], "w") as f:
        json.dump({"trial": spec.get("trial"), "final_metrics": metrics,
                   "launches": launches}, f, indent=2)
    return 0


def _run_shard(args) -> int:
    from tpu_pipelines_torch.components.tuner import (
        _run_trial_subprocess,
        build_trial_fn_args,
        enumerate_candidates,
        trial_config_key,
        write_shard_results,
    )
    from tpu_pipelines_torch.dsl.compiler import Compiler, resolve_property
    from tpu_pipelines_torch.metadata import open_store
    from tpu_pipelines_torch.orchestration.local_runner import LocalDagRunner
    from tpu_pipelines_torch.utils.module_loader import load_fn

    shard_s, _, num_s = args.shard.partition("/")
    shard, num_shards = int(shard_s), int(num_s)
    if not (0 <= shard < num_shards):
        raise ValueError(f"--shard must be i/k with 0 <= i < k, got {args.shard!r}")

    pipeline = load_fn(args.pipeline_module, "create_pipeline")()
    ir = Compiler().compile(pipeline)
    node = ir.node(args.node_id)
    if node.component_type != "Tuner":
        raise ValueError(
            f"{args.node_id!r} is a {node.component_type}, not a Tuner"
        )
    props = {
        k: resolve_property(v, {}) for k, v in node.exec_properties.items()
    }

    store = open_store(ir.metadata_path)
    try:
        produced = {
            up: LocalDagRunner._resolve_prior_outputs(store, ir.node(up))
            for up in node.upstream
        }
        inputs = LocalDagRunner._resolve_inputs(node, produced)
    finally:
        store.close()

    def uri(key: str) -> str:
        arts = inputs.get(key) or []
        return arts[0].uri if arts else ""

    examples_uri = uri("examples")
    if not examples_uri:
        raise RuntimeError(
            f"{args.node_id}: no LIVE 'examples' input in the metadata store "
            f"at {ir.metadata_path!r} — did the upstream nodes run?"
        )

    module_file = props["module_file"]
    candidates = enumerate_candidates(props, module_file)
    base_hp = dict(props.get("base_hyperparameters") or {})
    mine = list(range(shard, len(candidates), num_shards))
    logger.info(
        "tuner shard %d/%d: trials %s of %d candidates",
        shard, num_shards, mine, len(candidates),
    )

    outcomes = []
    path = None
    for i in mine:
        hp = {**base_hp, **candidates[i]}
        fn_args = build_trial_fn_args(
            examples_uri=examples_uri,
            transform_graph_uri=uri("transform_graph"),
            schema_uri=uri("schema"),
            trial_dir=f"{args.shard_dir}/trials/{i}",
            hyperparameters=hp,
            exec_properties=props,
            device=args.device,
        )
        # Subprocess per trial: a trial that os._exit()s or segfaults must
        # not take down the shard worker (and the completed siblings' work).
        outcomes.append(_run_trial_subprocess(i, hp, module_file, fn_args))
        # Incremental atomic rewrite: a preempted/killed shard pod still
        # leaves its finished trials reusable by the merge.
        path = write_shard_results(
            args.shard_dir, shard, num_shards, outcomes,
            examples_uri=examples_uri,
            trial_config=trial_config_key(props),
        )
    logger.info("tuner shard %d/%d wrote %s", shard, num_shards, path)
    return 0


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_trial = sub.add_parser("trial", help="run one trial from a JSON spec")
    p_trial.add_argument("--spec", required=True)

    p_shard = sub.add_parser("shard", help="run candidates[i::k] for a node")
    p_shard.add_argument("--pipeline-module", required=True)
    p_shard.add_argument("--node-id", required=True)
    p_shard.add_argument("--shard", required=True, help="i/k")
    p_shard.add_argument("--shard-dir", required=True)
    p_shard.add_argument("--device", default="cuda")

    args = parser.parse_args(argv)
    if args.cmd == "trial":
        return _run_single_trial(args.spec)
    return _run_shard(args)


if __name__ == "__main__":
    sys.exit(main())
