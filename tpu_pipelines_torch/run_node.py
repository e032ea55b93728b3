"""Per-node container entry point: ``python -m tpu_pipelines_torch.run_node``.

The port of ``tpu_pipelines/run_node.py``.  Each pod of a cluster run (the
manifests of ``orchestration/cluster_runner.py``) runs one pipeline node:
the image carries the user's pipeline module (a file defining
``create_pipeline() -> Pipeline``), this entry point joins the process
group the env describes (``parallel/distributed.py``: torchrun's
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR``, or the
``TPP_*`` variables; a group that already exists is kept), and runs the
one node as a partial run, its inputs resolved from the shared metadata
store, so ordering and caching are those of a local run.

Runtime parameters (RuntimeParameter exec-properties and Cond
``runtime_parameter`` predicates) enter through repeatable
``--runtime-parameter NAME=VALUE`` flags (VALUE parsed as JSON, raw string
otherwise) or ``TPP_RUNTIME_PARAMETERS`` (a JSON object); flags win per
key.  Every pod of a run must get the same values.

In a process group of more than one process the node runs under
``LocalDagRunner(spmd_sync=True)``: process 0 publishes to the shared store,
the others work on a scratch copy of the sqlite file (the store must be on
disk), in-runner retries are stripped (the substrate owns them), and a
final barrier keeps any process from leaving while its peers still work.
Exit code 0 for COMPLETE, CACHED or COND_SKIPPED, 1 otherwise.

``--device`` (default ``cuda``, the card this process drives) takes the
place of the reference's ``--cpu-devices-per-process``; ``--device cpu``
runs the node on the CPU over a gloo group.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import sys
import tempfile
from typing import Dict, List, Optional

from tpu_pipelines_torch.orchestration.local_runner import LocalDagRunner
from tpu_pipelines_torch.parallel import distributed
from tpu_pipelines_torch.utils.module_loader import load_fn

log = logging.getLogger("tpu_pipelines_torch.run_node")


def _runtime_parameters(parser: argparse.ArgumentParser,
                        flags: List[str]) -> Dict[str, object]:
    """``TPP_RUNTIME_PARAMETERS`` overlaid by the ``--runtime-parameter``
    flags; a malformed value is a CLI error."""
    out: Dict[str, object] = {}
    env_params = os.environ.get("TPP_RUNTIME_PARAMETERS", "")
    if env_params:
        try:
            decoded = json.loads(env_params)
        except json.JSONDecodeError as e:
            parser.error(
                "TPP_RUNTIME_PARAMETERS is not valid JSON "
                f"({e}); value was {env_params[:200]!r}"
            )
        if not isinstance(decoded, dict):
            parser.error(
                "TPP_RUNTIME_PARAMETERS must be a JSON object "
                f"({{name: value}}), got {type(decoded).__name__}"
            )
        out.update(decoded)
    for item in flags:
        name, sep, raw = item.partition("=")
        if not sep:
            parser.error(f"--runtime-parameter needs NAME=VALUE, got {item!r}")
        try:
            out[name] = json.loads(raw)
        except json.JSONDecodeError:
            out[name] = raw
    return out


def _device(requested: str, dist_cfg) -> str:
    """The device the node runs on: a bare ``cuda`` in a process group is
    the card this process drives (the current device of its main thread,
    which joining the group set), so the runner's worker threads use it
    too."""
    import torch

    dev = torch.device(requested)
    if dist_cfg is not None and dev.type == "cuda" and dev.index is None:
        return f"cuda:{torch.cuda.current_device()}"
    return requested


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpu_pipelines_torch.run_node",
        description="Run one pipeline node (a cluster pod's entry point).")
    parser.add_argument("--pipeline-module", required=True,
                        help="file defining create_pipeline() -> Pipeline")
    parser.add_argument("--node-id", required=True)
    parser.add_argument("--run-id", default=None)
    parser.add_argument("--device", default="cuda",
                        help="device the node runs on (cuda unless cpu)")
    parser.add_argument("--max-retries", type=int, default=0)
    parser.add_argument(
        "--runtime-parameter", action="append", default=[],
        metavar="NAME=VALUE",
        help="runtime parameter (VALUE parsed as JSON, raw string "
             "otherwise); repeatable; overrides TPP_RUNTIME_PARAMETERS per key",
    )
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    runtime_parameters = _runtime_parameters(parser, args.runtime_parameter)

    dist_cfg = distributed.maybe_initialize_from_env(device=args.device)
    device = _device(args.device, dist_cfg)
    pipeline = load_fn(args.pipeline_module, "create_pipeline")()
    scratch = None
    try:
        if dist_cfg is not None and dist_cfg.process_id != 0:
            # Every process runs the node's computation, but only process 0
            # publishes to the shared store; the others work on a scratch
            # copy of the sqlite file.  pipeline_root stays the shared
            # directory (process 0's execution id names the output dirs).
            if not os.path.isfile(pipeline.metadata_path):
                raise FileNotFoundError(
                    "a multi-process run needs a shared on-disk metadata "
                    f"store; {pipeline.metadata_path!r} does not exist (is "
                    "the pipeline using the in-memory default, or has no "
                    "upstream node run?)"
                )
            scratch = tempfile.mkdtemp(
                prefix=f"tpp_worker{dist_cfg.process_id}_")
            scratch_md = os.path.join(scratch, "metadata.sqlite")
            shutil.copyfile(pipeline.metadata_path, scratch_md)
            pipeline.metadata_path = scratch_md
        if dist_cfg is not None:
            if args.max_retries:
                # A process failing fast would wipe and retry while its
                # peers are mid-attempt: the substrate owns retries.
                log.warning("ignoring --max-retries=%d in a multi-process "
                            "run", args.max_retries)
            stripped = [c.id for c in pipeline.components
                        if getattr(c, "retry_policy", None) is not None]
            if stripped or getattr(pipeline, "retry_policy", None) is not None:
                # The cluster runner compiled them into the substrate's
                # retry (Argo retryStrategy, JobSet failurePolicy).
                log.warning(
                    "multi-process run: in-runner retry policies ignored "
                    "(the substrate owns retries); stripped from %s",
                    stripped or "pipeline default",
                )
                pipeline.retry_policy = None
                for c in pipeline.components:
                    c.retry_policy = None
        runner = LocalDagRunner(
            max_retries=0 if dist_cfg is not None else args.max_retries,
            spmd_sync=dist_cfg is not None,
            device=device,
        )
        result = runner.run(
            pipeline,
            runtime_parameters=runtime_parameters,
            run_id=args.run_id,
            from_nodes=[args.node_id],
            to_nodes=[args.node_id],
            raise_on_failure=False,
        )
        node = result.nodes[args.node_id]
        if dist_cfg is not None:
            # No process leaves while its peers still work.
            distributed.barrier()
    finally:
        if scratch is not None:
            shutil.rmtree(scratch, ignore_errors=True)
    if node.status in ("COMPLETE", "CACHED"):
        return 0
    if node.status == "COND_SKIPPED":
        # An unmet predicate is a successful no-op pod, not a step failure.
        print(f"node {args.node_id}: condition not met; skipped",
              file=sys.stderr)
        return 0
    print(f"node {args.node_id} failed: {node.error}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
