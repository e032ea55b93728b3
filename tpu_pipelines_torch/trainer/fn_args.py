"""FnArgs and TrainResult: the Trainer's contract with user training code.

The port's copy of ``FnArgs`` and ``TrainResult`` from
``tpu_pipelines/trainer/fn_args.py`` (TFX's ``fn_args_utils.FnArgs``: data
uris in, model dirs out), with ``make_fn_args`` / ``resolve_fn_args``, which
assemble it from a component's execution context.  The port's ``FnArgs``
also carries ``device``: the runner's device (``ctx.extras["device"]``),
where ``run_fn`` trains.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass
class FnArgs:
    # Data (Examples artifact uris; transformed when a Transform ran).
    train_examples_uri: str = ""
    eval_examples_uri: str = ""
    # Resolved TransformGraph artifact uri ("" when no Transform in the DAG).
    transform_graph_uri: str = ""
    schema_uri: str = ""
    # Output locations.
    serving_model_dir: str = ""      # final export (Model artifact payload)
    model_run_dir: str = ""          # checkpoints, logs, profiles
    # Budgets.
    train_steps: int = 1000
    eval_steps: int = 0
    # Hyperparameters from the Tuner (or user-set); free-form.
    hyperparameters: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Mesh requested by the component (data/model/seq sizes).
    mesh_config: Dict[str, int] = dataclasses.field(default_factory=dict)
    # Anything else the pipeline author wants to thread through.
    custom_config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # The device run_fn trains on (the runner's; CUDA unless it was asked
    # for the CPU).
    device: str = "cuda"


def make_fn_args(
    *,
    examples_uri: str,
    transform_graph_uri: str,
    schema_uri: str,
    serving_model_dir: str,
    model_run_dir: str,
    hyperparameters: Dict[str, Any],
    train_steps: int,
    eval_steps: int,
    mesh: Optional[Dict[str, int]] = None,
    custom_config: Optional[Dict[str, Any]] = None,
    device: str = "cuda",
) -> "FnArgs":
    """The one place FnArgs fields are assembled."""
    return FnArgs(
        train_examples_uri=examples_uri,
        eval_examples_uri=examples_uri,
        transform_graph_uri=transform_graph_uri,
        schema_uri=schema_uri,
        serving_model_dir=serving_model_dir,
        model_run_dir=model_run_dir,
        train_steps=train_steps,
        eval_steps=eval_steps,
        hyperparameters=hyperparameters,
        mesh_config=dict(mesh or {}),
        custom_config=dict(custom_config or {}),
        device=str(device),
    )


def ctx_data_uris(ctx) -> Dict[str, str]:
    """Resolve the (examples, optional transform_graph/schema) input uris
    from an executor context."""
    return {
        "examples_uri": ctx.input("examples").uri,
        "transform_graph_uri": (
            ctx.input("transform_graph").uri
            if ctx.inputs.get("transform_graph") else ""
        ),
        "schema_uri": (
            ctx.input("schema").uri if ctx.inputs.get("schema") else ""
        ),
    }


def resolve_fn_args(
    ctx,
    *,
    serving_model_dir: str,
    model_run_dir: str,
    hyperparameters: Dict[str, Any],
    train_steps: int,
    eval_steps: int,
    mesh: Optional[Dict[str, int]] = None,
    custom_config: Optional[Dict[str, Any]] = None,
) -> "FnArgs":
    """Build FnArgs from an executor context's resolved artifacts and the
    runner's device (``ctx.extras["device"]``)."""
    return make_fn_args(
        **ctx_data_uris(ctx),
        serving_model_dir=serving_model_dir,
        model_run_dir=model_run_dir,
        train_steps=train_steps,
        eval_steps=eval_steps,
        hyperparameters=hyperparameters,
        mesh=mesh,
        custom_config=custom_config,
        device=str(ctx.extras.get("device", "cuda")),
    )


@dataclasses.dataclass
class TrainResult:
    """What run_fn reports back; recorded as execution properties."""

    final_metrics: Dict[str, float] = dataclasses.field(default_factory=dict)
    examples_per_sec: float = 0.0
    examples_per_sec_per_chip: float = 0.0
    # Median examples/sec/chip over device-sync-anchored step windows
    # (TrainLoopConfig.anchor_every > 0); 0.0 when anchoring was off or the
    # run was too short for a full window.  On platforms where host clocks
    # can run ahead of device execution this is the primary throughput
    # figure; examples_per_sec_per_chip (whole-run, end-anchored) is the
    # secondary.
    anchored_examples_per_sec_per_chip: float = 0.0
    anchor_windows: int = 0
    steps_completed: int = 0
    resumed_from_step: int = 0
    # Productive fraction of job wall-clock.  Source "goodput_tracker" = the
    # port's copy of ml_goodput_measurement's badput algebra
    # (trainer/goodput.py; device init, preparation and the first step's
    # capture count against it); source "host_input_wait_proxy" = 1 -
    # host-input-wait/elapsed, reported only when the tracker could not
    # compute a figure (1.0 when the run was too short to measure).
    goodput: float = 0.0
    goodput_source: str = "host_input_wait_proxy"
    # Goodput over the post-compile window only (1 - input-wait/elapsed,
    # both measured after step 1 retires).  At bench scale the strict
    # figure above is dominated by one-time compile; this one is the
    # steady-state number a long run would converge to.
    goodput_post_compile: float = 0.0
    # {badput_kind: fraction of job wall-clock}, e.g. {"tpu_initialization":
    # 0.02, "training_prep": 0.01, "data_loading_sync": 0.05, "other": ...};
    # kinds with a zero share are left out ("tpu_initialization" is the
    # device's initialization, under the library's name).
    badput: Dict[str, float] = dataclasses.field(default_factory=dict)
    # The per-step FLOP count of the train step
    # (TrainLoopConfig.collect_cost_analysis=True), the cross-check for
    # analytic MFU numerators.  Source "counted" = FlopCounterMode over one
    # eager forward and backward plus the attention kernels by formula (the
    # reference's "compiled"/"lowered" are XLA's cost analyses).  None when
    # collection was off.
    cost_analysis_flops_per_step: Optional[float] = None
    cost_analysis_source: str = ""
    # Effective device-resident multi-step window the loop ran with
    # (TrainLoopConfig.window_steps / TPP_WINDOW_STEPS, default log_every);
    # 1 = the per-step host loop.
    window_steps: int = 1
    # Elastic-resume replay: steps this run re-executed because the
    # previous run was interrupted past its last durable window (the
    # window_progress marker outran the restored checkpoint).  0 for
    # uninterrupted runs.  Replayed examples are accounted as lost work,
    # never as fresh progress.
    replayed_steps: int = 0
    # Gradient-exchange mode the loop ran with: "" = implicit (one
    # all-reduce after the backward), "psum_bucketed" = bucketed
    # all-reduces started from the backward, "ordered" = fixed-block
    # W-invariant reduction, "fsdp" = sharded parameters
    # (TrainLoopConfig.dp_collective).
    dp_collective: str = ""
    # Estimated share of the device span the gradient exchange takes (the
    # bytes proxy that splits window_phase_seconds' device phase); 0.0 on
    # one rank.
    collective_fraction_est: float = 0.0
    # How the step ran: "cuda_graph" (captured once per batch signature,
    # replayed), or "eager: <why>" (the CPU; collectives a CUDA graph
    # cannot hold, gloo's).
    step_capture: str = ""
    # Model-FLOPs utilization: cost_analysis_flops_per_step x post-warmup
    # steps / device-compute seconds / peak FLOP/s.  None without a counted
    # figure or a known peak.
    mfu: Optional[float] = None
    # XLA backend compiles observed AFTER the first window retired —
    # the training twin of serving_aot_compiles_after_warm_total.  Every
    # one is a mid-run recompile stall; steady state is 0.
    compiles_after_warm: int = 0
    # Post-warmup windowed-loop wall-clock attributed per phase
    # (infeed_wait | device_compute | device_collective | host; the
    # phases of each window sum to its wall-clock).  Empty on the
    # per-step (window_steps<=1) path, which cannot separate device from
    # host time without a per-step sync.
    window_phase_seconds: Dict[str, float] = dataclasses.field(
        default_factory=dict
    )
