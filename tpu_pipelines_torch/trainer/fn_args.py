"""FnArgs and TrainResult: the Trainer's contract with user training code.

The port's copy of ``FnArgs`` and ``TrainResult`` from
``tpu_pipelines/trainer/fn_args.py`` (TFX's ``fn_args_utils.FnArgs``: data
uris in, model dirs out).  The helpers that assemble ``FnArgs`` from a
component's execution context wait for the component twins
(``ROADMAP.md`` A4).
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
    # Productive fraction of job wall-clock.  Source "ml_goodput_measurement"
    # = the real badput algebra (init/prep/compile count against it); source
    # "host_input_wait_proxy" = 1 - host-input-wait/elapsed, a lower bound on
    # device goodput (1.0 when the run was too short to measure).
    goodput: float = 0.0
    goodput_source: str = "host_input_wait_proxy"
    # Goodput over the post-compile window only (1 - input-wait/elapsed,
    # both measured after step 1 retires).  At bench scale the strict
    # figure above is dominated by one-time compile; this one is the
    # steady-state number a long run would converge to.
    goodput_post_compile: float = 0.0
    # {badput_kind: fraction of job wall-clock}, e.g. {"tpu_initialization":
    # 0.02, "training_prep": 0.01, "data_loading_sync": 0.05, "other": ...}.
    badput: Dict[str, float] = dataclasses.field(default_factory=dict)
    # XLA's own per-step FLOP count for the train step
    # (TrainLoopConfig.collect_cost_analysis=True) — the auditable
    # cross-check for analytic MFU numerators.  Source "compiled" = cost
    # analysis of the optimized executable; "lowered" = HLO cost analysis
    # of the unoptimized module (fallback when the backend's compiled
    # analysis is unavailable).  None when collection was off or failed.
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
    # Gradient-exchange mode the loop ran with: "" = implicit GSPMD,
    # "psum_bucketed" = chunked in-scan psums, "ordered" = fixed-block
    # mesh-size-invariant reduction (TrainLoopConfig.dp_collective).
    dp_collective: str = ""
    # Model-FLOPs utilization.  Not computed by the port's train_loop
    # yet: it needs a counted FLOP figure (ROADMAP.md A11), so it stays
    # None and the train_mfu gauge 0.
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
