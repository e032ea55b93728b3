"""Trainer component: runs user run_fn(FnArgs) and records throughput.

The port's copy of ``tpu_pipelines/components/trainer.py`` (TFX Trainer's
GenericExecutor): imports ``module_file``, builds ``FnArgs`` from the
resolved artifacts and the runner's device (``FnArgs.device``), invokes
``run_fn``, and records examples/sec and the final metrics as execution
properties.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

from tpu_pipelines_torch.dsl.component import Parameter, component
from tpu_pipelines_torch.trainer.fn_args import TrainResult, resolve_fn_args
from tpu_pipelines_torch.utils.module_loader import load_fn


@component(
    inputs={
        "examples": "Examples",
        "transform_graph": "TransformGraph",
        "schema": "Schema",
        "hyperparameters": "HyperParameters",
        # Warm-start base model (TFX base_model input).
        "base_model": "Model",
    },
    optional_inputs=("transform_graph", "schema", "hyperparameters", "base_model"),
    outputs={"model": "Model", "model_run": "ModelRun"},
    parameters={
        "module_file": Parameter(type=str, required=True),
        "train_steps": Parameter(type=int, default=1000),
        "eval_steps": Parameter(type=int, default=0),
        "hyperparameters": Parameter(type=dict, default=None),
        # Mesh axis sizes, passed to run_fn as fn_args.mesh_config (the
        # train loop's data-parallel mesh over the process group; axes
        # other than 'data' wait for ROADMAP.md A6).
        "mesh": Parameter(type=dict, default=None),
        "custom_config": Parameter(type=dict, default=None),
    },
    external_input_parameters=("module_file",),
    resource_class="tpu",
    lint_module_fns=("run_fn",),
)
def Trainer(ctx):
    run_fn = load_fn(ctx.exec_properties["module_file"], "run_fn")

    hyperparameters: Dict[str, Any] = dict(
        ctx.exec_properties["hyperparameters"] or {}
    )
    if ctx.inputs.get("hyperparameters"):
        # Tuner-produced artifact overrides literal hyperparameters.
        hp_uri = ctx.input("hyperparameters").uri
        with open(os.path.join(hp_uri, "best_hyperparameters.json")) as f:
            hyperparameters.update(json.load(f))

    custom_config = dict(ctx.exec_properties["custom_config"] or {})
    if ctx.inputs.get("base_model"):
        custom_config["base_model_uri"] = ctx.input("base_model").uri

    fn_args = resolve_fn_args(
        ctx,
        serving_model_dir=ctx.output("model").uri,
        model_run_dir=ctx.output("model_run").uri,
        hyperparameters=hyperparameters,
        train_steps=ctx.exec_properties["train_steps"],
        eval_steps=ctx.exec_properties["eval_steps"],
        mesh=ctx.exec_properties["mesh"],
        custom_config=custom_config,
    )

    result = run_fn(fn_args)
    if result is None:
        result = TrainResult()
    if not isinstance(result, TrainResult):
        raise TypeError(
            f"run_fn must return TrainResult or None, got {type(result).__name__}"
        )

    model_art = ctx.output("model")
    model_art.properties["examples_per_sec_per_chip"] = (
        result.examples_per_sec_per_chip
    )
    props = {
        "examples_per_sec": result.examples_per_sec,
        "examples_per_sec_per_chip": result.examples_per_sec_per_chip,
        "steps_completed": result.steps_completed,
        "resumed_from_step": result.resumed_from_step,
        "goodput": result.goodput,
        "goodput_source": result.goodput_source,
    }
    props["compiles_after_warm"] = result.compiles_after_warm
    props.update({f"badput_{k}": v for k, v in result.badput.items()})
    props.update(
        {f"final_{k}": v for k, v in result.final_metrics.items()}
    )
    return props
