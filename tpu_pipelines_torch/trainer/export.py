"""Model export/load: self-contained serving payloads for the port.

Same layout as ``tpu_pipelines/trainer/export.py``, with its own format tag:

    <uri>/checkpoint/state_dict.pt   torch.save'd {name: tensor}
    <uri>/module_copy.py             user module (defines build_model)
    <uri>/transform_graph/           copy of the resolved TransformGraph
                                     (optional)
    <uri>/model_spec.json            format, hyperparameters, has_transform,
                                     dtype, params_bytes

Loading builds the module's model on the requested device (CUDA unless
the caller asks for the CPU).  ``predict_transformed(batch)`` runs the
forward pass under ``torch.inference_mode()`` and returns numpy;
``predict(raw_batch)`` of a payload with a transform graph runs the
graph's host stage in numpy, moves the interface to the device and runs
the graph's torch evaluator and the forward pass in one
``inference_mode`` call (without a graph it is ``predict_transformed``).  A module
that defines ``make_generate_step(model, hp) -> fn(params, batch)`` (or the
legacy ``make_generate_fn(model, params, hp) -> fn(batch)``) gets
``LoadedModel.generate``, which likewise takes raw examples when the payload
carries a graph; one that defines ``make_decode_fns(model, hp)``
gets ``LoadedModel.decode_fns``, the continuous-batching engine's contract.
``warm_start_init`` restores a payload's weights in place of a random
init (TFX warm start).  Quantized payloads and ahead-of-time dispatch wait
for later slices of the port (``ROADMAP.md`` A9, A14).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from tpu_pipelines_torch.trainer import quantize as qz
from tpu_pipelines_torch.transform.graph import TransformGraph
from tpu_pipelines_torch.utils.device import resolve_device  # noqa: F401  (re-exported)
from tpu_pipelines_torch.utils.module_loader import load_fn, load_module

SPEC_FILE = "model_spec.json"
MODULE_COPY = "module_copy.py"
CHECKPOINT_DIR = "checkpoint"
STATE_FILE = "state_dict.pt"
TRANSFORM_DIR = "transform_graph"
FORMAT_VERSION = "tpu-pipelines-torch-model/v1"


def export_model(
    *,
    serving_model_dir: str,
    params: Mapping[str, torch.Tensor],
    module_file: str,
    hyperparameters: Optional[Dict[str, Any]] = None,
    transform_graph_uri: str = "",
    extra_spec: Optional[Dict[str, Any]] = None,
) -> str:
    """Write a self-contained payload of ``params`` (a state dict), with a
    copy of the TransformGraph at ``transform_graph_uri`` when given;
    returns the dir.  ``extra_spec`` entries join the spec."""
    os.makedirs(serving_model_dir, exist_ok=True)
    ckpt = os.path.join(serving_model_dir, CHECKPOINT_DIR)
    if os.path.exists(ckpt):
        shutil.rmtree(ckpt)
    os.makedirs(ckpt)
    state = {name: t.detach().cpu() for name, t in params.items()}
    torch.save(state, os.path.join(ckpt, STATE_FILE))
    shutil.copyfile(module_file, os.path.join(serving_model_dir, MODULE_COPY))
    if transform_graph_uri:
        dst = os.path.join(serving_model_dir, TRANSFORM_DIR)
        if os.path.exists(dst):
            shutil.rmtree(dst)
        shutil.copytree(transform_graph_uri, dst)
    spec = {
        "format": FORMAT_VERSION,
        "hyperparameters": hyperparameters or {},
        "has_transform": bool(transform_graph_uri),
        "dtype": qz.infer_dtype(state),
        "params_bytes": qz.params_nbytes(state),
        **(extra_spec or {}),
    }
    with open(os.path.join(serving_model_dir, SPEC_FILE), "w") as f:
        json.dump(spec, f, indent=2, sort_keys=True, default=str)
    return serving_model_dir


def warm_start_init(fn_args, init_params_fn):
    """TFX warm-start semantics for ``run_fn`` modules.

    When the Trainer received a ``base_model`` input,
    ``fn_args.custom_config`` carries ``base_model_uri``; the returned init
    fn then builds the module's model with ``init_params_fn`` and loads the
    exported payload's state dict into it.  Without a base model it returns
    ``init_params_fn`` unchanged, so modules can wrap unconditionally::

        init_params_fn = warm_start_init(fn_args, init_params_fn)

    The payload must match the fresh model exactly (keys, shapes, dtypes):
    warm-starting across a change of architecture is a config error raised
    with the offending paths (up to eight), not a silent partial load.
    """
    uri = (getattr(fn_args, "custom_config", None) or {}).get(
        "base_model_uri", ""
    )
    if not uri:
        return init_params_fn

    def init(generator: torch.Generator, sample_batch: Dict[str, Any]) -> nn.Module:
        model = init_params_fn(generator, sample_batch)
        fresh = model.state_dict()
        restored = torch.load(
            os.path.join(uri, CHECKPOINT_DIR, STATE_FILE),
            map_location="cpu", weights_only=True,
        )
        problems = []
        for key in sorted(set(fresh) | set(restored)):
            a, b = fresh.get(key), restored.get(key)
            if a is None or b is None:
                problems.append(
                    f"{key}: only in {'base model' if a is None else 'init'}")
            elif a.shape != b.shape or a.dtype != b.dtype:
                problems.append(
                    f"{key}: init {tuple(a.shape)}/{a.dtype} vs base model "
                    f"{tuple(b.shape)}/{b.dtype}")
        if problems:
            raise ValueError(
                f"warm-start base model at {uri!r} does not match this "
                f"module's params: " + "; ".join(problems[:8])
            )
        model.load_state_dict(restored, strict=True)
        return model

    return init


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:  # numpy has no bfloat16
        t = t.float()
    return t.cpu().numpy()


def _default_apply(model: nn.Module, params, batch):
    return torch.func.functional_call(model, params, (batch,))


@dataclasses.dataclass
class LoadedModel:
    params: Dict[str, torch.Tensor]   # the model's tensors, on ``device``
    model: nn.Module                  # from the payload's build_model, eval mode
    spec: Dict[str, Any]
    # The payload's TransformGraph (None without one).
    transform: Optional[TransformGraph]
    predict: Callable[[Dict[str, Any]], np.ndarray]
    predict_transformed: Callable[[Dict[str, Any]], np.ndarray]
    # apply_fn(model, params, batch) bound to the model, taking
    # ``(params, batch)`` and returning a tensor on ``device``.
    forward_step: Callable[[Dict[str, torch.Tensor], Dict[str, Any]], Any]
    device: torch.device
    dtype: str = "float32"
    params_bytes: int = 0
    # generate(batch) -> numpy token ids, from the module's generate hook.
    generate: Optional[Callable[[Dict[str, Any]], np.ndarray]] = None
    # The continuous-batching decode contract (serving/generative.py).
    decode_fns: Any = None


def load_exported_model(uri: str, device: Any = "cuda") -> LoadedModel:
    """Reload an exported payload onto ``device`` as a ready predict
    function."""
    dev = resolve_device(device)
    with open(os.path.join(uri, SPEC_FILE)) as f:
        spec = json.load(f)
    if spec.get("format") != FORMAT_VERSION:
        raise ValueError(
            f"model at {uri!r} has format {spec.get('format')!r}, "
            f"expected {FORMAT_VERSION}"
        )
    dtype = str(spec.get("dtype") or qz.DTYPE_FLOAT32)
    if dtype == qz.DTYPE_AQT_INT8:
        raise NotImplementedError(
            f"model at {uri!r} is int8-quantized; quantized payloads wait "
            "for the Rewriter slice of the port"
        )
    module_copy = os.path.join(uri, MODULE_COPY)
    module = load_module(module_copy)
    hp = spec.get("hyperparameters", {})
    model = load_fn(module_copy, "build_model")(hp)
    apply_fn = getattr(module, "apply_fn", _default_apply)

    state = torch.load(
        os.path.join(uri, CHECKPOINT_DIR, STATE_FILE),
        map_location="cpu", weights_only=True,
    )
    if dtype == qz.DTYPE_BFLOAT16:
        # One cast at load: the resident tensors hold half the bytes.
        state = qz.cast_params(state, torch.bfloat16)
    model.load_state_dict(state, strict=True, assign=True)
    model.to(dev).eval()
    params = dict(model.state_dict())

    def forward_step(p, batch):
        with torch.inference_mode():
            return apply_fn(model, p, batch)

    def predict_transformed(batch: Dict[str, Any]) -> np.ndarray:
        return _to_numpy(forward_step(params, batch))

    transform = None
    predict = predict_transformed
    transformed = None
    if spec.get("has_transform"):
        transform = TransformGraph.load(os.path.join(uri, TRANSFORM_DIR))
        host_fn, device_fn, _ = transform.split_host_device()

        def transformed(raw_batch: Dict[str, Any]) -> Dict[str, Any]:
            """The graph's host stage in numpy, its interface moved to the
            device, the torch evaluator there (call under inference_mode)."""
            return device_fn({
                k: torch.from_numpy(np.require(v, requirements=["C", "W"])).to(dev)
                for k, v in host_fn(raw_batch).items()
            })

        def predict(raw_batch: Dict[str, Any]) -> np.ndarray:
            with torch.inference_mode():
                return _to_numpy(apply_fn(model, params, transformed(raw_batch)))

    # Generate hooks: make_generate_step keeps params an argument of every
    # call; the legacy make_generate_fn closes over them.
    device_generate = None
    step_builder = getattr(module, "make_generate_step", None)
    gen_builder = getattr(module, "make_generate_fn", None)
    if step_builder is not None:
        generate_step = step_builder(model, hp)
        device_generate = lambda b: generate_step(params, b)  # noqa: E731
    elif gen_builder is not None:
        device_generate = gen_builder(model, params, hp)
    generate = None
    if device_generate is not None:
        # A payload with a transform graph decodes raw examples: the graph
        # runs first, as in ``predict``.
        def generate(batch: Dict[str, Any]) -> np.ndarray:
            with torch.inference_mode():
                if transformed is not None:
                    batch = transformed(batch)
                return _to_numpy(torch.as_tensor(device_generate(batch)))

    decode_builder = getattr(module, "make_decode_fns", None)
    decode_fns = None if decode_builder is None else decode_builder(model, hp)

    return LoadedModel(
        params=params,
        model=model,
        spec=spec,
        transform=transform,
        predict=predict,
        predict_transformed=predict_transformed,
        forward_step=forward_step,
        device=dev,
        dtype=dtype,
        params_bytes=qz.params_nbytes(params),
        generate=generate,
        decode_fns=decode_fns,
    )


def model_input_columns(
    loaded: LoadedModel, raw: bool
) -> Optional[List[str]]:
    """Columns the loaded model's predict path consumes, for column-projected
    reads: ``raw=True`` the transform graph's input features (``predict``),
    ``raw=False`` its output features (``predict_transformed``).  None (read
    everything) when the payload carries no transform graph."""
    if loaded.transform is None:
        return None
    cols = (
        loaded.transform.input_feature_names() if raw
        else loaded.transform.output_feature_names()
    )
    # Models may read declared feature lists beyond the transform surface.
    extra = (loaded.spec.get("hyperparameters") or {}).get("features")
    if isinstance(extra, (list, tuple)):
        cols = sorted(set(cols) | {str(c) for c in extra})
    return cols
