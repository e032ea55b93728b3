"""Model export/load: self-contained serving payloads for the port.

Same layout as ``tpu_pipelines/trainer/export.py``, with its own format tag:

    <uri>/checkpoint/state_dict.pt   torch.save'd {name: tensor}
    <uri>/module_copy.py             user module (defines build_model)
    <uri>/model_spec.json            format, hyperparameters, has_transform,
                                     dtype, params_bytes

Loading builds the module's model on the requested device (CUDA unless
the caller asks for the CPU) and returns ``predict(batch)`` that runs the
forward pass under ``torch.inference_mode()`` and returns numpy.  A module
that defines ``make_generate_step(model, hp) -> fn(params, batch)`` (or the
legacy ``make_generate_fn(model, params, hp) -> fn(batch)``) gets
``LoadedModel.generate``; one that defines ``make_decode_fns(model, hp)``
gets ``LoadedModel.decode_fns``, the continuous-batching engine's contract.
Payloads that embed a transform graph, quantized payloads and ahead-of-time
dispatch wait for later slices of the port.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from tpu_pipelines_torch.trainer import quantize as qz
from tpu_pipelines_torch.utils.module_loader import load_fn, load_module

SPEC_FILE = "model_spec.json"
MODULE_COPY = "module_copy.py"
CHECKPOINT_DIR = "checkpoint"
STATE_FILE = "state_dict.pt"
FORMAT_VERSION = "tpu-pipelines-torch-model/v1"


def resolve_device(device: Any) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without CUDA raises
    (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev


def export_model(
    *,
    serving_model_dir: str,
    params: Mapping[str, torch.Tensor],
    module_file: str,
    hyperparameters: Optional[Dict[str, Any]] = None,
) -> str:
    """Write a self-contained payload of ``params`` (a state dict); returns
    the dir."""
    os.makedirs(serving_model_dir, exist_ok=True)
    ckpt = os.path.join(serving_model_dir, CHECKPOINT_DIR)
    if os.path.exists(ckpt):
        shutil.rmtree(ckpt)
    os.makedirs(ckpt)
    state = {name: t.detach().cpu() for name, t in params.items()}
    torch.save(state, os.path.join(ckpt, STATE_FILE))
    shutil.copyfile(module_file, os.path.join(serving_model_dir, MODULE_COPY))
    spec = {
        "format": FORMAT_VERSION,
        "hyperparameters": hyperparameters or {},
        "has_transform": False,
        "dtype": qz.infer_dtype(state),
        "params_bytes": qz.params_nbytes(state),
    }
    with open(os.path.join(serving_model_dir, SPEC_FILE), "w") as f:
        json.dump(spec, f, indent=2, sort_keys=True, default=str)
    return serving_model_dir


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
    if spec.get("has_transform"):
        raise NotImplementedError(
            f"model at {uri!r} embeds a transform graph; the port serves "
            "such payloads once the transform slice (taxi DAG) lands"
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

    def predict(batch: Dict[str, Any]) -> np.ndarray:
        return _to_numpy(forward_step(params, batch))

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
        def generate(batch: Dict[str, Any]) -> np.ndarray:
            with torch.inference_mode():
                return _to_numpy(torch.as_tensor(device_generate(batch)))

    decode_builder = getattr(module, "make_decode_fns", None)
    decode_fns = None if decode_builder is None else decode_builder(model, hp)

    return LoadedModel(
        params=params,
        model=model,
        spec=spec,
        predict=predict,
        predict_transformed=predict,
        forward_step=forward_step,
        device=dev,
        dtype=dtype,
        params_bytes=qz.params_nbytes(params),
        generate=generate,
        decode_fns=decode_fns,
    )
