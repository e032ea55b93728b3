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
init (TFX warm start).

Both predict surfaces dispatch through ``LoadedModel.aot``, an
:class:`AotDispatch` table of captured steps keyed by the padded batch's
signature (``serving/aot.py`` fills it at the fleet's swap gate, one CUDA
graph per bucket).  An empty table is a passthrough to the eager step; a
miss after warm-up is counted once per signature and runs the eager step
on the same device.  Quantized payloads wait for the Rewriter slice of
the port (``ROADMAP.md`` A9).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

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
        "params_bytes": qz.params_nbytes(state),  # tpp: disable=TPP214 (payload key)
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


def _dtype_name(v: Any) -> str:
    if isinstance(v, torch.Tensor):
        return str(v.dtype).removeprefix("torch.")
    return str(np.asarray(v).dtype)


def on_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """Every feature of ``batch`` as a tensor on ``device`` (a tensor
    already there is passed through)."""
    return {
        k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.require(v, requirements=["C", "W"]))).to(device)
        for k, v in batch.items()
    }


class AotDispatch:
    """Signature-keyed table of ahead-of-time prepared serving steps.

    ``serving/aot.py`` fills it at the fleet's swap gate, one captured CUDA
    graph per padded bucket; the loaded model's predict paths consult it
    before running the eager step.  An empty table is a passthrough.  A
    lookup miss after warm-up is a broken warm-up contract (the request
    pays a first run mid-traffic): the first miss per (endpoint,
    signature) adds one to ``compiles_after_warm`` and fires
    ``on_compile_after_warm``, which the fleet wires to
    ``serving_aot_compiles_after_warm_total`` (budget: zero)."""

    def __init__(self):
        self.entries: Dict[Tuple[str, tuple], Any] = {}
        self.fallbacks = 0
        self.compiles_after_warm = 0
        self.on_compile_after_warm: Optional[Callable[[], None]] = None
        self._fallback_sigs: set = set()
        self._lock = threading.Lock()

    @staticmethod
    def signature(batch: Dict[str, Any]) -> tuple:
        """``(key, shape, dtype name)`` of every feature, sorted (numpy
        arrays or tensors)."""
        return tuple(sorted(
            (k, tuple(np.shape(v)), _dtype_name(v)) for k, v in batch.items()
        ))

    def lookup(self, endpoint: str, batch: Dict[str, Any]):
        return self.entries.get((endpoint, self.signature(batch)))

    def install(self, endpoint: str, sig: tuple, executable: Any) -> None:
        with self._lock:
            self.entries[(endpoint, sig)] = executable

    def record_fallback(self, endpoint: str, batch: Dict[str, Any]) -> None:
        sig = (endpoint, self.signature(batch))
        fresh = False
        with self._lock:
            self.fallbacks += 1
            if sig not in self._fallback_sigs:
                self._fallback_sigs.add(sig)
                self.compiles_after_warm += 1
                fresh = True
            cb = self.on_compile_after_warm
        if fresh and cb is not None:
            cb()


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
    # The speculative-decoding draft lane, read from a module's
    # make_draft_decode_fns; None until the lever lands (ROADMAP A8).
    draft_decode_fns: Any = None
    draft_params: Any = None
    # The two halves of ``predict``: the graph's host stage (numpy in and
    # out; identity without a graph) and ``device_step(params, iface)``,
    # the graph's torch evaluator fused with the forward pass (the forward
    # alone without a graph), returning a tensor on ``device``.
    host_preprocess: Callable[[Dict[str, Any]], Dict[str, Any]] = None
    device_step: Callable[[Dict[str, torch.Tensor], Dict[str, Any]], Any] = None
    # The payload directory ("" for hand-built instances).
    uri: str = ""
    # The captured-step table both predict surfaces consult.
    aot: Optional[AotDispatch] = None


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

    # Filled per padded bucket by serving/aot.py at the fleet's swap gate;
    # until then every lookup short-circuits on the empty table.
    aot = AotDispatch()

    def _dispatch(endpoint: str, step, batch) -> np.ndarray:
        if aot.entries:
            exe = aot.lookup(endpoint, batch)
            if exe is not None:
                return _to_numpy(exe(params, batch))
            aot.record_fallback(endpoint, batch)
        return _to_numpy(step(params, batch))

    def predict_transformed(batch: Dict[str, Any]) -> np.ndarray:
        return _dispatch("transformed", forward_step, batch)

    transform = None
    transformed = None
    host_preprocess = lambda b: b  # noqa: E731
    device_step = forward_step
    if spec.get("has_transform"):
        transform = TransformGraph.load(os.path.join(uri, TRANSFORM_DIR))
        host_fn, device_fn, _ = transform.split_host_device()
        host_preprocess = host_fn

        def device_step(p, iface: Dict[str, Any]):
            """The graph's torch evaluator on the interface (moved to the
            device) and the forward pass, in one inference_mode call."""
            with torch.inference_mode():
                return apply_fn(model, p, device_fn(on_device(iface, dev)))

        def transformed(raw_batch: Dict[str, Any]) -> Dict[str, Any]:
            """The graph's host stage in numpy, its interface moved to the
            device, the torch evaluator there (call under inference_mode)."""
            return device_fn(on_device(host_fn(raw_batch), dev))

    def predict(raw_batch: Dict[str, Any]) -> np.ndarray:
        return _dispatch("raw", device_step, host_preprocess(raw_batch))

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
    # A payload may ship a draft lane; it is carried, unused, until the
    # speculative lever lands (ROADMAP A8).
    draft_decode_fns = draft_params = None
    draft_builder = getattr(module, "make_draft_decode_fns", None)
    if draft_builder is not None:
        draft_decode_fns, draft_params = draft_builder(model, hp)

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
        draft_decode_fns=draft_decode_fns,
        draft_params=draft_params,
        host_preprocess=host_preprocess,
        device_step=device_step,
        uri=os.path.abspath(uri),
        aot=aot,
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
