"""Ahead-of-time export of a payload's device step: a ``torch.export``
artifact.

The port of ``tpu_pipelines/serving/saved_model.py``.  The reference
converts the payload's jitted device computation (the numeric transform
fused with the forward pass) through jax2tf into a SavedModel with a
symbolic batch dimension.  Here the same computation is traced by
``torch.export`` into an ``ExportedProgram`` and saved as one ``.pt2`` file:
the payload's ``device_step`` on the interface its host stage produces,
with the parameters inside and a symbolic batch dimension.

The host string stage (tokenization, vocabulary lookup: numpy) is not in
the artifact; it runs in the client or ingestion tier, as the framework's
own server runs it (``LoadedModel.host_preprocess``).

The flash-attention forward is the operator ``torch.ops.tpp_flash.fwd``
(``ops/flash_attention.py``), which has a fake implementation for tracing,
so the artifact holds the operator itself: loading it needs the port's ops
module imported (:func:`load_saved_model` does that), and on CUDA tensors
the loaded program launches the same kernel the payload does.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict

import numpy as np
import torch

from tpu_pipelines_torch.ops import flash_attention as _fa  # noqa: F401 — registers tpp_flash
from tpu_pipelines_torch.trainer.export import load_exported_model, on_device

log = logging.getLogger("tpu_pipelines_torch.serving")

ARTIFACT_FILE = "model.pt2"


class _DeviceStep(torch.nn.Module):
    """The payload's device step as a module: its parameters are the
    model's, so ``torch.export`` lifts them into the program."""

    def __init__(self, loaded):
        super().__init__()
        self.model = loaded.model
        self._step = loaded.device_step
        self._params = loaded.params

    def forward(self, iface: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self._step(self._params, iface)


def export_saved_model(
    model_uri: str,
    out_dir: str,
    example_batch: Dict[str, np.ndarray],
    *,
    polymorphic_batch: bool = True,
    device: Any = "cuda",
) -> str:
    """Export a payload's device step to ``<out_dir>/model.pt2``; returns
    ``out_dir``.

    ``example_batch``: raw features (any batch size above 1 when the batch
    is symbolic) from which the payload's own host stage derives the
    device-side input signature.  The program is traced on ``device``.  A
    payload whose ``attn_impl`` is "auto" exports only at the example's
    batch (``polymorphic_batch=False``): its choice depends on the batch."""
    loaded = load_exported_model(model_uri, device=device)
    impl = loaded.spec.get("hyperparameters", {}).get("attn_impl")
    if polymorphic_batch and impl == "auto":
        # "auto" decides per batch shape (the dense temporaries' size), and
        # a symbolic batch has none to decide on.
        raise ValueError(
            f"export_saved_model: {model_uri!r} chooses its attention per "
            "batch (attn_impl 'auto'); pin it to 'flash' or 'dense' in the "
            "payload's hyperparameters to export a symbolic batch")
    iface = on_device(loaded.host_preprocess(example_batch), loaded.device)
    dynamic = None
    if polymorphic_batch:
        batch = torch.export.Dim("batch", min=1)
        dynamic = ({k: {0: batch} for k in iface},)
    step = _DeviceStep(loaded)
    with torch.no_grad():
        # One eager call first: the transform evaluator's module-level
        # constant cache must hold real tensors, which the trace then lifts
        # as constants (traced first, it would cache fake ones).
        step(iface)
        program = torch.export.export(
            step, (iface,), dynamic_shapes=dynamic, strict=False,
        )
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, ARTIFACT_FILE))
    log.info("torch.export artifact written to %s (inputs: %s)", out_dir,
             sorted(iface))
    return out_dir


def load_saved_model(out_dir: str) -> Callable[[Dict[str, Any]], torch.Tensor]:
    """The artifact as a callable on an interface batch (numpy or tensors,
    moved to the program's device)."""
    program = torch.export.load(os.path.join(out_dir, ARTIFACT_FILE))
    module = program.module()
    device = next(iter(program.state_dict.values())).device

    def run(iface: Dict[str, Any]) -> torch.Tensor:
        with torch.no_grad():
            return module(on_device(iface, device))

    return run
