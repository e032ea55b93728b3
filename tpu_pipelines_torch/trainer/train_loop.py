"""Training loop: the port of ``tpu_pipelines/trainer/train_loop.py``,
on one device or data-parallel over ``torch.distributed`` (one process per
device, below).

The contract keeps the reference's shape in PyTorch idiom:

  - ``init_params_fn(generator, sample_batch) -> nn.Module`` builds the
    model from a CPU ``torch.Generator`` seeded with ``config.seed``;
  - ``loss_fn(model, batch, generator) -> (loss, metrics)`` runs the
    forward in ``train()`` mode; ``generator`` lives on the training
    device and feeds every dropout site (flax ``rngs={"dropout": rng}``).
    The loop owns that generator and seeds it before each step with
    ``_step_seed(config.seed, step)``, as the reference folds the step
    into its key, so step ``s`` draws the masks of
    ``step_generator(config.seed, s, device)`` and a resumed run redraws
    the same masks.  ``metrics`` are tensors.  Eval calls
    ``loss_fn(model, batch, None)`` in ``eval()`` mode under
    ``torch.no_grad()``;
  - ``optimizer`` is a factory ``params -> torch.optim.Optimizer``; on
    CUDA it must be capturable (``capturable=True``);
  - batches are dicts of numpy arrays (or CPU tensors) of one shape per
    window;
  - the loop returns ``(model, TrainResult)``.  It runs on ``device``,
    CUDA unless the caller asks for the CPU; without CUDA it raises,
    naming the device.

The window (``window_steps``): the batches of a window are stacked and
staged on the device one window ahead by ``data.input_pipeline``'s
``windowed_infeed`` (pinned memory, an asynchronous copy on a stream of
its own), the steps of a window run back to back with no host sync, their
losses and metrics collect in one device tensor, and that tensor is
fetched once per window.  Per-step values are rebuilt from it for
``log_every``, ``metrics_cb`` and the NaN/loss-spike watchdog, so a NaN in
the middle of a window is reported at the boundary with its own step.
Windows shrink to land exactly on eval, checkpoint and ``train_steps``
boundaries.  ``window_steps=1`` fetches every step; each step computes the
same thing in either case, so the two agree bitwise.  Every window end
with ``window_steps > 1`` is a sync anchor; with ``window_steps=1`` an
anchor falls every ``anchor_every`` steps.

The step on CUDA (the reference's jitted step and scanned window): the
first step runs eagerly on a side stream, which builds the optimizer's
state without an extra update; then forward, backward and
``optimizer.step()`` are captured into one ``torch.cuda.CUDAGraph`` over
static input buffers, with the loop's dropout generator registered with
the graph.  Every later step copies its batch into those buffers,
re-seeds the generator and replays the graph, which updates the
parameters and the optimizer state in place: the counterpart of the
reference's donated state.  A batch of a new signature (keys, shapes,
dtypes, as ``AotDispatch.signature`` keys the reference's executables) is
captured once, every capture sharing one memory pool; a capture after the
first window is a compile after warm-up (``TrainResult.compiles_after_warm``,
``train_compiles_after_warm_total``, ``train_compile_seconds_total``).  A
capture that fails raises, naming the step and the signature.  The flash
attention kernels' launch counters are credited at each replay
(``ops.flash_attention.credit``).  On the CPU there are no graphs: the same
step runs eagerly, and a new signature after the first window still counts
as a compile after warm-up.  Checkpoints are restored before the first
step; a parameter or optimizer tensor replaced after a capture would leave
the graph writing the old one, so a restore after capture needs a new
capture.

Checkpoints are ``torch.save`` files ``<checkpoint_dir>/ckpt_<step>.pt``
(model and optimizer state, written atomically, the newest
``keep_checkpoints`` kept); a run resumes from the latest.  They are
written off the loop's thread, as the reference's ``_AsyncCheckpointSaver``
writes them: ``save()`` fences the previous save, snapshots every model
and optimizer tensor with ``clone()`` on the loop's stream between two
replays (the graph's static parameter and optimizer buffers are
overwritten by the next replay) and records a CUDA event after the
clones; a daemon thread ``tpp-async-ckpt`` waits on that event alone,
writes the file and prunes.  ``fence()`` joins the thread and re-raises a
save error; it runs before every save and when the loop ends, so the
final checkpoint is on disk when ``train_loop`` returns and no save
thread outlives it.  The snapshot holds a second copy of the state on
the device while it is written (about 1.3 GB for BERT-base with AdamW).
``window_progress.json`` records the furthest executed step, written
synchronously at each window end, so a resume reports the steps it
replays.

When a run trace is active (``observability/trace.py``) the loop emits
the reference's ``window_breakdown`` instant at each window end after the
first, and ``goodput_summary`` (with the badput breakdown) and
``train_telemetry_summary`` at its end, all from host values already
fetched.

Telemetry (the reference's trainer extras):

  - goodput: a ``trainer/goodput.py`` ``GoodputTracker`` records job
    start and end, device init, training preparation, each window's data
    load and each step's start, mirrored to
    ``<checkpoint_dir>/goodput_log.jsonl``; ``TrainResult.goodput`` and
    ``badput`` are its breakdown (``goodput_source`` "goodput_tracker"),
    with the host-input-wait proxy beside them as ``goodput_post_compile``.
    Each step's start is recorded when the step is dispatched (the
    reference records one a window, so a windowed reference run has no
    consecutive steps in its segments); the gaps between step starts sum
    to the same productive time either way.
  - ``stall_timeout_s``: the ``HealthMonitor``'s stall watchdog (None =
    ``TPP_STALL_TIMEOUT_S``, 0 = no thread).  Heartbeats land once per
    window, so the timeout must exceed a window's wall time.
  - ``profile_dir``: ``torch.profiler`` over steps ``[profile_from,
    profile_to)`` (counted from the run's first step), host and device,
    after one warm-up step of the tracer's own that the trace leaves out,
    written as a Chrome trace ``train_steps_<from>-<to>.pt.trace.json``
    under ``profile_dir``; ``window_steps`` is forced to 1, so each
    profiled step is one graph replay on the card.
  - ``tensorboard_dir``: train metrics at ``log_every`` and eval metrics
    as scalars (``observability/summary_writer.py``, flushed per write),
    under the reference's tags and steps.
  - ``collect_cost_analysis``: after the timed loop, one eager forward
    and backward on a copy of the first batch under ``FlopCounterMode``,
    with the attention kernels counted by their registered formulas
    (``ops.flash_attention``'s ``tpp_flash`` operators): the counterpart of
    the reference's XLA cost analysis (``cost_analysis_source``
    "counted").  The backward takes gradients with ``torch.autograd.grad``
    and the model's buffers are restored after it, so neither the
    optimizer state, the gradients the graph writes nor BatchNorm's
    running statistics move; on the card the step's kernel launches
    count as launches.  The optimizer's update does no matmul and counts 0.
  - MFU, as the reference computes it: counted FLOPs x post-warm-up steps
    / the windows' ``device_compute`` seconds (wall time without windows)
    / the peak (``peak_flops_per_chip``, else ``TPP_PEAK_FLOPS``, else the
    card's entry in ``_PEAK_BF16_FLOPS``, else no MFU).

Models with state (the reference's ``has_model_state=True``, BatchNorm's
running statistics): a module's buffers are its model state.
``loss_fn(model, batch, generator)`` in ``train()`` mode updates them in
place, so the eager first step and every replay of the captured step move
them (a buffer rebound to a new tensor would leave the graph writing the
old one); checkpoints and the asynchronous saver's snapshot carry them
(``state_dict()``); eval runs ``loss_fn`` in ``eval()`` mode, on the
running averages.  The flag switches no contract here, where the
reference's switches both (its ``init_params_fn`` returns ``(params,
model_state)`` and its ``loss_fn`` threads the state): the module is the
state.  It declares that the model has state, and the loop refuses a model
with no floating-point buffer under it.  The reference's ResNet
``loss_fn`` applies ``train=True`` in its eval step too, so its eval
metrics use batch statistics; the port's use the running averages, as the
Evaluator and serving do in both packages.

Data parallelism (the reference's mesh, ``parallel/``): every step is
``trainer/data_parallel.py``'s, over the ``mesh`` given
(``parallel.mesh.make_mesh``), else one made from ``config.mesh_config``
and the default process group.  A run of one process with no group is a
mesh of one whose collectives are the identity, so its step is forward,
backward and the optimizer update alone.  Every rank keeps its rows of
the batch (a global batch of ``batch_size`` rows is cut to the rank's
contiguous rows, a short tail padded with the validity mask; a batch of
``batch_size / W`` rows is the rank's own, per-host input) and
exchanges gradients in the mode's collectives (``""``, ``psum_bucketed``,
``ordered``, ``fsdp``), with gradient accumulation and sync-BN inside the
step.  The whole step, micro-batches, collectives and
optimizer update, is the one graph the loop captures; every collective
runs once in the eager first step, where NCCL makes its communicator.
Over gloo (which cannot be captured) and on the CPU the step runs eagerly:
the loop decides this from the group's backend before the first step,
logs it and reports it as ``TrainResult.step_capture``.  Rank 0 alone
writes checkpoints, the progress marker, TensorBoard and the goodput log;
under fsdp a checkpoint holds the gathered full state, so it does not
depend on W and a resume on a survivor world re-shards it.  Throughput per
chip and MFU divide by W.

Not ported: ``batch_partition`` (sequence-partitioned inputs, ``ROADMAP.md``
A6), refused with ``NotImplementedError`` rather than ignored.  The
reference's ``prng_impl`` (a JAX key implementation) has no counterpart
here, and ``donate_state`` none but the in-place replays above: the
fields do not exist.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import logging
import os
import re
import threading
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tpu_pipelines_torch.data.input_pipeline import WindowStager, windowed_infeed
from tpu_pipelines_torch.observability import trace as _obs
from tpu_pipelines_torch.observability.health import HealthMonitor
from tpu_pipelines_torch.observability.metrics import default_registry
from tpu_pipelines_torch.observability.summary_writer import SummaryWriter
from tpu_pipelines_torch.ops import flash_attention as fa
from tpu_pipelines_torch.parallel.mesh import DeviceMesh, MeshConfig, make_mesh
from tpu_pipelines_torch.trainer.data_parallel import (
    DataParallel,
    effective_dp_collective,
)
from tpu_pipelines_torch.trainer.data_parallel import step_seed as _step_seed
from tpu_pipelines_torch.trainer.export import resolve_device
from tpu_pipelines_torch.trainer.fn_args import TrainResult
from tpu_pipelines_torch.trainer.goodput import GoodputTracker

log = logging.getLogger("tpu_pipelines_torch.trainer")

# Peak per-chip dense bf16 FLOP/s by device name, the denominator of an
# MFU figure; 0.0 for a card not in the table (an assumed denominator
# would publish a made-up utilization).  H100 SXM: 989 TFLOP/s (NVIDIA
# data sheet).  TrainLoopConfig.peak_flops_per_chip, then TPP_PEAK_FLOPS,
# take precedence.
_PEAK_BF16_FLOPS = [("h100", 989e12)]
ENV_PEAK_FLOPS = "TPP_PEAK_FLOPS"
ENV_WINDOW_STEPS = "TPP_WINDOW_STEPS"
_CKPT_RE = re.compile(r"^ckpt_(\d+)\.pt$")


@dataclasses.dataclass
class TrainLoopConfig:
    train_steps: int
    batch_size: int = 128
    eval_every: int = 0            # 0 = eval only at the end
    eval_steps: int = 0            # 0 = full eval split pass per eval
    checkpoint_every: int = 0      # 0 = no mid-training checkpoints
    keep_checkpoints: int = 3
    log_every: int = 100
    # Steps per window (see the module docstring).  None = env
    # TPP_WINDOW_STEPS, else ``log_every``; <= 1 = fetch every step.
    window_steps: Optional[int] = None
    seed: int = 0
    # Sync-anchored throughput: with window_steps <= 1, force a host read of
    # the loss every ``anchor_every`` steps and time the span since the
    # previous anchor; the median examples/sec over these spans is the
    # figure async dispatch cannot inflate.  0 = whole-run timing only.
    anchor_every: int = 0
    # Called as cb(kind, detail) when a watchdog fires ("stall", "nan",
    # "loss_spike").
    health_alert_cb: Optional[Callable[[str, str], None]] = None
    # Stall watchdog (see the module docstring): None = env
    # TPP_STALL_TIMEOUT_S, 0 = no watchdog thread.
    stall_timeout_s: Optional[float] = None
    # torch.profiler over steps [profile_from, profile_to) of this run,
    # written under profile_dir; forces window_steps to 1.
    profile_dir: str = ""
    profile_from: int = 2
    profile_to: int = 5
    # TensorBoard scalars (train at log_every, eval) under this dir.
    tensorboard_dir: str = ""
    # Count one step's FLOPs after the timed loop
    # (TrainResult.cost_analysis_flops_per_step) and, with a peak, the MFU.
    collect_cost_analysis: bool = False
    # Peak per-chip FLOP/s; None = env TPP_PEAK_FLOPS, else the card table.
    peak_flops_per_chip: Optional[float] = None
    # ---- data parallelism (see the module docstring and
    # trainer/data_parallel.py).  A MeshConfig or a dict of axis sizes;
    # None = all processes of the default group on 'data'.
    mesh_config: Optional[Any] = None
    # fsdp only: {parameter name: spec} over 'data' (parallel/partition.py);
    # None = fsdp_param_partition's default.
    param_partition: Optional[Any] = None
    # Not ported (sequence-partitioned inputs, ROADMAP.md A6).
    batch_partition: Optional[Dict[str, Any]] = None
    # None/"auto" = the implicit mode (one all-reduce after the backward),
    # else "psum_bucketed", "ordered" or "fsdp"; None reads
    # TPP_DP_COLLECTIVE.
    dp_collective: Optional[str] = None
    # psum_bucketed: all-reduce buckets (gradient leaves round-robined).
    collective_buckets: int = 2
    # ordered: the fixed global gradient-block count; None = the data
    # axis.  Pin it to the largest world you will resume across:
    # trajectories are bitwise comparable only at one block count.
    dp_grad_blocks: Optional[int] = None
    # Micro-batches per step (every a-th row of the local batch), gradients
    # averaged, one optimizer update; composes with every mode.
    grad_accum_steps: int = 1


# field, default, ROADMAP.md item, what it waits for
_UNPORTED = (
    ("batch_partition", None, "A6", "sequence-partitioned batches"),
)


def _refuse_unported(config: TrainLoopConfig) -> None:
    for name, default, item, what in _UNPORTED:
        value = getattr(config, name)
        if value != default:
            raise NotImplementedError(
                f"train_loop: {name}={value!r} is not ported yet ({what}, "
                f"ROADMAP.md {item})"
            )


@dataclasses.dataclass
class TrainState:
    """Step counter, model, optimizer (and its state) and the seed every
    step's generator derives from."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    seed: int


def _peak_flops_per_chip(device: Any) -> float:
    """Peak dense bf16 FLOP/s of ``device`` from the device-name table;
    0.0 off CUDA or for a card not in it."""
    if torch.device(device).type != "cuda":
        return 0.0
    kind = torch.cuda.get_device_name(device).lower()
    for key, peak in _PEAK_BF16_FLOPS:
        if key in kind:
            return peak
    return 0.0


def _peak_flops(config: "TrainLoopConfig", device: Any) -> float:
    """The MFU denominator: ``config.peak_flops_per_chip``, else
    ``TPP_PEAK_FLOPS``, else :func:`_peak_flops_per_chip`."""
    if config.peak_flops_per_chip:
        return float(config.peak_flops_per_chip)
    env = os.environ.get(ENV_PEAK_FLOPS, "").strip()
    if env:
        try:
            return float(env)
        except ValueError:
            log.warning("ignoring non-numeric %s=%r", ENV_PEAK_FLOPS, env)
    return _peak_flops_per_chip(device)


def count_step_flops(model: nn.Module, loss_fn: Callable,
                     batch: Dict[str, torch.Tensor], seed: int = 0) -> float:
    """FLOPs of one training step of ``model`` on ``batch`` (tensors on
    the model's device): ``FlopCounterMode`` over an eager forward and a
    backward to every trainable parameter, the attention kernels counted
    by their registered formulas.  Gradients go through ``torch.autograd.grad`` (no
    ``.grad`` is touched) and the model's buffers are restored after the
    step."""
    from torch.utils.flop_counter import FlopCounterMode

    device = next(model.parameters()).device
    saved = [b.detach().clone() for b in model.buffers()]
    params = [p for p in model.parameters() if p.requires_grad]
    generator = torch.Generator(device=device).manual_seed(_step_seed(seed, 0))
    try:
        with FlopCounterMode(display=False) as counter:
            loss, _ = loss_fn(model, batch, generator)
            torch.autograd.grad(loss, params, allow_unused=True)
    finally:
        with torch.no_grad():
            for b, s in zip(model.buffers(), saved):
                b.copy_(s)
    return float(counter.get_total_flops())


def _effective_window_steps(config: TrainLoopConfig) -> int:
    """Resolve the window length: explicit config > TPP_WINDOW_STEPS env >
    log_every; floor 1."""
    w = config.window_steps
    if w is None:
        raw = os.environ.get(ENV_WINDOW_STEPS, "").strip()
        if raw:
            try:
                w = int(raw)
            except ValueError:
                log.warning("ignoring non-integer %s=%r", ENV_WINDOW_STEPS, raw)
    if w is None:
        w = config.log_every
    w = max(1, int(w or 0))
    if w > 1 and config.profile_dir:
        log.info(
            "window_steps=%d forced to 1: profile_dir is set and the "
            "profiler needs per-step dispatch granularity", w,
        )
        return 1
    return w


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout generator of optimizer step ``step`` (0-based)."""
    return torch.Generator(device=device).manual_seed(_step_seed(seed, step))


def _to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
            .to(device) for k, v in batch.items()}


def batch_signature(batch: Dict[str, torch.Tensor]) -> tuple:
    """``(key, shape, dtype name)`` of every feature, sorted: what a
    captured step is keyed by (the reference's ``AotDispatch.signature``
    of the same arrays)."""
    return tuple(sorted(
        (k, tuple(v.shape), str(v.dtype).removeprefix("torch."))
        for k, v in batch.items()
    ))


# The train loops' side streams (the first step and the captures run on
# one), per CUDA device: a loop takes a free one for its run and gives it
# back at its end, and a new stream is made only when every one is taken.
# cuBLAS keeps a workspace for each stream it has run on, held for the
# life of the process: a new stream a run left 64 MiB behind each run (a
# Tuner's in-process trials grew the card's allocation by that much a
# trial), so runs one after another reuse one stream.  Loops that run at
# once (a deadline-released Trainer beside its successor) never share
# one: work queued on a stream that captures joins the capture.
_free_side_streams: Dict[int, list] = {}
_side_streams_lock = threading.Lock()


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def _take_side_stream(device: torch.device):
    """A side stream of ``device`` no running loop holds (None off CUDA)."""
    if device.type != "cuda":
        return None
    with _side_streams_lock:
        free = _free_side_streams.setdefault(_device_index(device), [])
        if free:
            return free.pop()
    return torch.cuda.Stream(device)


def _give_back_side_stream(device: torch.device, stream) -> None:
    if stream is not None:
        with _side_streams_lock:
            _free_side_streams.setdefault(_device_index(device), []).append(stream)


def warm_cublas(device: Any) -> None:
    """Run one small matmul, forward and backward, on ``device``'s current
    stream and on the side stream the next train loop of this thread will
    take: cuBLAS then holds its workspaces for this thread, autograd's
    device thread and both streams (made once, held for the process's
    life), so an allocation read afterwards moves only with what a loop
    keeps.  A no-op off CUDA."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return
    stream = _take_side_stream(dev)
    try:
        for s in (torch.cuda.current_stream(dev), stream):
            s.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(s):
                x = torch.ones(16, 16, device=dev, requires_grad=True)
                (x @ x).sum().backward()
            torch.cuda.current_stream(dev).wait_stream(s)
        torch.cuda.synchronize(dev)
    finally:
        _give_back_side_stream(dev, stream)


@dataclasses.dataclass
class _Captured:
    """One captured training step: its graph, the static input buffers it
    reads, the metric row it writes and the kernel launches it holds."""

    graph: Any
    inputs: Dict[str, torch.Tensor]
    row: torch.Tensor
    tally: Dict[str, int]


class _TrainStep:
    """Forward, backward and optimizer update of one step, its loss and
    metrics stacked into one device row (see the module docstring).

    ``run(batch, step)`` returns ``(row, capture_seconds)``, the second
    None unless this step met a new batch signature (0.0 when the step
    runs eagerly: the CPU, or collectives that cannot be captured).  The
    step is ``dp``'s (by default the step of one process with no group),
    each micro-batch (and, in ordered, each block) drawing from a
    generator of its own."""

    def __init__(self, state: "TrainState", loss_fn: Callable,
                 device: torch.device, stream: Any,
                 dp: Optional[DataParallel] = None):
        self.state = state
        self.loss_fn = loss_fn
        self.device = device
        self.dp = dp or DataParallel.build(
            TrainLoopConfig(train_steps=1), DeviceMesh(
                group=None, rank=0, shape=MeshConfig().resolve(1), device=device),
            state.model, "", False)
        self.generators = [torch.Generator(device=device)
                           for _ in range(self.dp.generator_count())]
        self.generator = self.generators[0]
        self.keys: Optional[list] = None
        self.signatures: set = set()
        self.captured: Dict[tuple, _Captured] = {}
        self.pool = None
        self.stream = stream

    def _step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        loss, metrics = self.dp.step(
            self.state.model, self.loss_fn, batch, self.generators,
            self.state.optimizer, self.keys)
        if self.keys is None:
            self.keys = sorted(metrics)
        return torch.stack([
            torch.as_tensor(v, device=self.device).detach().float().reshape(())
            for v in [loss, *(metrics[k] for k in self.keys)]
        ])

    def run(self, batch: Dict[str, torch.Tensor], step: int):
        self.dp.seed_generators(self.generators,
                                _step_seed(self.state.seed, step))
        sig = batch_signature(batch)
        new = sig not in self.signatures
        self.signatures.add(sig)
        if self.stream is None:
            return self._step(batch), (0.0 if new else None)
        if not self.captured:
            return self._first_step(batch, sig, step)
        capture_s = self._capture(batch, sig, step) if new else None
        captured = self.captured[sig]
        for k, v in batch.items():
            captured.inputs[k].copy_(v)
        captured.graph.replay()
        fa.credit(captured.tally)
        return captured.row, capture_s

    def _first_step(self, batch, sig, step):
        """The run's first step, eagerly on the side stream (warm-up with
        no extra update), then the capture of its signature."""
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            row = self._step(batch)
        main.wait_stream(self.stream)
        row.record_stream(main)
        return row, self._capture(batch, sig, step)

    def _capture(self, batch, sig, step) -> float:
        t0 = time.perf_counter()
        inputs = {k: v.clone() for k, v in batch.items()}
        self.state.optimizer.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        for generator in self.generators:
            graph.register_generator_state(generator)
        try:
            # Other threads may keep the card busy meanwhile (a serving
            # fleet in the same process): ``thread_local`` confines the
            # capture's restrictions to this thread; captures take turns.
            with fa.capture_lock, fa.launch_tally() as tally, \
                    torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                     capture_error_mode="thread_local"):
                row = self._step(inputs)
        except Exception as e:
            raise RuntimeError(
                f"train_loop: capturing the training step into a CUDA graph "
                f"failed at step {step + 1} for batch signature {sig}: {e}"
            ) from e
        if self.pool is None:
            self.pool = graph.pool()
        self.captured[sig] = _Captured(graph, inputs, row, dict(tally))
        return time.perf_counter() - t0


# ---- checkpoints and the progress marker

def _atomic_write(path: str, write: Callable[[str], None]) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        write(tmp)
        os.replace(tmp, path)  # a reader sees the old file or the new one
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _checkpoints(checkpoint_dir: str) -> Dict[int, str]:
    if not os.path.isdir(checkpoint_dir):
        return {}
    found = {}
    for name in os.listdir(checkpoint_dir):
        m = _CKPT_RE.match(name)
        if m:
            found[int(m.group(1))] = os.path.join(checkpoint_dir, name)
    return found


def _checkpoint_payload(state: TrainState,
                        dp: Optional[DataParallel] = None) -> Dict[str, Any]:
    if dp is not None and dp.gathers_checkpoint():  # fsdp: the full state
        return dp.full_payload(state.step, state.model, state.optimizer)
    return {
        "step": state.step,
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
    }


def _write_checkpoint(checkpoint_dir: str, payload: Dict[str, Any],
                      keep: int) -> None:
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, f"ckpt_{payload['step']}.pt")
    _atomic_write(path, lambda tmp: torch.save(payload, tmp))
    if keep > 0:
        steps = sorted(_checkpoints(checkpoint_dir))
        for old in steps[:-keep]:
            os.unlink(os.path.join(checkpoint_dir, f"ckpt_{old}.pt"))


def _save_checkpoint(checkpoint_dir: str, state: TrainState, keep: int) -> None:
    """The synchronous save: what each asynchronous checkpoint equals."""
    _write_checkpoint(checkpoint_dir, _checkpoint_payload(state), keep)


def _snapshot(obj: Any) -> Any:
    """``obj`` with every tensor in it cloned (dicts and lists rebuilt)."""
    if torch.is_tensor(obj):
        return obj.detach().clone()
    if isinstance(obj, dict):
        return {k: _snapshot(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_snapshot(v) for v in obj)
    return obj


class _AsyncCheckpointSaver:
    """Checkpoint writes off the loop's thread (see the module docstring).

    ``saves`` holds one record a save: its step, the seconds the loop was
    blocked (the fence wait plus the snapshot) and the seconds the thread
    took to write the file.  Under data parallelism rank 0 alone writes
    (``write``); the other ranks only join an fsdp save's gathers."""

    def __init__(self, checkpoint_dir: str, keep: int, device: torch.device,
                 dp: Optional[DataParallel] = None, write: bool = True):
        self.checkpoint_dir = checkpoint_dir
        self.keep = keep
        self.device = device
        self.dp = dp
        self.write = write
        self.saves: list = []
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._stream = (torch.cuda.Stream(device) if device.type == "cuda"
                        else None)

    def save(self, state: TrainState) -> None:
        self.fence()
        if not self.write:
            _checkpoint_payload(state, self.dp)
            return
        t0 = time.perf_counter()
        payload = _snapshot(_checkpoint_payload(state, self.dp))
        event = None
        if self._stream is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        record = {"step": state.step,
                  "blocked_s": time.perf_counter() - t0, "write_s": None}
        self.saves.append(record)

        def run() -> None:
            t1 = time.perf_counter()
            try:
                if event is None:
                    _write_checkpoint(self.checkpoint_dir, payload, self.keep)
                else:
                    # The clones are done once the event is; the copies to
                    # the host go on a stream of this thread's own, so they
                    # never queue behind the loop's next windows.
                    event.synchronize()
                    with torch.cuda.stream(self._stream):
                        _write_checkpoint(self.checkpoint_dir, payload,
                                          self.keep)
                record["write_s"] = time.perf_counter() - t1
            except BaseException as e:  # noqa: BLE001 (re-raised at fence)
                self._error = e

        self._thread = threading.Thread(
            target=run, name="tpp-async-ckpt", daemon=True
        )
        self._thread.start()

    def join(self) -> None:
        """Wait for the save in flight, if any."""
        if self._thread is not None:
            t0 = time.perf_counter()
            self._thread.join()
            self._thread = None
            self.saves[-1]["blocked_s"] += time.perf_counter() - t0

    def fence(self) -> None:
        """Join the save in flight and re-raise its error."""
        self.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def _restore_latest(checkpoint_dir: str, state: TrainState,
                    dp: DataParallel) -> Optional[int]:
    found = _checkpoints(checkpoint_dir)
    if not found:
        return None
    latest = max(found)
    device = next(state.model.parameters()).device
    payload = torch.load(found[latest], map_location=device, weights_only=True)
    dp.load_payload(state.model, state.optimizer, payload)  # fsdp: the shards
    state.step = int(payload["step"])
    return state.step


def _progress_path(checkpoint_dir: str) -> str:
    return os.path.join(os.path.abspath(checkpoint_dir), "window_progress.json")


def _write_progress(checkpoint_dir: str, step: int) -> None:
    """Record the furthest step the loop has EXECUTED (atomic), which may
    be ahead of the last durable checkpoint; on resume the gap is the
    replayed span."""
    def write(tmp: str) -> None:
        with open(tmp, "w") as f:
            json.dump({"step": int(step)}, f)

    try:
        os.makedirs(checkpoint_dir, exist_ok=True)
        _atomic_write(_progress_path(checkpoint_dir), write)
    except OSError as e:  # progress is accounting, never a run failure
        log.warning("window progress write failed: %s", e)


def _read_progress_step(checkpoint_dir: str) -> int:
    try:
        with open(_progress_path(checkpoint_dir)) as f:
            return int(json.load(f).get("step", 0))
    except (OSError, ValueError, TypeError, AttributeError):
        return 0


# ---- the profiler

def _start_profiler(device: torch.device, warmup: int, active: int):
    """A started ``torch.profiler`` over the host and, on CUDA, the card,
    tracing ``active`` steps after ``warmup`` steps (``profiler.step()``
    after each).  The tracer runs through the warm-up step and keeps none
    of it: a trace opened just before a replay lost up to ~45 of its first
    kernels on the H100."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(
        activities=activities,
        schedule=torch.profiler.schedule(wait=0, warmup=warmup, active=active,
                                         repeat=1))
    profiler.start()
    return profiler


def _stop_profiler(profiler, config: TrainLoopConfig, start_step: int) -> str:
    """Stop ``profiler`` and write its Chrome trace under
    ``config.profile_dir``; returns the path."""
    profiler.stop()
    os.makedirs(config.profile_dir, exist_ok=True)
    path = os.path.join(
        config.profile_dir,
        f"train_steps_{start_step + config.profile_from}-"
        f"{start_step + config.profile_to}.pt.trace.json",
    )
    profiler.export_chrome_trace(path)
    log.info("profile of steps [%d, %d) written to %s",
             start_step + config.profile_from,
             start_step + config.profile_to, path)
    return path


# ---- the loop

def _run_eval(model, loss_fn, eval_iter_fn, config, device) -> Dict[str, float]:
    """Mean of each batch's loss and metrics over the eval batches.  The
    per-batch values are summed in float64 on the device (the same sums as
    adding their Python floats) and fetched once, not once a batch."""
    totals: Dict[str, torch.Tensor] = {}
    n = 0
    model.eval()
    try:
        with torch.no_grad():
            for i, batch in enumerate(eval_iter_fn()):
                if config.eval_steps and i >= config.eval_steps:
                    break
                loss, metrics = loss_fn(model, _to_device(batch, device), None)
                for k, v in {"loss": loss, **metrics}.items():
                    v = torch.as_tensor(v, device=device).detach().double()
                    totals[k] = v if k not in totals else totals[k] + v
                n += 1
    finally:
        model.train()
    fetched = {k: float(v) for k, v in totals.items()}
    return {k: v / max(1, n) for k, v in fetched.items()}


def train_loop(
    *,
    loss_fn: Callable[[nn.Module, Dict[str, torch.Tensor], Optional[torch.Generator]],
                      Tuple[torch.Tensor, Dict[str, Any]]],
    init_params_fn: Callable[[torch.Generator, Dict[str, Any]], nn.Module],
    optimizer: Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer],
    train_iter: Iterable[Dict[str, Any]],
    config: TrainLoopConfig,
    eval_iter_fn: Optional[Callable[[], Iterable[Dict[str, Any]]]] = None,
    checkpoint_dir: str = "",
    mesh: Any = None,
    metrics_cb: Optional[Callable[[int, Dict[str, float]], None]] = None,
    has_model_state: bool = False,
    device: Any = "cuda",
) -> Tuple[nn.Module, TrainResult]:
    """Train on ``device`` (under a mesh, the mesh's device); returns
    ``(model, TrainResult)``.  See the module docstring for the contract."""
    _refuse_unported(config)
    dp_mode = effective_dp_collective(config)
    grouped = torch.distributed.is_available() and torch.distributed.is_initialized()
    rank = (mesh.rank if mesh is not None
            else torch.distributed.get_rank() if grouped else 0)
    writer = rank == 0  # rank 0's duties: checkpoints, logs, TensorBoard
    tracker = GoodputTracker(
        job_name="train_loop",
        jsonl_path=(os.path.join(checkpoint_dir, "goodput_log.jsonl")
                    if checkpoint_dir and writer else ""),
    )
    tracker.job_start()
    tracker.tpu_init_start()
    dev = resolve_device(mesh.device if mesh is not None else device)
    if mesh is None:
        mesh = make_mesh(config.mesh_config, device=dev)
    tracker.tpu_init_end()

    train_it = iter(train_iter)
    tracker.data_loading_start()
    try:
        first_batch = next(train_it)
    finally:
        tracker.data_loading_end()
    tracker.training_prep_start()
    model = init_params_fn(
        torch.Generator().manual_seed(int(config.seed)), first_batch
    )
    model.to(dev).train()
    if has_model_state and not any(b.is_floating_point() for b in model.buffers()):
        raise ValueError(
            "train_loop: has_model_state=True, but the model has no "
            "floating-point buffer to hold its state")
    dp = DataParallel.build(config, mesh, model, dp_mode, has_model_state)
    state = TrainState(step=0, model=model,
                       optimizer=optimizer(dp.parameters(model)),
                       seed=int(config.seed))
    # A captured step needs collectives CUDA graphs can hold: NCCL's (or
    # none); gloo's run on the host, so over gloo the step runs eagerly.
    capture = dev.type == "cuda" and mesh.backend in ("", "nccl")
    step_capture = ("cuda_graph" if capture else
                    "eager: the CPU captures nothing" if dev.type != "cuda" else
                    f"eager: {mesh.backend} collectives cannot be captured")
    dp.attach(model)
    log.info("train step: mode %r over %d rank(s) (%s), grad_accum_steps "
             "%d; step %s", dp_mode, mesh.size, mesh.backend or "no group",
             dp.accum, step_capture)
    start_step = 0
    replayed_steps = 0
    if checkpoint_dir:
        restored = _restore_latest(checkpoint_dir, state, dp)
        if restored is not None:
            start_step = restored
            log.info("resumed from checkpoint step %d", start_step)
        executed = _read_progress_step(checkpoint_dir)
        if executed > start_step:
            replayed_steps = executed - start_step

    # ---- live telemetry: the reference's train gauges, same names
    reg = default_registry()
    g_step_s = reg.gauge(
        "train_step_seconds", "Mean wall time per step over the last window.",
    )
    g_eps = reg.gauge(
        "train_examples_per_sec", "Window throughput at window cadence.",
    )
    g_tps = reg.gauge(
        "train_tokens_per_sec", "Window token throughput (0 when the "
        "batch carries no token-shaped integer feature).",
    )
    g_input_wait = reg.gauge(
        "train_host_input_wait_seconds_total",
        "Cumulative post-warmup host time spent feeding batches.",
    )
    g_device_mem = reg.gauge(
        "train_device_memory_bytes",
        "Bytes allocated on the training device (0 on the CPU).",
    )
    g_steps = reg.gauge("train_steps_total", "Steps completed so far.")
    c_phase = reg.counter(
        "train_window_time_seconds",
        "Post-warmup window wall-clock attributed per phase (infeed_wait | "
        "device_compute | device_collective | host); the phases of each "
        "window sum to its wall-clock.",
        labels=("phase",),
    )
    g_mfu = reg.gauge(
        "train_mfu",
        "Model-FLOPs utilization: counted FLOPs/step x post-warmup steps / "
        "device-compute seconds / (peak chip FLOPs x chips); 0 until "
        "measured (needs collect_cost_analysis and a known peak).",
    )
    g_dev_peak = reg.gauge(
        "device_memory_peak_bytes",
        "Per-device high-water mark of allocated bytes, at window cadence.",
        labels=("device",),
    )
    c_compiles_warm = reg.counter(
        "train_compiles_after_warm_total",
        "Captures of the training step (CUDA graphs; new batch signatures "
        "on the CPU) after the first window retired: each one is a mid-run "
        "stall; steady state is 0.",
    )
    c_compile_s = reg.counter(
        "train_compile_seconds_total",
        "Cumulative capture wall-clock of the training step, split by when "
        "it happened (warmup = before the first window retired, steady = "
        "after).",
        labels=("when",),
    )
    g_mfu.set(0.0)
    c_compiles_warm.inc(0)  # materialize the zero: absence is not proof
    tokens_per_example = max(
        (int(np.prod(np.asarray(v).shape[1:])) for v in first_batch.values()
         if np.asarray(v).dtype.kind in "iu" and np.asarray(v).ndim >= 2),
        default=0,
    )
    monitor = HealthMonitor(
        "train_loop",
        stall_timeout_s=config.stall_timeout_s,
        on_alert=config.health_alert_cb,
    )
    tb_writer = (SummaryWriter(config.tensorboard_dir)
                 if config.tensorboard_dir and writer else None)
    last_tb = {"train": -1, "eval": -1}

    def tb_write(kind: str, at_step: int, scalars: Dict[str, float]) -> None:
        if tb_writer is None or not scalars:
            return
        tb_writer.write_scalars(at_step, scalars)  # flushed per write
        last_tb[kind] = at_step

    eff_window = _effective_window_steps(config)
    step = start_step
    t_start: Optional[float] = None
    anchors: list = []          # (step, host time) at each forced device read
    examples_after_t0 = 0
    input_wait_s = 0.0
    phase_totals = {
        "infeed_wait": 0.0, "device_compute": 0.0,
        "device_collective": 0.0, "host": 0.0,
    }
    metrics: Optional[Dict[str, float]] = None
    saved_step = start_step if start_step else None
    window_anchor = (step, time.perf_counter())

    def publish(at_step: int, n_steps: int, window_s: float) -> None:
        if n_steps > 0 and window_s > 0:
            step_s = window_s / n_steps
            g_step_s.set(step_s)
            g_eps.set(config.batch_size / step_s)
            g_tps.set(config.batch_size * tokens_per_example / step_s)
        g_input_wait.set(input_wait_s)
        g_steps.set(at_step)
        if dev.type == "cuda":
            g_device_mem.set(float(torch.cuda.memory_allocated(dev)))
            g_dev_peak.labels(str(dev.index or 0)).set(
                float(torch.cuda.max_memory_allocated(dev)))

    def emit_eval(at_step: int) -> None:
        ev = _run_eval(state.model, loss_fn, eval_iter_fn, config, dev)
        if metrics_cb:
            metrics_cb(at_step, {f"eval_{k}": v for k, v in ev.items()})
        tb_write("eval", at_step, {f"eval_{k}": v for k, v in ev.items()})
        log.info("step %d eval: %s", at_step, ev)

    def window_lengths(start: int):
        s = start
        while s < config.train_steps:
            stop = s + eff_window
            for every in (
                config.eval_every if eval_iter_fn is not None else 0,
                config.checkpoint_every if checkpoint_dir else 0,
            ):
                if every:
                    stop = min(stop, ((s // every) + 1) * every)
            stop = min(stop, config.train_steps)
            yield stop - s
            s = stop

    compiles_after_warm = 0
    compile_seconds = 0.0
    saver = None
    if checkpoint_dir:
        saver = _AsyncCheckpointSaver(checkpoint_dir, config.keep_checkpoints,
                                      dev, dp=dp, write=writer)
    source = itertools.chain([first_batch], train_it)
    source = map(dp.local_batch, source)
    infeed = windowed_infeed(source, window_lengths(step), WindowStager(dev))
    n_chips = mesh.size
    coll_frac = dp.collective_fraction(model, sum(
        np.asarray(v).nbytes for v in first_batch.values()) // n_chips)
    profiler = None
    profile_warmup = min(1, config.profile_from)
    tracker.training_prep_end()
    runner = _TrainStep(state, loss_fn, dev,
                        _take_side_stream(dev) if capture else None, dp)
    try:
        while step < config.train_steps:
            if (config.profile_dir and profiler is None
                    and step - start_step == config.profile_from - profile_warmup):
                profiler = _start_profiler(
                    dev, profile_warmup, config.profile_to - config.profile_from)
            t_in = time.perf_counter()
            tracker.data_loading_start()
            try:
                item = next(infeed, None)
            finally:
                tracker.data_loading_end()
            t_fetched = time.perf_counter()
            infeed_s = t_fetched - t_in
            if item is None:
                log.info("train iterator exhausted at step %d", step)
                break
            if t_start is not None:
                input_wait_s += infeed_s
            w, window = item
            window.wait()
            rows: Optional[torch.Tensor] = None
            for i in range(w):
                tracker.step_start(step + i)
                row, capture_s = runner.run(window.step(i), step + i)
                if capture_s is not None:
                    compile_seconds += capture_s
                    steady = t_start is not None
                    c_compile_s.labels("steady" if steady else "warmup").inc(
                        capture_s)
                    if steady:
                        compiles_after_warm += 1
                        c_compiles_warm.inc()
                if rows is None:
                    rows = torch.empty((w, row.numel()), device=dev)
                rows[i].copy_(row)
            # ONE device-to-host fetch per window: every step's row is a data
            # dependency of it, so the copy proves the window executed before
            # the clock is read.
            host = rows.cpu().numpy()
            window.release()
            step += w
            state.step = step
            if profiler is not None:
                profiler.step()
            if profiler is not None and step - start_step >= config.profile_to:
                # The fetch above proved the profiled steps executed.
                _stop_profiler(profiler, config, start_step)
                profiler = None
            now = time.perf_counter()
            if t_start is None:
                t_start = now  # the first window absorbs warm-up
                anchors.append((step, now))
            else:
                examples_after_t0 += w * config.batch_size
                device_s = now - t_fetched
                host_s = max(0.0, (now - window_anchor[1]) - infeed_s - device_s)
                phases = {"infeed_wait": infeed_s,
                          "device_compute": device_s * (1.0 - coll_frac),
                          "device_collective": device_s * coll_frac,
                          "host": host_s}
                for ph, secs in phases.items():
                    phase_totals[ph] += secs
                    c_phase.labels(ph).inc(secs)
                _obs.instant(
                    "window_breakdown", cat="trainer",
                    args={
                        "step": step, "window_steps": w,
                        "window_s": now - window_anchor[1], **phases,
                    },
                )
                if eff_window > 1 or (
                    config.anchor_every
                    and (step - anchors[0][0]) % config.anchor_every == 0
                ):
                    anchors.append((step, now))
            names = ["loss", *runner.keys]
            for i in range(w):
                s_i = step - w + 1 + i
                monitor.heartbeat(s_i, loss=float(host[i, 0]))
                if config.log_every and s_i % config.log_every == 0:
                    host_metrics = {k: float(host[i, j]) for j, k in enumerate(names)}
                    if metrics_cb:
                        metrics_cb(s_i, host_metrics)
                    tb_write("train", s_i, host_metrics)
                    log.info("step %d: %s", s_i, host_metrics)
            metrics = {k: float(host[-1, j]) for j, k in enumerate(names)}
            publish(step, step - window_anchor[0], now - window_anchor[1])
            window_anchor = (step, now)
            if checkpoint_dir:
                if writer:
                    _write_progress(checkpoint_dir, step)
                if config.checkpoint_every and step % config.checkpoint_every == 0:
                    saver.save(state)
                    saved_step = step
            if (eval_iter_fn is not None and config.eval_every
                    and step % config.eval_every == 0):
                emit_eval(step)

        if profiler is not None:
            _stop_profiler(profiler, config, start_step)
            profiler = None
        elapsed = max(1e-9, time.perf_counter() - (t_start or time.perf_counter()))
        final_metrics: Dict[str, float] = dict(metrics or {})
        if eval_iter_fn is not None:
            ev = _run_eval(state.model, loss_fn, eval_iter_fn, config, dev)
            final_metrics.update({f"eval_{k}": v for k, v in ev.items()})
        if tb_writer is not None:
            # Only what the in-loop cadence did not already write at this
            # step: a same-tag, same-step rewrite doubles a point.
            tail: Dict[str, float] = {}
            if step != last_tb["train"]:
                tail.update({k: v for k, v in final_metrics.items()
                             if not k.startswith("eval_")})
            if step != last_tb["eval"]:
                tail.update({k: v for k, v in final_metrics.items()
                             if k.startswith("eval_")})
            tb_write("train", step, tail)
        if saver is not None:
            if saved_step != step:
                saver.save(state)
            saver.fence()  # the final checkpoint is on disk before returning
            if writer:
                _write_progress(checkpoint_dir, step)
    finally:
        dp.detach()
        _give_back_side_stream(dev, runner.stream)
        infeed.close()  # stops the prefetch thread
        if saver is not None:
            saver.join()  # no save thread outlives the loop, error or not
        if profiler is not None:
            profiler.stop()
        monitor.close()
        if tb_writer is not None:
            tb_writer.close()

    cost_flops = None
    cost_source = ""
    if config.collect_cost_analysis and metrics is not None:
        # After the timed loop, so the count cannot touch the throughput.
        # One rank's step on its rows, times the ranks: the global step's.
        sample = dp.local_batch(first_batch)
        cost_flops = count_step_flops(
            state.model, loss_fn, _to_device(sample, dev), config.seed) * n_chips
        cost_source = "counted"
    dp.unshard(state.model)  # fsdp: the returned model is whole
    steps_measured = (examples_after_t0 / config.batch_size
                      if config.batch_size else 0)
    peak = _peak_flops(config, dev)
    mfu = None
    if cost_flops and peak and steps_measured > 0:
        device_s = phase_totals["device_compute"] or elapsed
        if device_s > 0:
            mfu = cost_flops * steps_measured / device_s / (peak * n_chips)
            g_mfu.set(round(mfu, 4))

    eps = examples_after_t0 / elapsed if examples_after_t0 else 0.0
    window_rates = sorted(
        (s2 - s1) * config.batch_size / (t2 - t1)
        for (s1, t1), (s2, t2) in zip(anchors, anchors[1:]) if t2 > t1
    )
    anchored_eps = window_rates[len(window_rates) // 2] if window_rates else 0.0

    tracker.job_end()
    gsum = tracker.summary()
    proxy_goodput = (
        round(max(0.0, 1.0 - input_wait_s / elapsed), 4)
        if examples_after_t0 else 1.0
    )
    # The tracker's figure, where it could compute one; the proxy only
    # when it could not, and then the source says so.
    goodput = gsum.get("goodput", proxy_goodput)
    goodput_source = "goodput_tracker" if gsum else "host_input_wait_proxy"
    window_phase_seconds = {k: round(v, 6) for k, v in phase_totals.items()}
    # The reference's trace summaries (no-ops outside a traced run).
    _obs.instant(
        "goodput_summary", cat="trainer",
        args={
            "goodput": goodput,
            "source": goodput_source,
            "badput": gsum.get("badput", {}),
            "goodput_post_compile": proxy_goodput,
            "steps_completed": step,
            "replayed_steps": replayed_steps,
        },
    )
    _obs.instant(
        "train_telemetry_summary", cat="trainer",
        args={
            "window_phase_seconds": window_phase_seconds,
            "compiles_after_warm": compiles_after_warm,
            "compile_seconds": round(compile_seconds, 6),
            "collective_fraction_est": round(coll_frac, 6),
            "mfu": mfu,
            "window_steps": eff_window,
        },
    )
    result = TrainResult(
        final_metrics=final_metrics,
        examples_per_sec=round(eps, 2),
        examples_per_sec_per_chip=round(eps / n_chips, 2),
        anchored_examples_per_sec_per_chip=round(anchored_eps / n_chips, 2),
        anchor_windows=len(window_rates),
        steps_completed=step,
        resumed_from_step=start_step,
        goodput=goodput,
        goodput_source=goodput_source,
        goodput_post_compile=proxy_goodput,
        badput=gsum.get("badput", {}),
        cost_analysis_flops_per_step=cost_flops,
        cost_analysis_source=cost_source,
        mfu=round(mfu, 4) if mfu is not None else None,
        window_steps=eff_window,
        replayed_steps=replayed_steps,
        window_phase_seconds=window_phase_seconds if eff_window > 1 else {},
        compiles_after_warm=compiles_after_warm,
        dp_collective=dp_mode,
        collective_fraction_est=round(coll_frac, 6),
        step_capture=step_capture,
    )
    return state.model, result
