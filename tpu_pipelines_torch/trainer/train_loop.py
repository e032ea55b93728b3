"""Training loop on one device: the port of
``tpu_pipelines/trainer/train_loop.py`` (single-device path).

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
``keep_checkpoints`` kept); a run resumes from the latest.
``window_progress.json`` records the furthest executed step, so a resume
reports the steps it replays.

Not ported, and refused with ``NotImplementedError`` naming the
``ROADMAP.md`` item rather than ignored: meshes, partitions and
data-parallel collectives (A5), gradient accumulation (A5), models with
mutable state (A7), the profiler, TensorBoard, cost analysis and the MFU
that rests on it (A11): ``TrainResult.mfu`` stays None and the
``train_mfu`` gauge 0.  The reference's ``prng_impl`` (a JAX key
implementation) has no counterpart here, and ``donate_state`` none but
the in-place replays above: the fields do not exist.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import logging
import os
import re
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tpu_pipelines_torch.data.input_pipeline import WindowStager, windowed_infeed
from tpu_pipelines_torch.observability.health import HealthMonitor
from tpu_pipelines_torch.observability.metrics import default_registry
from tpu_pipelines_torch.ops import flash_attention as fa
from tpu_pipelines_torch.trainer.export import resolve_device
from tpu_pipelines_torch.trainer.fn_args import TrainResult

log = logging.getLogger("tpu_pipelines_torch.trainer")

# Peak per-chip dense bf16 FLOP/s by device name, the denominator of an
# MFU figure; 0.0 for a card not in the table (an assumed denominator
# would publish a made-up utilization).  H100 SXM: 989 TFLOP/s (NVIDIA
# data sheet).
_PEAK_BF16_FLOPS = [("h100", 989e12)]
ENV_WINDOW_STEPS = "TPP_WINDOW_STEPS"
ENV_DP_COLLECTIVE = "TPP_DP_COLLECTIVE"
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
    # Called as cb(kind, detail) when a watchdog fires ("nan",
    # "loss_spike").
    health_alert_cb: Optional[Callable[[str, str], None]] = None
    # ---- not ported: a non-default value raises NotImplementedError.
    mesh_config: Optional[Any] = None
    param_partition: Optional[Any] = None
    batch_partition: Optional[Dict[str, Any]] = None
    dp_collective: Optional[str] = None
    collective_buckets: int = 2
    dp_grad_blocks: Optional[int] = None
    grad_accum_steps: int = 1
    profile_dir: str = ""
    tensorboard_dir: str = ""
    collect_cost_analysis: bool = False
    peak_flops_per_chip: Optional[float] = None


# field, default, ROADMAP.md item, what it waits for
_UNPORTED = (
    ("mesh_config", None, "A5", "multi-GPU meshes"),
    ("param_partition", None, "A5", "partitioned parameters"),
    ("batch_partition", None, "A5", "partitioned batches"),
    ("dp_collective", None, "A5", "data-parallel collectives"),
    ("collective_buckets", 2, "A5", "data-parallel collectives"),
    ("dp_grad_blocks", None, "A5", "data-parallel collectives"),
    ("grad_accum_steps", 1, "A5", "gradient accumulation"),
    ("profile_dir", "", "A11", "profiler capture"),
    ("tensorboard_dir", "", "A11", "the TensorBoard sink"),
    ("collect_cost_analysis", False, "A11", "counted-FLOP cost analysis"),
    ("peak_flops_per_chip", None, "A11", "MFU from a counted FLOP figure"),
)


def _refuse_unported(config: TrainLoopConfig, mesh, has_model_state) -> None:
    asked = [
        (name, getattr(config, name), item, what)
        for name, default, item, what in _UNPORTED
        if getattr(config, name) != default
        and not (name == "dp_collective" and config.dp_collective == "auto")
        and not (name == "grad_accum_steps" and config.grad_accum_steps <= 1)
    ]
    env_dp = os.environ.get(ENV_DP_COLLECTIVE, "").strip()
    if env_dp not in ("", "auto"):
        asked.append((ENV_DP_COLLECTIVE, env_dp, "A5", "data-parallel collectives"))
    if mesh is not None:
        asked.append(("mesh", mesh, "A5", "multi-GPU meshes"))
    if has_model_state:
        asked.append(("has_model_state", True, "A7", "models with mutable state"))
    if asked:
        name, value, item, what = asked[0]
        raise NotImplementedError(
            f"train_loop: {name}={value!r} is not ported yet ({what}, "
            f"ROADMAP.md {item}); the port trains on one device"
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
    return max(1, int(w or 0))


_MASK64 = (1 << 64) - 1


def _step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s generator: a splitmix64 mix of
    ``(seed, step)``, so neighbouring steps and seeds draw unrelated
    streams."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(step) + 1) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) & ((1 << 63) - 1)


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
    None unless this step met a new batch signature (0.0 on the CPU,
    which captures nothing)."""

    def __init__(self, state: "TrainState", loss_fn: Callable, device: torch.device):
        self.state = state
        self.loss_fn = loss_fn
        self.device = device
        self.generator = torch.Generator(device=device)
        self.keys: Optional[list] = None
        self.signatures: set = set()
        self.captured: Dict[tuple, _Captured] = {}
        self.pool = None
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def _step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        loss, metrics = self.loss_fn(self.state.model, batch, self.generator)
        self.state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.state.optimizer.step()
        if self.keys is None:
            self.keys = sorted(metrics)
        return torch.stack([
            torch.as_tensor(v, device=self.device).detach().float().reshape(())
            for v in [loss, *(metrics[k] for k in self.keys)]
        ])

    def run(self, batch: Dict[str, torch.Tensor], step: int):
        self.generator.manual_seed(_step_seed(self.state.seed, step))
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
        graph.register_generator_state(self.generator)
        try:
            with fa.launch_tally() as tally, torch.cuda.graph(
                    graph, pool=self.pool, stream=self.stream):
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


def _save_checkpoint(checkpoint_dir: str, state: TrainState, keep: int) -> None:
    os.makedirs(checkpoint_dir, exist_ok=True)
    payload = {
        "step": state.step,
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
    }
    path = os.path.join(checkpoint_dir, f"ckpt_{state.step}.pt")
    _atomic_write(path, lambda tmp: torch.save(payload, tmp))
    if keep > 0:
        steps = sorted(_checkpoints(checkpoint_dir))
        for old in steps[:-keep]:
            os.unlink(os.path.join(checkpoint_dir, f"ckpt_{old}.pt"))


def _restore_latest(checkpoint_dir: str, state: TrainState) -> Optional[int]:
    found = _checkpoints(checkpoint_dir)
    if not found:
        return None
    latest = max(found)
    device = next(state.model.parameters()).device
    payload = torch.load(found[latest], map_location=device, weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
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
    """Train on ``device``; returns ``(model, TrainResult)``.  See the
    module docstring for the contract."""
    _refuse_unported(config, mesh, has_model_state)
    dev = resolve_device(device)

    train_it = iter(train_iter)
    first_batch = next(train_it)
    model = init_params_fn(
        torch.Generator().manual_seed(int(config.seed)), first_batch
    )
    model.to(dev).train()
    state = TrainState(
        step=0, model=model, optimizer=optimizer(model.parameters()),
        seed=int(config.seed),
    )
    start_step = 0
    replayed_steps = 0
    if checkpoint_dir:
        restored = _restore_latest(checkpoint_dir, state)
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
        "Model-FLOPs utilization; 0 until measured (the port has no "
        "counted-FLOP cost analysis yet).",
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
    monitor = HealthMonitor("train_loop", on_alert=config.health_alert_cb)

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

    runner = _TrainStep(state, loss_fn, dev)
    compiles_after_warm = 0
    infeed = windowed_infeed(itertools.chain([first_batch], train_it),
                             window_lengths(step), WindowStager(dev))
    try:
        while step < config.train_steps:
            t_in = time.perf_counter()
            item = next(infeed, None)
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
                row, capture_s = runner.run(window.step(i), step + i)
                if capture_s is not None:
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
            now = time.perf_counter()
            if t_start is None:
                t_start = now  # the first window absorbs warm-up
                anchors.append((step, now))
            else:
                examples_after_t0 += w * config.batch_size
                device_s = now - t_fetched
                host_s = max(0.0, (now - window_anchor[1]) - infeed_s - device_s)
                phases = {"infeed_wait": infeed_s, "device_compute": device_s,
                          "device_collective": 0.0, "host": host_s}
                for ph, secs in phases.items():
                    phase_totals[ph] += secs
                    c_phase.labels(ph).inc(secs)
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
                    log.info("step %d: %s", s_i, host_metrics)
            metrics = {k: float(host[-1, j]) for j, k in enumerate(names)}
            publish(step, step - window_anchor[0], now - window_anchor[1])
            window_anchor = (step, now)
            if checkpoint_dir:
                _write_progress(checkpoint_dir, step)
                if config.checkpoint_every and step % config.checkpoint_every == 0:
                    _save_checkpoint(checkpoint_dir, state, config.keep_checkpoints)
                    saved_step = step
            if (eval_iter_fn is not None and config.eval_every
                    and step % config.eval_every == 0):
                emit_eval(step)
    finally:
        infeed.close()  # stops the prefetch thread

    elapsed = max(1e-9, time.perf_counter() - (t_start or time.perf_counter()))
    eps = examples_after_t0 / elapsed if examples_after_t0 else 0.0
    window_rates = sorted(
        (s2 - s1) * config.batch_size / (t2 - t1)
        for (s1, t1), (s2, t2) in zip(anchors, anchors[1:]) if t2 > t1
    )
    anchored_eps = window_rates[len(window_rates) // 2] if window_rates else 0.0

    final_metrics: Dict[str, float] = dict(metrics or {})
    if eval_iter_fn is not None:
        ev = _run_eval(state.model, loss_fn, eval_iter_fn, config, dev)
        final_metrics.update({f"eval_{k}": v for k, v in ev.items()})
    if checkpoint_dir:
        if saved_step != step:
            _save_checkpoint(checkpoint_dir, state, config.keep_checkpoints)
        _write_progress(checkpoint_dir, step)

    goodput = (
        round(max(0.0, 1.0 - input_wait_s / elapsed), 4)
        if examples_after_t0 else 1.0
    )
    result = TrainResult(
        final_metrics=final_metrics,
        examples_per_sec=round(eps, 2),
        examples_per_sec_per_chip=round(eps, 2),
        anchored_examples_per_sec_per_chip=round(anchored_eps, 2),
        anchor_windows=len(window_rates),
        steps_completed=step,
        resumed_from_step=start_step,
        goodput=goodput,
        goodput_source="host_input_wait_proxy",
        goodput_post_compile=goodput,
        window_steps=eff_window,
        replayed_steps=replayed_steps,
        window_phase_seconds=(
            {k: round(v, 6) for k, v in phase_totals.items()}
            if eff_window > 1 else {}
        ),
        compiles_after_warm=compiles_after_warm,
    )
    return state.model, result
