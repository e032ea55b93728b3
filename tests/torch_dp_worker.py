"""The ranks of the data-parallel tests (tests/test_torch_dp_window.py).

Each world size runs in processes of its own, spawned by :func:`spawn`
with a gloo process group over a file store, one CPU thread each (so every
rank and the world of one run the same kernels and the ordered mode can be
held bit for bit).  A rank runs a list of scenarios and saves what each
returned to ``<out>/<rank>.pt``.  This module imports no JAX: a spawned
rank imports it, and JAX is the parent's.

:func:`probe` spawns two ranks on the one card (card-only tests): which
collectives a backend carries on CUDA tensors there.

The models are the reference's test models in the port's form:
``tests/test_multichip_window.py``'s two-layer MLP (and its loss, which
broadcasts a [B, 1] prediction against [B] targets), and
``tests/test_fsdp_window.py``'s four-layer tanh MLP with its EMA model
state.
"""

from __future__ import annotations

import datetime
import os
import traceback

import numpy as np
import torch
from torch import nn

BATCH = 64
G = 8           # fixed global gradient-block count, shared by every W
D = 128         # the deep MLP's width
LAYERS = 4


def batches(n, batch=BATCH, seed=0):
    """The reference's ``tests/test_multichip_window.py`` batches."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.normal(size=(batch, 4)).astype(np.float32)
        y = (x @ np.array([3.0, -2.0, 1.0, 0.5], np.float32) + 1.0).astype(np.float32)
        out.append({"x": x, "y": y})
    return out


def deep_batches(n, batch=BATCH, seed=0):
    """The reference's ``tests/test_fsdp_window.py`` batches."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.normal(size=(batch, D)).astype(np.float32)
        y = np.tanh(x[:, :1] * 0.3).astype(np.float32)
        out.append({"x": x, "y": y})
    return out


class MLP(nn.Module):
    def __init__(self):
        super().__init__()
        r = np.random.default_rng(7)
        self.w1 = nn.Parameter(torch.from_numpy(
            r.normal(size=(4, 8)).astype(np.float32) * 0.3))
        self.w2 = nn.Parameter(torch.from_numpy(
            r.normal(size=(8, 1)).astype(np.float32) * 0.3))


def mlp_init(generator, sample):
    return MLP()


def mlp_loss(model, b, generator):
    pred = torch.tanh(b["x"] @ model.w1) @ model.w2
    loss = torch.mean((pred - b["y"]) ** 2)
    return loss, {"w_norm": torch.sum(model.w1 ** 2)}


def masked_mlp_loss(model, b, generator):
    """Per-row squared error, weighted by the validity mask of a padded
    tail (``parallel.mesh.masked_mean``)."""
    from tpu_pipelines_torch.parallel.mesh import VALID_MASK_KEY, masked_mean

    pred = (torch.tanh(b["x"] @ model.w1) @ model.w2)[:, 0]
    loss = masked_mean((pred - b["y"]) ** 2, b.get(VALID_MASK_KEY))
    return loss, {"w_norm": torch.sum(model.w1 ** 2)}


class DeepMLP(nn.Module):
    """The fsdp test's model; ``running`` / ``count`` are its EMA state
    (the reference's ``_sloss_fn`` model_state), updated by every training
    forward."""

    def __init__(self):
        super().__init__()
        r = np.random.default_rng(7)
        self.layers = nn.ParameterDict()
        for i in range(LAYERS):
            self.layers[f"w_{i}"] = nn.Parameter(torch.from_numpy(
                r.normal(size=(D, D)).astype(np.float32) * 0.05))
            self.layers[f"b_{i}"] = nn.Parameter(torch.zeros(D))
        self.head = nn.Parameter(torch.from_numpy(
            r.normal(size=(D, 1)).astype(np.float32) * 0.05))
        self.register_buffer("running", torch.zeros(()))
        self.register_buffer("count", torch.zeros((), dtype=torch.int32))


def deep_init(generator, sample):
    return DeepMLP()


def deep_loss(model, b, generator):
    h = b["x"]
    for i in range(LAYERS):
        h = torch.tanh(h @ model.layers[f"w_{i}"] + model.layers[f"b_{i}"])
    pred = h @ model.head
    pred_mean = torch.mean(pred)
    if model.training:
        with torch.no_grad():
            model.running.copy_(0.9 * model.running + 0.1 * pred_mean)
            model.count.add_(1)
    return torch.mean((pred - b["y"]) ** 2), {"pred_mean": pred_mean}


def _run(*, model="mlp", dp="ordered", steps=16, window=4, log_every=4,
         data=None, ckpt="", checkpoint_every=0, buckets=2, accum=1,
         opt="adam", lr=0.05, state=False, loss=None):
    """One train_loop run on this rank; returns its parameters, buffers,
    (step, loss, metric) series, TrainResult fields, the collectives it
    issued by name and the bytes of the parameters and optimizer moments
    it held."""
    from tpu_pipelines_torch.trainer import TrainLoopConfig, train_loop

    init, loss_fn, make = {
        "mlp": (mlp_init, mlp_loss, batches),
        "masked": (mlp_init, masked_mlp_loss, batches),
        "deep": (deep_init, deep_loss, deep_batches),
    }[model]
    optimizers, held_bytes = [], []

    def optimizer(params):
        params = list(params)
        held_bytes.append(sum(p.numel() * p.element_size() for p in params))
        optimizers.append(torch.optim.Adam(params, lr=lr) if opt == "adam"
                          else torch.optim.SGD(params, lr=lr))
        return optimizers[-1]

    hist, collectives = [], {}
    metric = "w_norm" if model != "deep" else "pred_mean"

    def counted(name, real):
        def call(*args, **kwargs):
            collectives[name] = collectives.get(name, 0) + 1
            return real(*args, **kwargs)
        return call

    dist = torch.distributed
    reals = {n: getattr(dist, n) for n in (
        "all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor")}
    for name, real in reals.items():
        setattr(dist, name, counted(name, real))
    try:
        out_model, result = train_loop(
            loss_fn=loss or loss_fn, init_params_fn=init, optimizer=optimizer,
            train_iter=iter(data if data is not None else make(steps)),
            config=TrainLoopConfig(
                train_steps=steps, batch_size=BATCH, log_every=log_every,
                window_steps=window, dp_collective=dp, dp_grad_blocks=G,
                collective_buckets=buckets, checkpoint_every=checkpoint_every,
                grad_accum_steps=accum),
            checkpoint_dir=ckpt, has_model_state=state, device="cpu",
            metrics_cb=lambda s, m: hist.append((s, m["loss"], m[metric])),
        )
    finally:
        for name, real in reals.items():
            setattr(dist, name, real)
    # What the rank held while it trained: the parameters the optimizer
    # was built over (under fsdp the shards; the returned model is whole)
    # and the optimizer's moments.
    moment_bytes = sum(v.numel() * v.element_size()
                       for s in optimizers[0].state.values()
                       for k, v in s.items() if k in ("exp_avg", "exp_avg_sq"))
    return {
        "params": {n: p.detach().clone() for n, p in out_model.named_parameters()},
        "buffers": {n: b.detach().clone() for n, b in out_model.named_buffers()},
        "hist": hist,
        "steps_completed": result.steps_completed,
        "resumed_from_step": result.resumed_from_step,
        "replayed_steps": result.replayed_steps,
        "dp_collective": result.dp_collective,
        "step_capture": result.step_capture,
        "final_metrics": result.final_metrics,
        "param_bytes": held_bytes[0],
        "collectives": collectives,
        "moment_bytes": moment_bytes,
    }


def _one_step_grads(*, dp, accum, world):
    """The gradient of one step of the deep MLP: SGD at lr 1 from the
    initial parameters, so the update is minus the gradient."""
    got = _run(model="deep", dp=dp, steps=1, window=1, log_every=0,
               data=deep_batches(1), accum=accum, opt="sgd", lr=1.0)
    init = DeepMLP()
    return {n: (dict(init.named_parameters())[n].detach() - p)
            for n, p in got["params"].items()}


def _bert_run_fn(*, examples, base_model, out_dir, hp, steps):
    """``bert_module.run_fn`` at ``mesh_config={"data": W}`` in
    psum_bucketed from a base model; the losses of rank 0's loop."""
    from tpu_pipelines_torch.examples import bert_module
    from tpu_pipelines_torch.trainer.fn_args import FnArgs

    losses = []
    real = bert_module.train_loop

    def recording(**kwargs):
        kwargs["metrics_cb"] = lambda s, m: losses.append((s, m["loss"]))
        return real(**kwargs)

    bert_module.train_loop = recording
    try:
        result = bert_module.run_fn(FnArgs(
            train_examples_uri=examples, eval_examples_uri=examples,
            serving_model_dir=os.path.join(out_dir, "model"),
            model_run_dir=os.path.join(out_dir, "run"), train_steps=steps,
            hyperparameters=hp, mesh_config={"data": torch.distributed.get_world_size()},
            custom_config={"base_model_uri": base_model, "train_loop": {
                "dp_collective": "psum_bucketed", "log_every": 1,
                "window_steps": 1}},
            device="cpu"))
    finally:
        bert_module.train_loop = real
    return {"losses": losses, "dp_collective": result.dp_collective,
            "steps_completed": result.steps_completed}


SCENARIOS = {"run": _run, "grads": _one_step_grads, "bert": _bert_run_fn}


def _scenario(kind):
    """A scenario by kind: one of SCENARIOS, or "module:function" of a
    module beside this one (tests/torch_sp_worker.py's)."""
    if ":" not in kind:
        return SCENARIOS[kind]
    import importlib

    module, _, fn = kind.partition(":")
    return getattr(importlib.import_module(module), fn)


def _rank(rank, world, init_file, out_dir, scenarios):
    torch.set_num_threads(1)
    results = {}
    try:
        torch.distributed.init_process_group(
            "gloo", init_method=f"file://{init_file}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=90))
        for name, kind, kwargs in scenarios:
            if kind == "grads":
                kwargs = {**kwargs, "world": world}
            results[name] = _scenario(kind)(**kwargs)
    except BaseException:  # noqa: BLE001 (reported to the parent)
        results["__error__"] = traceback.format_exc()
    torch.save(results, os.path.join(out_dir, f"{rank}.pt.tmp"))
    os.replace(os.path.join(out_dir, f"{rank}.pt.tmp"),
               os.path.join(out_dir, f"{rank}.pt"))
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def spawn(world, scenarios, out_dir, timeout_s=300.0):
    """Run ``scenarios`` (``[(name, kind, kwargs), ...]``; a kind is a key
    of SCENARIOS or "module:function") on ``world``
    spawned ranks; returns each rank's ``{name: result}``.  The ranks are
    joined within ``timeout_s`` and killed past it (a hung collective
    fails the test instead of the suite)."""
    import multiprocessing as mp
    import time

    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.get_context("spawn")
    init_file = os.path.join(out_dir, "init")
    procs = [ctx.Process(target=_rank,
                         args=(r, world, init_file, out_dir, scenarios))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(0.1, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    out = []
    for r in range(world):
        path = os.path.join(out_dir, f"{r}.pt")
        if not os.path.exists(path):
            raise AssertionError(
                f"rank {r} of {world} left no result "
                f"({'killed after ' + str(timeout_s) + ' s' if r in hung else 'died'})")
        res = torch.load(path, weights_only=False)
        if "__error__" in res:
            raise AssertionError(f"rank {r} of {world} failed:\n{res['__error__']}")
        out.append(res)
    return out


# ---- two ranks on one card: the collectives a data-parallel step issues

PROBE_OPS = ("all_reduce", "all_gather_into_tensor", "all_gather",
             "reduce_scatter_tensor", "broadcast")
# The exchanges of sequence and expert parallelism
# (tpu_pipelines_torch/parallel/collectives.py): an all-to-all with uneven
# splits (zero-sized ones included, as a ring hop built on it sends to one
# rank alone) and grouped point-to-point sends and receives around a ring.
EXCHANGE_OPS = ("all_to_all_single_uneven", "all_to_all_single_ring",
                "batch_isend_irecv")


def _probe_collective(name, world, rank, dev):
    """Run collective ``name`` on ranks holding ``rank + 1``: "ok" when
    every value read back is right."""
    import torch.distributed as dist

    x = torch.full((4,), float(rank + 1), device=dev)
    every = torch.arange(1, world + 1, device=dev).float()
    if name == "all_reduce":
        dist.all_reduce(x)
        out, want = x, every.sum().expand(4)
    elif name == "all_gather_into_tensor":
        out = torch.empty(4 * world, device=dev)
        dist.all_gather_into_tensor(out, x)
        want = every.repeat_interleave(4)
    elif name == "all_gather":
        outs = [torch.empty(4, device=dev) for _ in range(world)]
        dist.all_gather(outs, x)
        out, want = torch.cat(outs), every.repeat_interleave(4)
    elif name == "reduce_scatter_tensor":
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, x.repeat(world)[:2 * world].contiguous())
        want = every.sum().expand(2)
    elif name == "all_to_all_single_uneven":
        # rank r sends r + j + 1 values of 10 r + j to rank j
        ins = range(world)
        inp = torch.cat([torch.full((rank + j + 1,), float(10 * rank + j),
                                    device=dev) for j in ins])
        out = torch.empty(sum(j + rank + 1 for j in ins), device=dev)
        dist.all_to_all_single(out, inp,
                               output_split_sizes=[j + rank + 1 for j in ins],
                               input_split_sizes=[rank + j + 1 for j in ins])
        want = torch.cat([torch.full((j + rank + 1,), float(10 * j + rank),
                                     device=dev) for j in ins])
    elif name == "all_to_all_single_ring":
        nxt, prev = (rank + 1) % world, (rank - 1) % world
        out = torch.empty(4, device=dev)
        dist.all_to_all_single(
            out, x, output_split_sizes=[4 if j == prev else 0 for j in range(world)],
            input_split_sizes=[4 if j == nxt else 0 for j in range(world)])
        want = torch.full((4,), float(prev + 1), device=dev)
    elif name == "batch_isend_irecv":
        nxt, prev = (rank + 1) % world, (rank - 1) % world
        out = torch.empty(4, device=dev)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, nxt),
                                           dist.P2POp(dist.irecv, out, prev)]):
            req.wait()
        want = torch.full((4,), float(prev + 1), device=dev)
    else:
        dist.broadcast(x, src=0)
        out, want = x, torch.ones(4, device=dev)
    torch.cuda.synchronize(dev)
    return "ok" if torch.equal(out, want) else f"wrong values {out.tolist()}"


def _probe_rank(rank, world, backend, init_file, out_dir, ops=PROBE_OPS):
    """One rank on device 0: joins a ``backend`` group and runs each of
    ``ops``, saving "ok" or the error of each to ``<rank>.pt`` (a refused
    collective is recorded and the next one tried)."""
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    found = {}
    try:
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=60))
        for name in ops:
            try:
                found[name] = _probe_collective(name, world, rank, dev)
            except Exception as e:  # noqa: BLE001 (what the backend refused)
                if name in PROBE_OPS:
                    raise
                found[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:240]}"
    except Exception as e:  # noqa: BLE001 (what the backend refused)
        found["error"] = f"{type(e).__name__}: {str(e).splitlines()[0][:240]}"
    torch.save(found, os.path.join(out_dir, f"{rank}.pt"))
    os._exit(0)  # a refused NCCL communicator may hang its teardown


def probe(backend, out_dir, world=2, timeout_s=120.0, ops=PROBE_OPS):
    """Each rank's findings for ``world`` ranks of ``backend`` on device 0
    running ``ops``, joined within ``timeout_s`` and killed past it (a rank
    that left nothing reads ``{"error": ...}``)."""
    import multiprocessing as mp
    import time

    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_probe_rank, args=(
        r, world, backend, os.path.join(out_dir, "init"), out_dir, ops))
        for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(0.1, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    out = []
    for r in range(world):
        path = os.path.join(out_dir, f"{r}.pt")
        out.append(torch.load(path) if os.path.exists(path) else
                   {"error": f"no answer within {timeout_s:.0f} s"})
    return out
