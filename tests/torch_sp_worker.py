"""The ranks of the sequence- and expert-parallel tests
(tests/test_torch_ring_attention.py, tests/test_torch_moe.py,
tests/test_torch_seq_parallel.py), spawned by ``torch_dp_worker.spawn``
with kinds "torch_sp_worker:<function>": gloo over a file store, one CPU
thread a rank.  Every rank builds the same global inputs from a seed, takes
its part of them on its mesh, and returns its part of the result; the
parent puts the parts together.  This module imports no JAX.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

# ---- inputs both sides make from a seed


def qkv(b=2, l=16, h=4, d=8, seed=0):
    """The reference test's ``_qkv``: three f32 [b, l, h, d] normals."""
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, l, h, d)).astype(np.float32)
                 for _ in range(3))


def padding_mask(b=2, l=16, seed=1):
    """The reference test's random padding, position 0 always valid."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((b, l)) > 0.4).astype(np.int32)
    mask[:, 0] = 1
    return mask


def _seq_mesh(n_data=1):
    from tpu_pipelines_torch.parallel.mesh import make_mesh

    world = torch.distributed.get_world_size()
    return make_mesh({"data": n_data, "seq": world // n_data}, device="cpu")


def _block(x, mesh, dim=1):
    n, r = mesh.axis_size("seq"), mesh.axis_rank("seq")
    k = x.shape[dim] // n
    return x.narrow(dim, r * k, k)


# ---- attention


def attention(cases):
    """Ring or Ulysses on this rank's blocks, for each case ``{"impl",
    "causal", "masked", "h", "l"}``: the output block and the gradients of
    ``sum(out ** 2)`` (every rank's term of the global sum) with respect
    to the q, k, v blocks."""
    from tpu_pipelines_torch.parallel.ring_attention import (
        ring_attention,
        ulysses_attention,
    )

    mesh = _seq_mesh()
    out = []
    for case in cases:
        q, k, v = (_block(torch.from_numpy(t), mesh).clone().requires_grad_()
                   for t in qkv(h=case.get("h", 4), l=case.get("l", 16)))
        mask = (_block(torch.from_numpy(padding_mask(l=case.get("l", 16))), mesh)
                if case.get("masked") else None)
        fn = ring_attention if case["impl"] == "ring" else ulysses_attention
        o = fn(q, k, v, mesh=mesh, causal=case["causal"], kv_mask=mask)
        (o.float() ** 2).sum().backward()
        out.append({"out": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad})
    return out


# ---- mixture of experts


def moe_ep(state, x, capacity_factor, dtype="float32"):
    """An MoE block of ``state``'s experts on a mesh of ``expert`` = the
    world: its output on ``x`` (every rank the whole batch) and the
    gradients of ``sum(out)`` for ``x``, the router and this rank's
    experts."""
    from tpu_pipelines_torch.models.transformer import MoEMlpBlock
    from tpu_pipelines_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"data": 1, "expert": torch.distributed.get_world_size()},
                     device="cpu")
    e, d, ff = state["wi"].shape
    block = MoEMlpBlock(d, e, ff, capacity_factor=capacity_factor,
                        dtype=getattr(torch, dtype), mesh=mesh)
    block.load_state_dict(state)
    xs = torch.as_tensor(x).clone().requires_grad_()
    losses = []
    out = block(xs, losses=losses)
    out.float().sum().backward()
    return {"out": out.detach(), "aux": losses[0].detach(), "dx": xs.grad,
            "grads": {n: p.grad for n, p in block.named_parameters()},
            "first_expert": block.held_experts().start}


# ---- BERT


def bert_logits(hp, state, batch, n_data):
    """A BERT classifier of ``state`` with ``hp``'s attention on a mesh of
    ``n_data`` x ``seq``: the logits of this rank's rows, its tokens its
    block of the sequence (the mesh's ``seq_split``), or whole rows with
    ``hp["_whole_rows"]``."""
    from tpu_pipelines_torch.models.bert import build_bert_model
    from tpu_pipelines_torch.parallel.mesh import shard_batch
    from tpu_pipelines_torch.parallel.ring_attention import (
        long_context_batch_partition,
    )

    mesh = _seq_mesh(n_data)
    whole = hp.pop("_whole_rows", False)
    model = build_bert_model(hp, mesh=mesh)
    model.load_state_dict(state)
    model.eval()
    bp = {} if whole else long_context_batch_partition(batch, mesh)
    local = shard_batch(batch, mesh, partition=bp)
    mesh.seq_split = bool(bp)
    with torch.no_grad():
        return model(local)


def _attention_model(h, dh):
    """The reference's ``test_ring_window_end_to_end...`` model: a qkv
    projection, attention, and a one-wide output."""
    from torch import nn

    r = np.random.default_rng(11)
    model = nn.Module()
    model.qkv = nn.Parameter(torch.from_numpy(
        r.normal(size=(h * dh, 3 * h * dh)).astype(np.float32) * 0.2))
    model.out = nn.Parameter(torch.from_numpy(
        r.normal(size=(h * dh, 1)).astype(np.float32) * 0.2))
    return model


def attention_batches(n, b=4, s=32, h=2, dh=4):
    r = np.random.default_rng(5)
    return [{"x": r.normal(size=(b, s, h * dh)).astype(np.float32),
             "y": r.normal(size=(b, s, 1)).astype(np.float32)}
            for _ in range(n)]


def seq_train(impl, steps=4, h=2, dh=4, split=True):
    """``train_loop`` over ``attention_batches`` with Adam 0.05 in windows
    of 2 (the reference's ring window test), its attention ``impl``
    ("ring", "ulysses" or "dense") on this rank's block of the sequence
    when ``split`` (``batch_partition`` from
    ``long_context_batch_partition``) or on whole rows.  Returns the
    parameters and the (step, loss) series."""
    from tpu_pipelines_torch.parallel.mesh import make_mesh
    from tpu_pipelines_torch.parallel.ring_attention import (
        dense_attention,
        long_context_batch_partition,
        ring_attention,
        ulysses_attention,
    )
    from tpu_pipelines_torch.trainer import TrainLoopConfig, train_loop

    world = (torch.distributed.get_world_size()
             if torch.distributed.is_initialized() else 1)
    mesh = make_mesh({"data": 1, "seq": world}, device="cpu")
    attend = {"ring": ring_attention, "ulysses": ulysses_attention}.get(impl)

    def loss_fn(model, b, generator):
        qkv_ = b["x"] @ model.qkv
        q, k, v = (t.reshape(*t.shape[:2], h, dh) for t in qkv_.chunk(3, dim=-1))
        if attend is None:
            o = dense_attention(q, k, v, causal=True)
        elif split:
            o = attend(q, k, v, mesh=mesh, causal=True)
        else:
            o = _whole_rows(attend, q, k, v, mesh)
        pred = o.reshape(*q.shape[:2], h * dh) @ model.out
        return torch.mean((pred - b["y"]) ** 2), {}

    data = attention_batches(steps, h=h, dh=dh)
    bp = long_context_batch_partition(data[0], mesh) if split else None
    hist = []
    model, result = train_loop(
        loss_fn=loss_fn, init_params_fn=lambda g, s: _attention_model(h, dh),
        optimizer=lambda p: torch.optim.Adam(p, lr=0.05),
        train_iter=iter(data),
        config=TrainLoopConfig(train_steps=steps, batch_size=4, log_every=1,
                               window_steps=2, batch_partition=bp),
        mesh=mesh, device="cpu",
        metrics_cb=lambda s, m: hist.append((s, m["loss"])))
    return {"params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "hist": hist, "steps_completed": result.steps_completed,
            "batch_partition": bp}


def _whole_rows(attend, q, k, v, mesh):
    from tpu_pipelines_torch.parallel import collectives

    out = attend(*(_block(t, mesh) for t in (q, k, v)), mesh=mesh, causal=True)
    return collectives.all_gather(out, 1, mesh.axis_group("seq"))


def bert_run_fn(examples, base_model, out_dir, hp, steps, mesh_config):
    """``bert_module.run_fn`` at ``mesh_config`` (no batch_partition: whole
    rows on every rank) from a base model; rank 0's (step, loss) series."""
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
            hyperparameters=hp, mesh_config=mesh_config,
            custom_config={"base_model_uri": base_model, "train_loop": {
                "log_every": 1, "window_steps": 1}},
            device="cpu"))
    finally:
        bert_module.train_loop = real
    return {"losses": losses, "steps_completed": result.steps_completed}


def bert_moe_train(hp, batches, mesh_config, steps, nudge=False):
    """A BERT classifier with ``hp["moe_experts"]`` through ``train_loop``
    on ``mesh_config`` (SGD 0.1, the MoE loss task + 0.01 aux); returns
    the whole model's parameters (the loop gathers the experts) and the
    (step, loss, moe_aux) series.  ``nudge``: rank 1 adds 1e-3 to its
    type embedding's gradient before the exchange, as a backward that
    sums in another order leaves a rank's shared gradient apart."""
    import torch.nn.functional as F

    from tpu_pipelines_torch.examples import bert_module
    from tpu_pipelines_torch.models.transformer import apply_with_moe_aux
    from tpu_pipelines_torch.parallel.mesh import make_mesh
    from tpu_pipelines_torch.trainer import TrainLoopConfig, train_loop

    mesh = make_mesh(mesh_config, device="cpu")

    def loss_fn(model, batch, generator):
        features = {k: v for k, v in batch.items() if k != "label"}
        logits, aux = apply_with_moe_aux(model, features, generator=generator)
        task = F.cross_entropy(logits.float(), batch["label"].long())
        return task + 0.01 * aux, {"moe_aux": aux}

    def init(generator, sample):
        model = bert_module.init_params_fn(generator, sample,
                                           hyperparameters=hp, mesh=mesh)
        if nudge and torch.distributed.get_rank() == 1:
            model.encoder.type_embed.weight.register_hook(lambda g: g + 1e-3)
        return model

    hist = []
    model, result = train_loop(
        loss_fn=loss_fn,
        init_params_fn=init,
        optimizer=lambda p: torch.optim.SGD(p, lr=0.1),
        train_iter=iter(batches),
        config=TrainLoopConfig(train_steps=steps, batch_size=len(batches[0]["label"]),
                               log_every=1, window_steps=1),
        mesh=mesh, device="cpu",
        metrics_cb=lambda s, m: hist.append((s, m["loss"], m["moe_aux"])))
    return {"params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "hist": hist}


def bert_seq_train(hp, batches, impl, steps=3):
    """A BERT classifier in f32 compute (its dtype attributes set to f32,
    so the two sides' sums differ only in order) through ``train_loop``
    with SGD 0.1 on a mesh of ``seq`` = the world, its token features
    split over ``seq`` (``long_context_batch_partition``) and ``impl``
    attention; one process (no group) runs it whole.  The train batches
    are its eval batches too.  Returns the parameters, the (step, loss)
    series, the eval metrics and the mesh's ``seq_split`` after the
    loop."""
    import torch.nn.functional as F

    from tpu_pipelines_torch.examples import bert_module
    from tpu_pipelines_torch.parallel.mesh import make_mesh
    from tpu_pipelines_torch.parallel.ring_attention import (
        long_context_batch_partition,
    )
    from tpu_pipelines_torch.trainer import TrainLoopConfig, train_loop

    world = (torch.distributed.get_world_size()
             if torch.distributed.is_initialized() else 1)
    mesh = make_mesh({"data": 1, "seq": world}, device="cpu")

    def init(generator, sample):
        model = bert_module.init_params_fn(
            generator, sample, hyperparameters={**hp, "attn_impl": impl}, mesh=mesh)
        for module in model.modules():
            if isinstance(getattr(module, "dtype", None), torch.dtype):
                module.dtype = torch.float32
        return model

    def loss_fn(model, batch, generator):
        features = {k: v for k, v in batch.items() if k != "label"}
        logits = model(features, generator=generator)
        return F.cross_entropy(logits.float(), batch["label"].long()), {}

    hist = []
    model, result = train_loop(
        loss_fn=loss_fn, init_params_fn=init, eval_iter_fn=lambda: iter(batches),
        optimizer=lambda p: torch.optim.SGD(p, lr=0.1), train_iter=iter(batches),
        config=TrainLoopConfig(
            train_steps=steps, batch_size=len(batches[0]["label"]), log_every=1,
            window_steps=1,
            batch_partition=long_context_batch_partition(batches[0], mesh)),
        mesh=mesh, device="cpu",
        metrics_cb=lambda s, m: hist.append((s, m["loss"])))
    return {"params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "hist": hist, "seq_split": mesh.seq_split,
            "eval": {k: v for k, v in result.final_metrics.items()
                     if k.startswith("eval_")}}
