"""The ranks of the T5 and MoE tensor- and sequence-parallel tests
(tests/test_torch_t5_parallel.py, tests/test_torch_moe_tensor_parallel.py),
spawned by ``torch_dp_worker.spawn`` with kinds
"torch_t5_moe_worker:<function>": gloo over a file store, one CPU thread
a rank.  Every rank builds its mesh over the whole group, takes its part
of the global inputs the parent made, and returns its part of the result.
Each function also runs in one process (no group), where it builds no
mesh: the one-process side of a port-against-port check.  This module
imports no JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F


def _grouped():
    return torch.distributed.is_initialized()


def _mesh(mesh_config):
    from tpu_pipelines_torch.parallel.mesh import make_mesh

    return make_mesh(mesh_config, device="cpu") if _grouped() else None


def _f32(model):
    for module in model.modules():
        if isinstance(getattr(module, "dtype", None), torch.dtype):
            module.dtype = torch.float32
    return model


def _rows(x, mesh):
    """This rank's contiguous rows of a global array (its ``data`` block)."""
    x = torch.as_tensor(x)
    if mesh is None:
        return x
    k = x.shape[0] // mesh.size
    return x[mesh.rank * k:(mesh.rank + 1) * k]


def _coords(mesh):
    if mesh is None:
        return {}
    return {"data": mesh.rank, **{a: mesh.axis_rank(a) for a in
                                  ("model", "seq", "expert")}}


# ---- the whole-shape dropout draw


def dropout_draw(shape, mesh_config, rate=0.5, seed=3):
    """Two draws in a row of a ``Dropout`` of ``rate`` over this rank's
    block of a ones tensor of ``shape`` [b, L, f] (its block of the
    sequence on a ``seq`` axis above 1, the mesh's ``seq_split`` set; its
    columns on a ``model`` axis above 1, the hidden site's split) from one
    generator; in one process the whole tensor."""
    from tpu_pipelines_torch.models.transformer import Dropout

    mesh = _mesh(mesh_config)
    x, columns = torch.ones(shape), None
    if mesh is not None:
        mesh.seq_split = True
        for dim, axis in ((1, "seq"), (2, "model")):
            n = mesh.axis_size(axis)
            k = shape[dim] // n
            x = x.narrow(dim, mesh.axis_rank(axis) * k, k)
        columns = (shape[-1], mesh.axis_group("model"))
    dropout = Dropout(rate, mesh, columns=columns).train()
    g = torch.Generator().manual_seed(seed)
    return {"draws": [dropout(x, g) for _ in range(2)], **_coords(mesh)}


# ---- T5


def _t5(hp, state, mesh):
    from tpu_pipelines_torch.models.t5 import build_t5_model

    model = build_t5_model(hp, mesh=mesh)
    model.load_state_dict(state)
    return _f32(model)


def t5_logits(hp, state, batch, mesh_config):
    """T5 (f32 compute) built on ``mesh_config`` with the whole ``state``
    loaded into the rank's slices: its rows' teacher-forced eval-mode
    logits, the shapes of the slices it holds, and the parameters as
    loaded."""
    mesh = _mesh(mesh_config)
    model = _t5(hp, state, mesh).eval()
    loaded = {n: p.detach().clone() for n, p in model.named_parameters()}
    with torch.no_grad():
        out = model({k: _rows(v, mesh) for k, v in batch.items()})
    return {"out": out, **_coords(mesh), "loaded": loaded,
            "shapes": {n: tuple(p.shape) for n, p in model.named_parameters()}}


def t5_init(hp, seed, mesh_config):
    """``init_t5_weights`` of a T5 built on ``mesh_config`` from a generator
    of ``seed``: the slices this rank holds."""
    from tpu_pipelines_torch.models.t5 import build_t5_model, init_t5_weights

    mesh = _mesh(mesh_config)
    model = init_t5_weights(build_t5_model(hp, mesh=mesh),
                            torch.Generator().manual_seed(seed))
    return {"state": {n: p.detach().clone() for n, p in model.named_parameters()},
            **_coords(mesh)}


def t5_generate(hp, state, inputs, mask, mesh_config, max_decode_len=6, beam=3):
    """Greedy and beam tokens of T5 (f32 compute) on ``mesh_config`` for
    the whole ``inputs`` on every rank, the first step's logits and the
    heads a rank's decode cache holds."""
    from tpu_pipelines_torch.models import t5

    mesh = _mesh(mesh_config)
    model = _t5(hp, state, mesh).eval()
    params = dict(model.state_dict())
    x, m = torch.as_tensor(inputs), torch.as_tensor(mask)
    with torch.no_grad():
        greedy, done = t5.make_greedy_generate(
            model, max_decode_len=max_decode_len, eos_id=1)(params, x, m)
        tokens, score = t5.make_beam_generate(
            model, beam_size=beam, max_decode_len=max_decode_len, eos_id=1)(
                params, x, m)
        cache, _, logits0 = t5.prefill_decode(model, params, x, m, max_decode_len)
    key = "decoder.layer_0.attn.cached_key"
    return {"greedy": greedy, "done": done, "beam": tokens, "score": score,
            "logits0": logits0, "cache_heads": int(cache[key].shape[2]),
            **_coords(mesh)}


def t5_split_parts(hp, state, batch, mesh_config):
    """T5 (f32 compute) on ``mesh_config`` with its token features split
    over ``seq`` (``long_context_batch_partition``, the mesh's
    ``seq_split``): this rank's block of the encoder's output, of the
    decoder's logits for the one-process decoder inputs ``batch["dec"]``
    (cross-attention over the whole encoder output), and of the
    teacher-forced logits (the right shift across blocks); in one process
    the whole of each."""
    from tpu_pipelines_torch.parallel.mesh import sequence_block
    from tpu_pipelines_torch.parallel.ring_attention import (
        long_context_batch_partition,
    )

    mesh = _mesh(mesh_config)
    model = _t5(hp, state, mesh).eval()
    local = {k: torch.as_tensor(v) for k, v in batch.items()}
    if mesh is not None:
        bp = long_context_batch_partition(local, mesh)
        local = sequence_block(local, mesh, bp)
        mesh.seq_split = True
    with torch.no_grad():
        enc = model.encode(local["inputs"], local["input_mask"])
        dec = model.decode(local["dec"], enc, enc_mask=local["input_mask"])
        logits = model({k: local[k] for k in ("inputs", "targets", "input_mask")})
    return {"encoded": enc, "decoded": dec, "logits": logits, **_coords(mesh)}


def t5_train(hp, state, batches, steps, lr, opt="adam", mesh_config=None,
             split_seq=False):
    """T5 (f32 compute) from ``state`` through ``train_loop`` with
    ``t5_module.loss_fn`` on ``mesh_config`` (one process: no mesh), with
    ``t5_partition_rules`` and, with ``split_seq``, its token features
    split over ``seq`` (``long_context_batch_partition``); Adam or SGD at
    ``lr``.  Returns the whole parameters, the (step, loss) series and the
    replicated parameters as this rank holds them."""
    from tpu_pipelines_torch.examples import t5_module
    from tpu_pipelines_torch.models.t5 import build_t5_model
    from tpu_pipelines_torch.parallel.partition import (
        held_slices,
        make_param_partition,
        t5_partition_rules,
    )
    from tpu_pipelines_torch.parallel.ring_attention import (
        long_context_batch_partition,
    )
    from tpu_pipelines_torch.trainer import TrainLoopConfig, train_loop
    from tpu_pipelines_torch.trainer import data_parallel

    mesh = _mesh(mesh_config)
    partition = bp = None
    if mesh is not None:
        with torch.device("meta"):
            partition = make_param_partition(build_t5_model(hp), t5_partition_rules())
        if split_seq:
            bp = long_context_batch_partition(batches[0], mesh)

    def optimizer(params):
        if opt == "sgd":
            return torch.optim.SGD(params, lr=lr)
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)

    replicated = {}
    real_unshard = data_parallel.DataParallel.unshard

    def unshard(self, model):
        replicated.update({n: q.detach().clone() for n, q in model.named_parameters()
                           if not held_slices(model, n)})
        return real_unshard(self, model)

    hist = []
    data_parallel.DataParallel.unshard = unshard
    try:
        model, _ = train_loop(
            loss_fn=t5_module.loss_fn,
            init_params_fn=lambda generator, sample: _t5(hp, state, mesh),
            optimizer=optimizer, train_iter=iter(batches[:steps]),
            config=TrainLoopConfig(train_steps=steps,
                                   batch_size=len(batches[0]["inputs"]),
                                   log_every=1, window_steps=1,
                                   param_partition=partition, batch_partition=bp),
            mesh=mesh, device="cpu",
            metrics_cb=lambda s, m: hist.append((s, m["loss"])))
    finally:
        data_parallel.DataParallel.unshard = real_unshard
    return {"params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "hist": hist, "replicated": replicated, **_coords(mesh)}


def t5_run_fn(examples, out_dir, hp, steps, mesh_config):
    """``t5_module.run_fn`` on ``mesh_config`` (one process: none): the
    (step, loss) series and the targets of every batch the loop read."""
    from tpu_pipelines_torch.examples import t5_module
    from tpu_pipelines_torch.trainer.fn_args import FnArgs

    losses, rows = [], []
    real = t5_module.train_loop

    def recording(**kwargs):
        def reading(it):
            for batch in it:
                rows.append(np.asarray(batch["targets"]).copy())
                yield batch

        kwargs["train_iter"] = reading(kwargs["train_iter"])
        kwargs["metrics_cb"] = lambda s, m: losses.append((s, m["loss"]))
        return real(**kwargs)

    rank = torch.distributed.get_rank() if _grouped() else 0
    t5_module.train_loop = recording
    try:
        t5_module.run_fn(FnArgs(
            train_examples_uri=examples, eval_examples_uri=examples,
            serving_model_dir=os.path.join(out_dir, f"model{rank}"),
            model_run_dir=os.path.join(out_dir, f"run{rank}"), train_steps=steps,
            hyperparameters=hp, mesh_config=mesh_config or {}, device="cpu"))
    finally:
        t5_module.train_loop = real
    return {"losses": losses, "rows": rows[:steps]}


# ---- the MoE experts over model (and expert)


def moe_block(state, x, capacity_factor, mesh_config):
    """An MoE block (f32) of ``state``'s experts on ``mesh_config``: its
    output on ``x`` (every rank the whole batch), the aux loss, and the
    gradients of ``sum(out)`` for ``x``, the router and the rank's slice
    of the experts, with the slice's place."""
    from tpu_pipelines_torch.models.transformer import MoEMlpBlock

    mesh = _mesh(mesh_config)
    e, d, ff = state["wi"].shape
    block = MoEMlpBlock(d, e, ff, capacity_factor=capacity_factor,
                        dtype=torch.float32, mesh=mesh)
    block.load_state_dict(state)
    xs = torch.as_tensor(x).clone().requires_grad_()
    losses = []
    out = block(xs, losses=losses)
    out.sum().backward()
    return {"out": out.detach(), "aux": losses[0].detach(), "dx": xs.grad,
            "grads": {n: p.grad for n, p in block.named_parameters()},
            "wi_shape": tuple(block.wi.shape), **_coords(mesh)}


def bert_moe_train(hp, state, batches, steps, lr, mesh_config=None, opt="sgd",
                   aux_weight=0.01):
    """A BERT-MoE classifier (f32 compute) from ``state`` through
    ``train_loop`` with ``bert_partition_rules`` on ``mesh_config`` (one
    process: no mesh), loss task + ``aux_weight`` x aux, SGD or Adam at
    ``lr``: the
    whole parameters, the (step, loss, moe_aux) series and the shape of
    layer 1's ``wi`` slice while training."""
    from tpu_pipelines_torch.models.bert import build_bert_model
    from tpu_pipelines_torch.models.transformer import apply_with_moe_aux
    from tpu_pipelines_torch.parallel.partition import (
        bert_partition_rules,
        make_param_partition,
    )
    from tpu_pipelines_torch.trainer import TrainLoopConfig, train_loop

    mesh = _mesh(mesh_config)
    partition = None
    if mesh is not None:
        with torch.device("meta"):
            partition = make_param_partition(build_bert_model(hp),
                                             bert_partition_rules())
    held = {}

    def init(generator, sample):
        model = build_bert_model(hp, mesh=mesh)
        model.load_state_dict(state)
        held["wi"] = tuple(model.encoder.layers[1].moe.wi.shape)
        return _f32(model)

    def loss_fn(model, batch, generator):
        features = {k: v for k, v in batch.items() if k != "label"}
        logits, aux = apply_with_moe_aux(model, features, generator=generator)
        task = F.cross_entropy(logits.float(), batch["label"].long())
        return task + aux_weight * aux, {"moe_aux": aux}

    def optimizer(params):
        if opt == "sgd":
            return torch.optim.SGD(params, lr=lr)
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)

    hist = []
    model, _ = train_loop(
        loss_fn=loss_fn, init_params_fn=init, optimizer=optimizer,
        train_iter=iter(batches[:steps]),
        config=TrainLoopConfig(train_steps=steps, batch_size=len(batches[0]["label"]),
                               log_every=1, window_steps=1,
                               param_partition=partition),
        mesh=mesh, device="cpu",
        metrics_cb=lambda s, m: hist.append((s, m["loss"], m["moe_aux"])))
    return {"params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "hist": hist, "wi": held["wi"], **_coords(mesh)}
