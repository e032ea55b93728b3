"""The ranks of the tensor- and pipeline-parallel tests
(tests/test_torch_tensor_parallel.py, tests/test_torch_pipeline_parallel.py),
spawned by ``torch_dp_worker.spawn`` with kinds "torch_tp_worker:<function>":
gloo over a file store, one CPU thread a rank.  Every rank builds its mesh
over the whole group, takes its part of the global inputs the parent
made, and returns its part of the result; the parent puts the parts
together.  This module imports no JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F


def _world():
    return torch.distributed.get_world_size()


def _rows(x, mesh):
    """This rank's contiguous rows of a global array (its ``data`` block)."""
    x = torch.as_tensor(x)
    k = x.shape[0] // mesh.size
    return x[mesh.rank * k:(mesh.rank + 1) * k]


# ---- GPipe


def mlp_stage(params, x):
    """The reference test's residual MLP stage."""
    return x + torch.tanh(x @ params["w"]) @ params["v"]


def stacked_params(s, d, seed=0):
    """The reference test's ``_stacked_params``: [S, d, d] normals x 0.3."""
    rng = np.random.default_rng(seed)
    return {
        "w": (rng.normal(size=(s, d, d)) * 0.3).astype(np.float32),
        "v": (rng.normal(size=(s, d, d)) * 0.3).astype(np.float32),
    }


def transformer_stage_block():
    """The reference test's stage: a TransformerBlock of 2 heads x 8, d_ff
    32, dropout 0, f32, dense attention (d_model 16)."""
    from tpu_pipelines_torch.models.transformer import TransformerBlock

    return TransformerBlock(16, 2, 8, 32, dropout_rate=0.0, dtype=torch.float32,
                            attn_impl="dense")


def gpipe_cases(cases):
    """``gpipe`` over a mesh of ``pipe`` = S and ``data`` = world / S for each
    case ``{"kind": "forward"|"grad"|"transformer", "stages", "micro",
    "x", "params"}`` (params stacked [S, ...]; the rank keeps its stage):
    this rank's rows of the output, and for "grad" the gradient of the sum
    of its rows' output with respect to its stage's parameters."""
    from tpu_pipelines_torch.parallel.mesh import make_mesh
    from tpu_pipelines_torch.parallel.pipeline_parallel import gpipe

    out = []
    for case in cases:
        s = case["stages"]
        mesh = make_mesh({"data": _world() // s, "pipe": s}, device="cpu")
        p = mesh.axis_rank("pipe")
        params = {n: torch.as_tensor(t)[p:p + 1].clone().requires_grad_()
                  for n, t in case["params"].items()}
        if case["kind"] == "transformer":
            block = transformer_stage_block()

            def stage_fn(prm, a, block=block):
                return torch.func.functional_call(block, prm, (a,))
        else:
            stage_fn = mlp_stage
        y = gpipe(stage_fn, params, _rows(case["x"], mesh), mesh=mesh,
                  num_microbatches=case["micro"])
        res = {"out": y.detach(), "pipe": p, "data": mesh.rank}
        if case["kind"] == "grad":
            y.sum().backward()
            res["grads"] = {n: t.grad[0].clone() for n, t in params.items()}
        out.append(res)
    return out


# ---- the staged classifier


def staged_pipe(hp, state, tokens, labels):
    """The staged classifier of ``state`` (its whole stacked state dict) on
    data = world / 2 x pipe = 2: this rank's rows' logits, the gradients
    of its rows' mean cross-entropy (its own stage's, and embed's and
    head's before any exchange of the train loop), the stage shapes it
    holds and its mesh coordinates."""
    from tpu_pipelines_torch.models.staged import build_staged_model
    from tpu_pipelines_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"data": _world() // 2, "pipe": 2}, device="cpu")
    model = build_staged_model({**hp, "n_stages": 2}, mesh=mesh)
    model.load_state_dict(state)
    logits = model(_rows(tokens, mesh))
    F.cross_entropy(logits, _rows(labels, mesh).long()).backward()
    return {"logits": logits.detach(), "pipe": mesh.axis_rank("pipe"),
            "data": mesh.rank,
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "shapes": {n: tuple(p.shape) for n, p in model.named_parameters()}}


def staged_component(npz, out_dir, mesh, steps, batch, hp):
    """The staged module through the Trainer component: ImportExampleGen
    and Trainer (``mesh``, hyperparameters ``hp``) in a pipeline of this
    rank's own, the
    Trainer's execution properties, and on rank 0 the exported payload's
    predictions for ``batch`` (loaded with no mesh) and the leading dims
    of its stages."""
    from tpu_pipelines_torch.components import ImportExampleGen, Trainer
    from tpu_pipelines_torch.dsl.pipeline import Pipeline
    from tpu_pipelines_torch.metadata import MetadataStore
    from tpu_pipelines_torch.orchestration import LocalDagRunner
    from tpu_pipelines_torch.trainer.export import load_exported_model

    import tpu_pipelines_torch.examples.staged_module as staged_module

    rank = torch.distributed.get_rank()
    root = os.path.join(out_dir, f"rank{rank}")
    gen = ImportExampleGen(input_path=npz)
    trainer = Trainer(examples=gen.outputs["examples"],
                      module_file=staged_module.__file__, train_steps=steps,
                      hyperparameters=hp, mesh=mesh)
    result = LocalDagRunner(device="cpu").run(Pipeline(
        "staged-pp-test", [gen, trainer], pipeline_root=os.path.join(root, "root"),
        metadata_path=os.path.join(root, "md.sqlite"), enable_cache=False))
    if not result.succeeded:
        raise AssertionError(result.nodes["Trainer"].error)
    store = MetadataStore(os.path.join(root, "md.sqlite"))
    props = dict(store.get_execution(result.nodes["Trainer"].execution_id).properties)
    store.close()
    out = {"props": props}
    if rank == 0:
        loaded = load_exported_model(result.outputs_of("Trainer", "model")[0].uri,
                                     device="cpu")
        out["logits"] = loaded.predict(batch)
        out["lead"] = sorted({tuple(v.shape)[0] for k, v in loaded.params.items()
                              if k.startswith("stages.")})
        out["hp"] = loaded.spec["hyperparameters"]
    return out


# ---- BERT over model


def _f32(model):
    for module in model.modules():
        if isinstance(getattr(module, "dtype", None), torch.dtype):
            module.dtype = torch.float32
    return model


def bert_tp_logits(hp, state, batch, mesh_config, f32=True):
    """BERT (``hp``; f32 compute with ``f32``) built on ``mesh_config``
    with the whole ``state`` loaded into the rank's slices: this rank's
    rows' eval-mode output (its ``seq`` block of rows when the mesh has a
    ``seq`` axis: the Trainer-module layout, whole rows a rank), the
    shapes of the slices it holds and the parameters as loaded."""
    from tpu_pipelines_torch.models.bert import build_bert_model
    from tpu_pipelines_torch.parallel.mesh import make_mesh

    mesh = make_mesh(mesh_config, device="cpu")
    model = build_bert_model(hp, mesh=mesh)
    model.load_state_dict(state)
    loaded = {n: p.detach().clone() for n, p in model.named_parameters()}
    if f32:
        _f32(model)
    with torch.no_grad():
        out = model.eval()({k: _rows(v, mesh) for k, v in batch.items()})
    return {"out": out, "data": mesh.rank, "model": mesh.axis_rank("model"),
            "shapes": {n: tuple(p.shape) for n, p in model.named_parameters()},
            "loaded": loaded}


def bert_tp_train(hp, state, batches, steps, lr, opt="adam", head="classifier",
                  model_axis=2):
    """BERT in f32 compute from ``state`` through ``train_loop`` on data =
    world / ``model_axis`` x model = ``model_axis`` (one process: no mesh)
    with ``bert_partition_rules`` and Adam (or SGD) at ``lr``; the MLM
    head takes a cross-entropy over the vocabulary against ``labels``.
    Returns the whole parameters, the (step, loss) series, this rank's
    query-weight slice of layer 0 and its Adam moments, and the
    replicated parameters as this rank holds them."""
    from tpu_pipelines_torch.models.bert import build_bert_model
    from tpu_pipelines_torch.parallel.mesh import make_mesh
    from tpu_pipelines_torch.parallel.partition import (
        bert_partition_rules,
        held_slices,
        make_param_partition,
    )
    from tpu_pipelines_torch.trainer import TrainLoopConfig, train_loop

    grouped = torch.distributed.is_initialized()
    mesh = (make_mesh({"data": _world() // model_axis, "model": model_axis},
                      device="cpu") if grouped else None)
    hp = {**hp, "head": head}
    with torch.device("meta"):
        partition = make_param_partition(build_bert_model(hp), bert_partition_rules())
    seen = {}

    def init(generator, sample):
        model = build_bert_model(hp, mesh=mesh)
        model.load_state_dict(state)
        seen["model"] = model
        return _f32(model)

    def loss_fn(model, batch, generator):
        features = {k: v for k, v in batch.items() if k != "label"}
        logits = model(features, generator=generator)
        if head == "mlm":
            return F.cross_entropy(logits.float().flatten(0, 1),
                                   batch["label"].long().flatten()), {}
        return F.cross_entropy(logits.float(), batch["label"].long()), {}

    def optimizer(params):
        if opt == "sgd":
            return torch.optim.SGD(params, lr=lr)
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)

    hist, moments = [], {}
    name = "encoder.layers.0.attn.query.weight"
    real_unshard = None
    if grouped:
        from tpu_pipelines_torch.trainer import data_parallel

        real_unshard = data_parallel.DataParallel.unshard

        def unshard(self, model):
            # The rank's slice and its moments, before the loop gathers.
            p = dict(model.named_parameters())[name]
            moments["slice"] = p.detach().clone()
            moments["state"] = {k: v.detach().clone() for k, v in
                                self_opt[0].state[p].items() if torch.is_tensor(v)}
            moments["replicated"] = {n: q.detach().clone()
                                     for n, q in model.named_parameters()
                                     if not held_slices(model, n)}
            return real_unshard(self, model)

        data_parallel.DataParallel.unshard = unshard
    self_opt = []

    def make_opt(params):
        o = optimizer(params)
        self_opt.append(o)
        return o

    try:
        model, result = train_loop(
            loss_fn=loss_fn, init_params_fn=init, optimizer=make_opt,
            train_iter=iter(batches[:steps]),
            config=TrainLoopConfig(train_steps=steps,
                                   batch_size=len(batches[0]["label"]),
                                   log_every=1, window_steps=1,
                                   param_partition=partition if grouped else None),
            mesh=mesh, device="cpu",
            metrics_cb=lambda s, m: hist.append((s, m["loss"])))
    finally:
        if real_unshard is not None:
            data_parallel.DataParallel.unshard = real_unshard
    return {"params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "hist": hist, **moments,
            "coords": (mesh.rank, mesh.axis_rank("model")) if mesh else (0, 0)}


def bert_tp_dropout(hp, state, batches, steps):
    """BERT (f32 compute, dropout 0.1) through ``train_loop`` on data =
    world / 2 x model = 2 with ``bert_partition_rules`` and Adam: the
    (step, loss) series and every replicated parameter as this rank holds
    it after the last step, and the whole returned model."""
    return bert_tp_train({**hp, "dropout_rate": 0.1}, state, batches, steps,
                         lr=1e-3)


# ---- two ranks on one card (tests/test_torch_kernels_gpu.py)


def tp_card_step(layers=2, batch=4, length=128):
    """BERT-base width (12 x 64 heads, d_ff 3072, vocabulary 30,522) at
    ``layers`` layers on data = 1 x model = 2 over gloo on CUDA device 0,
    flash attention, bf16: one forward and backward of the summed logits.
    Returns the heads a rank's attention holds, its flash launches from
    zero, its logits, and on rank 0 one process's logits of the same
    weights."""
    from tpu_pipelines_torch.models.bert import build_bert_model, init_bert_weights
    from tpu_pipelines_torch.ops import flash_attention as fa
    from tpu_pipelines_torch.parallel.mesh import make_mesh

    torch.cuda.set_device(0)
    hp = {"vocab_size": 30522, "n_layers": layers, "max_len": length,
          "attn_impl": "flash", "dropout_rate": 0.0}
    mesh = make_mesh({"data": 1, "model": 2}, device="cuda")
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(1, 30522, size=(batch, length)),
                          device="cuda")
    feats = {"input_ids": ids, "attention_mask": torch.ones_like(ids)}
    model = init_bert_weights(build_bert_model(hp, mesh=mesh),
                              torch.Generator().manual_seed(0)).cuda()
    for name in fa.COUNTERS:
        setattr(fa, name, 0)
    logits = model(feats)
    logits.float().sum().backward()
    torch.cuda.synchronize()
    out = {"heads": model.encoder.layers[0].attn.n_heads,
           "launches": {name: getattr(fa, name) for name in fa.COUNTERS},
           "logits": logits.detach().float().cpu()}
    if torch.distributed.get_rank() == 0:
        whole = init_bert_weights(build_bert_model(hp),
                                  torch.Generator().manual_seed(0)).cuda()
        with torch.no_grad():
            out["one_process"] = whole(feats).float().cpu()
    return out
