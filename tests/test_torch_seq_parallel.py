"""Sequence parallelism through the model and the train loop (ROADMAP.md
A6a) on the CPU over gloo (tests/torch_sp_worker.py, one CPU thread a
rank), against the reference on its virtual 8-device CPU mesh and against
one process.

  - BERT with "ring" (and "ulysses") on data=2 x seq=2 against the
    reference's ring BERT (tests/test_models_text.py): each rank its rows'
    logits, its tokens its block of the sequence (``batch_partition``
    layout) or whole rows (the Trainer-module layout); bf16 compute on
    both sides, 2e-2 (the reference test's tolerance for bf16 blocks);
  - ``train_loop`` with ``batch_partition`` over seq=2 (the reference's
    ring window test, tests/test_fsdp_window.py): losses and parameters
    after 4 Adam steps equal one process's dense run and the reference's
    ring run at rtol 1e-4, atol 1e-5 (the reference test's);
  - BERT in f32 compute through ``train_loop`` with its tokens split over
    seq=2 (ring, Ulysses): losses and parameters after 3 SGD steps equal
    one process's at TRAIN_TOL;
  - ``bert_module.run_fn`` on a ``seq`` mesh with no ``batch_partition``:
    both ranks report the same losses, within 2e-2 of one process's
    dense run (bf16 compute, the ring's f32 block products against dense
    attention's bf16 ones);
  - ``choose_attn_impl``'s ring gate against the reference's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_dp_worker as w
import torch_sp_worker as sp
from tpu_pipelines.models import bert as ref_bert
from tpu_pipelines.models import transformer as ref_tf
from tpu_pipelines.parallel import ring_attention as ref_ring
from tpu_pipelines.trainer import TrainLoopConfig as RefConfig
from tpu_pipelines.trainer import train_loop as ref_train_loop
from tpu_pipelines_torch.models import transformer as port_tf
from tpu_pipelines_torch.models.convert import bert_state_dict_from_flax
from tpu_pipelines_torch.parallel.mesh import DeviceMesh

TINY = {"vocab_size": 64, "d_model": 64, "n_layers": 2, "n_heads": 4,
        "d_ff": 128, "max_len": 32, "dropout_rate": 0.0, "num_classes": 3}
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)
RUN_FN_HP = {**TINY, "num_classes": 2, "learning_rate": 1e-3, "batch_size": 8,
             "attn_impl": "ring"}


def _bert_batch(b=4, l=16, seed=0):
    rng = np.random.default_rng(seed)
    lengths = [16, 10, 5, 12][:b]
    ids = np.zeros((b, l), np.int32)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(1, TINY["vocab_size"], size=n)
    return {"input_ids": ids, "attention_mask": (ids > 0).astype(np.int32)}


BERT_TRAIN_HP = {**TINY, "num_classes": 2, "max_len": 32}


def _bert_train_batches(n=3, b=4, l=32):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        lengths = rng.integers(4, l + 1, size=b)
        mask = np.arange(l)[None, :] < lengths[:, None]
        ids = np.where(mask, rng.integers(4, TINY["vocab_size"], size=(b, l)), 0)
        out.append({"input_ids": ids.astype(np.int32),
                    "attention_mask": mask.astype(np.int32),
                    "label": (ids[:, 0] % 2).astype(np.int32)})
    return out


def _ref_mesh(data, seq):
    devs = np.array(jax.devices()[:data * seq]).reshape(data, 1, seq, 1, 1)
    return Mesh(devs, ("data", "model", "seq", "expert", "pipe"))


def _run_fn_setup(root):
    """A two-shard examples artifact and a base model of the port's init."""
    from tpu_pipelines_torch.data import examples_io
    from tpu_pipelines_torch.examples import bert_module
    from tpu_pipelines_torch.trainer.export import export_model

    rng = np.random.default_rng(3)
    rows = 32
    lengths = rng.integers(4, 17, size=rows)
    mask = np.arange(16)[None, :] < lengths[:, None]
    ids = np.where(mask, rng.integers(4, 64, size=mask.shape), 0)
    data = {"input_ids": ids.astype(np.int32), "attention_mask": mask.astype(np.int32),
            "label": (ids[:, 1] % 2).astype(np.int32)}
    examples = os.path.join(root, "examples")
    for split in ("train", "eval"):
        examples_io.write_split(examples, split, examples_io.table_from_columns(data),
                                num_shards=2)
    model = bert_module.init_params_fn(torch.Generator().manual_seed(0), None,
                                       hyperparameters=RUN_FN_HP)
    base = os.path.join(root, "base_model")
    export_model(serving_model_dir=base, params=model.state_dict(),
                 module_file=bert_module.__file__, hyperparameters=RUN_FN_HP)
    return examples, base


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("seq"))
    batch = _bert_batch()
    params = jax.tree.map(np.asarray, ref_bert.build_bert_model(TINY).init(
        jax.random.key(0), batch)["params"])
    state = bert_state_dict_from_flax(params)
    examples, base = _run_fn_setup(root)
    four = w.spawn(4, [
        (f"{impl}_{layout}", "torch_sp_worker:bert_logits",
         {"hp": {**TINY, "attn_impl": impl, "_whole_rows": layout == "whole"},
          "state": state, "batch": batch, "n_data": 2})
        for impl in ("ring", "ulysses") for layout in ("split", "whole")
    ], os.path.join(root, "w4"))
    two = w.spawn(2, [
        ("ring", "torch_sp_worker:seq_train", {"impl": "ring"}),
        ("ulysses", "torch_sp_worker:seq_train", {"impl": "ulysses"}),
        ("ring_whole", "torch_sp_worker:seq_train", {"impl": "ring", "split": False}),
        *[(f"bert_{impl}", "torch_sp_worker:bert_seq_train",
           {"hp": BERT_TRAIN_HP, "batches": _bert_train_batches(), "impl": impl})
          for impl in ("ring", "ulysses")],
        ("run_fn", "torch_sp_worker:bert_run_fn",
         {"examples": examples, "base_model": base, "out_dir": os.path.join(root, "r2"),
          "hp": RUN_FN_HP, "steps": 2, "mesh_config": {"data": 1, "seq": 2}}),
    ], os.path.join(root, "w2"))
    return {"root": root, "batch": batch, "params": params, 4: four, 2: two,
            "examples": examples, "base": base}


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("layout", ["split", "whole"])
def test_bert_sequence_parallel_matches_the_reference(ranks, impl, layout):
    """Rank (d, s) of data=2 x seq=2 holds data rows d's logits; both seq
    ranks hold the same; together they are the reference's ring BERT's."""
    mesh = _ref_mesh(2, 2)
    model = ref_bert.build_bert_model({**TINY, "attn_impl": "ring"}, mesh=mesh)
    batch = ranks["batch"]
    sharded = {k: jax.device_put(v, NamedSharding(mesh, P("data", "seq")))
               for k, v in batch.items()}
    want = np.asarray(jax.jit(lambda p, b: model.apply({"params": p}, b))(
        ranks["params"], sharded))
    got = [r[f"{impl}_{layout}"] for r in ranks[4]]
    assert torch.equal(got[0], got[1]) and torch.equal(got[2], got[3])
    np.testing.assert_allclose(torch.cat([got[0], got[2]]).float().numpy(), want,
                               **BF16_TOL)


def _reference_ring_train():
    mesh = _ref_mesh(1, 2)
    h, dh = 2, 4

    def init_fn(rng, b):
        m = sp._attention_model(h, dh)
        return {"qkv": jnp.asarray(m.qkv.detach().numpy()),
                "out": jnp.asarray(m.out.detach().numpy())}

    def loss_fn(params, b, rng):
        qkv = b["x"] @ params["qkv"]
        q, k, v = [t.reshape(*t.shape[:2], h, dh) for t in jnp.split(qkv, 3, axis=-1)]
        o = ref_ring.ring_attention(q, k, v, mesh=mesh, causal=True)
        pred = o.reshape(*q.shape[:2], h * dh) @ params["out"]
        return jnp.mean((pred - b["y"]) ** 2), {}

    data = sp.attention_batches(4)
    hist = []
    params, _ = ref_train_loop(
        loss_fn=loss_fn, init_params_fn=init_fn, optimizer=optax.adam(0.05),
        train_iter=iter(data),
        config=RefConfig(train_steps=4, batch_size=4, log_every=1, window_steps=2,
                         prng_impl=None,
                         batch_partition=ref_ring.long_context_batch_partition(
                             data[0], mesh)),
        mesh=mesh, metrics_cb=lambda s, m: hist.append((s, float(m["loss"]))))
    return {k: np.asarray(v) for k, v in params.items()}, hist


@pytest.mark.parametrize("name", ["ring", "ulysses", "ring_whole"])
def test_train_loop_with_batch_partition_matches_one_process(ranks, name):
    """``train_loop`` on seq=2 (each rank its block of x and y through
    ``long_context_batch_partition``, or whole rows for ring_whole): both
    ranks report one process's losses and hold its parameters, and the
    reference's ring run's."""
    one = sp.seq_train("dense", split=False)
    want_params, want_hist = _reference_ring_train()
    got = [r[name] for r in ranks[2]]
    if name != "ring_whole":
        assert got[0]["batch_partition"] == {"x": ("data", "seq"), "y": ("data", "seq")}
    for g in got:
        assert g["steps_completed"] == 4
        assert [s for s, _ in g["hist"]] == [1, 2, 3, 4]
        np.testing.assert_allclose([l for _, l in g["hist"]],
                                   [l for _, l in one["hist"]], **TRAIN_TOL)
        np.testing.assert_allclose([l for _, l in g["hist"]],
                                   [l for _, l in want_hist], **TRAIN_TOL)
        for n, p in one["params"].items():
            np.testing.assert_allclose(g["params"][n].numpy(), p.numpy(), **TRAIN_TOL)
            np.testing.assert_allclose(g["params"][n].numpy(), want_params[n],
                                       **TRAIN_TOL)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_bert_training_on_a_split_sequence_matches_one_process(ranks, impl):
    """BERT (f32 compute) through ``train_loop`` with its token features
    split over seq = 2: every rank's positions offset, the [CLS] row
    broadcast from the first rank (its backward bringing the gradient
    home), the gradients averaged over seq; three SGD steps equal one
    process's at TRAIN_TOL, and so does the eval loss (each rank its block
    of the eval batches, the mean over seq).  The returned model's mesh
    holds whole rows again."""
    one = sp.bert_seq_train(BERT_TRAIN_HP, _bert_train_batches(), "dense")
    assert sorted(one["eval"]) == ["eval_loss"]
    for rank in ranks[2]:
        got = rank[f"bert_{impl}"]
        assert got["seq_split"] is False
        np.testing.assert_allclose(got["eval"]["eval_loss"], one["eval"]["eval_loss"],
                                   **TRAIN_TOL)
        np.testing.assert_allclose([l for _, l in got["hist"]],
                                   [l for _, l in one["hist"]], **TRAIN_TOL)
        for n, p in one["params"].items():
            np.testing.assert_allclose(got["params"][n].numpy(), p.numpy(),
                                       **TRAIN_TOL, err_msg=n)


def test_bert_run_fn_on_a_seq_mesh_without_batch_partition(ranks, tmp_path):
    """The BERT module on ``mesh_config {"data": 1, "seq": 2}`` with ring
    attention and no ``batch_partition`` (the reference module's layout:
    every rank whole rows, the ring on the rank's block): both ranks report
    the same losses, and one process's dense run's within 2e-2."""
    got = [r["run_fn"] for r in ranks[2]]
    assert got[0]["losses"] == got[1]["losses"]
    assert [s for s, _ in got[0]["losses"]] == [1, 2]
    one = sp.bert_run_fn(ranks["examples"], ranks["base"], str(tmp_path),
                         {**RUN_FN_HP, "attn_impl": "dense"}, 2, None)
    np.testing.assert_allclose([l for _, l in got[0]["losses"]],
                               [l for _, l in one["losses"]], rtol=0, atol=2e-2)


def _seq_mesh(n):
    return DeviceMesh(None, 0, {"data": 1, "model": 1, "seq": n, "expert": 1,
                                "pipe": 1}, torch.device("cpu"))


def test_attn_auto_routes_ring_on_seq_mesh(monkeypatch):
    """``choose_attn_impl``'s step 0, as the reference's: a seq axis above
    1 routes long self-attention to ring; short sequences, cross-attention
    and meshes without a seq axis keep the measured rule; the floor is
    TPP_RING_MIN_SEQ."""
    devs = np.array(jax.devices()[:8]).reshape(1, 1, 8, 1, 1)
    ref_mesh = Mesh(devs, ("data", "model", "seq", "expert", "pipe"))
    cases = [(port_tf.RING_MIN_SEQ, port_tf.RING_MIN_SEQ, True),
             (128, 128, True), (4096, 1024, True), (4096, 4096, False)]
    assert port_tf.RING_MIN_SEQ == ref_tf.RING_MIN_SEQ
    for lq, lk, seq in cases:
        got = port_tf.choose_attn_impl(8, 12, lq, lk, mesh=_seq_mesh(8 if seq else 1))
        want = ref_tf.choose_attn_impl(8, 12, lq, lk, mesh=ref_mesh if seq else None)
        assert (got == "ring") == (want == "ring"), (lq, lk, seq)
    monkeypatch.setenv("TPP_RING_MIN_SEQ", "64")
    assert port_tf.choose_attn_impl(8, 12, 128, 128, mesh=_seq_mesh(8)) == "ring"
    assert ref_tf.choose_attn_impl(8, 12, 128, 128, mesh=ref_mesh) == "ring"
