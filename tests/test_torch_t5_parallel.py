"""T5 on the mesh's other axes (ROADMAP.md A6c) on the CPU over gloo
(tests/torch_t5_moe_worker.py, two ranks, one CPU thread a rank), against
the reference on its virtual 8-device CPU mesh and against one process.

Tiny T5: 2 + 2 layers, 4 heads of 16 (d_model 64), d_ff 128, vocabulary
64, f32 compute on both sides.  Tolerances:

  - against the reference (``TOL``, rtol 1e-4, atol 1e-5): two libraries'
    f32 sums in other orders, and a rank's partial products summed over
    ``model`` in another order than one GEMM.  The teacher-forced logits
    on data = 1 x model = 2 (the reference T5 built on its mesh); four
    Adam steps through ``train_loop`` with ``t5_partition_rules`` (the
    losses, and every parameter but the attention key biases: the softmax
    cancels their gradient, which is rounding alone in both packages, and
    Adam turns rounding into steps of up to its lr, as in
    tests/test_torch_tensor_parallel.py); three SGD steps of T5 on seq = 2
    with ``long_context_batch_partition`` (its losses, and its parameters,
    whose change is lr times the summed gradients);
  - greedy and beam tokens over model = 2 (flash-decode on a rank's 2
    heads with its rows of the bias): equal to the reference's tokens;
  - port against port (``ONE``, rtol 1e-5, atol 1e-6): the split
    sequence's encoder output, cross-attention and shifted teacher-forced
    logits, its loss and SGD steps with blocks of unequal target counts
    (and on data = 2 with rows of unequal counts, also held to the
    reference's data = 2 run at ``TOL``),
    two ranks at dropout 0.1 on ``model`` and on a split ``seq`` (and the
    draw itself, bit for bit: a rank's block of one process's mask), T5
    replicated on ``seq``, ``expert`` and ``pipe`` without a split, and
    the shared embedding's two uses through SGD: f32 sums in another order
    only;
  - ``t5_module.run_fn`` on model = 2: both ranks read the same rows, and
    their losses equal one process's at the same batch to 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import torch_dp_worker as w
import torch_t5_moe_worker as tw
from tpu_pipelines.models import t5 as jt5
from tpu_pipelines.parallel import partition as ref_part
from tpu_pipelines.parallel.ring_attention import (
    long_context_batch_partition as ref_long_context_batch_partition,
)
from tpu_pipelines.trainer import TrainLoopConfig as RefConfig
from tpu_pipelines.trainer import train_loop as ref_train_loop
from tpu_pipelines_torch.models.convert import t5_state_dict_from_flax
from tpu_pipelines_torch.models.t5 import build_t5_model
from tpu_pipelines_torch.parallel import partition as port_part
from tpu_pipelines_torch.parallel.mesh import DeviceMesh

TINY = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4, head_dim=16,
            d_ff=128, dropout_rate=0.0)
TOL = dict(rtol=1e-4, atol=1e-5)
ONE = dict(rtol=1e-5, atol=1e-6)
STEPS = 4
LR = 1e-4
SGD_LR = 0.5
L = 8                        # the decode budget of the generate checks
NON_IDENTIFIABLE = (".attn.key.bias", ".cross.key.bias")
DRAW_SHAPE = (2, 8, 12)
TP = {"data": 1, "model": 2}
SP = {"data": 1, "seq": 2}


def _batch(b=4, enc=8, tgt=8, seed=0):
    """inputs with padded tails, their mask, and targets whose second half
    holds fewer valid tokens than the first (the blocks' counts differ on
    a split sequence)."""
    rng = np.random.default_rng(seed)
    inputs = rng.integers(2, TINY["vocab_size"], size=(b, enc))
    inputs[-1, -3:] = 0
    targets = rng.integers(2, TINY["vocab_size"], size=(b, tgt))
    targets[0, -3:] = 0
    targets[1, -(tgt // 2 + 1):] = 0
    return {"inputs": inputs.astype(np.int32), "targets": targets.astype(np.int32),
            "input_mask": (inputs > 0).astype(np.int32)}


def _ref_mesh(data=1, model=1, seq=1):
    devs = np.array(jax.devices()[:data * model * seq]).reshape(data, model, seq, 1, 1)
    return Mesh(devs, ("data", "model", "seq", "expert", "pipe"))


def _ref_model(mesh=None, attn_impl="dense"):
    return jt5.T5(**TINY, dtype=jnp.float32, mesh=mesh, attn_impl=attn_impl)


def _ref_train(params, batches, mesh, optimizer, steps, rules=True, bp=False):
    """The reference's train_loop with the T5 trainer module's loss."""
    model = _ref_model(mesh)

    def loss_fn(p, b, rng):
        logits = model.apply({"params": p}, b)
        targets = jnp.asarray(b["targets"], jnp.int32)
        mask = jnp.asarray(b.get("target_mask", targets > 0), jnp.float32)
        per_tok = optax.softmax_cross_entropy_with_integer_labels(logits, targets)
        return (per_tok * mask).sum() / jnp.maximum(mask.sum(), 1.0), {}

    hist = []
    out, _ = ref_train_loop(
        loss_fn=loss_fn, init_params_fn=lambda rng, b: params,
        optimizer=optimizer, train_iter=iter(batches[:steps]),
        config=RefConfig(
            train_steps=steps, batch_size=len(batches[0]["inputs"]), log_every=1,
            window_steps=1, prng_impl=None,
            param_partition=(ref_part.make_param_partition(
                params, jt5.t5_partition_rules()) if rules else None),
            batch_partition=(ref_long_context_batch_partition(batches[0], mesh)
                             if bp else None)),
        mesh=mesh, metrics_cb=lambda s, m: hist.append((s, float(m["loss"]))))
    return t5_state_dict_from_flax(jax.tree.map(np.asarray, out)), hist


def _examples(root, rows=32, seed=5):
    """A two-shard examples artifact of T5 rows (train and eval alike)."""
    from tpu_pipelines_torch.data import examples_io

    data = {k: v for k, v in _batch(b=rows, seed=seed).items() if k != "input_mask"}
    uri = os.path.join(root, "examples")
    for split in ("train", "eval"):
        examples_io.write_split(uri, split, examples_io.table_from_columns(data),
                                num_shards=2)
    return uri


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("t5tp"))
    batch = _batch()
    params = jax.tree.map(np.asarray, _ref_model().init(jax.random.key(0), batch)["params"])
    state = t5_state_dict_from_flax(params)
    batches = [_batch(seed=s) for s in range(STEPS)]
    dec = np.pad(batch["targets"], ((0, 0), (1, 0)))[:, :-1]
    drop = {**TINY, "dropout_rate": 0.1}
    run_fn_hp = {**TINY, "batch_size": 8, "learning_rate": 1e-3}
    examples = _examples(root)
    sgd = {"steps": 3, "lr": SGD_LR, "opt": "sgd"}
    two = w.spawn(2, [
        ("logits", "torch_t5_moe_worker:t5_logits",
         {"hp": TINY, "state": state, "batch": batch, "mesh_config": TP}),
        ("init", "torch_t5_moe_worker:t5_init",
         {"hp": TINY, "seed": 7, "mesh_config": TP}),
        ("generate", "torch_t5_moe_worker:t5_generate",
         {"hp": {**TINY, "attn_impl": "flash"}, "state": state,
          "inputs": batch["inputs"], "mask": batch["input_mask"],
          "mesh_config": TP, "max_decode_len": L}),
        ("train", "torch_t5_moe_worker:t5_train",
         {"hp": TINY, "state": state, "batches": batches, "steps": STEPS,
          "lr": LR, "mesh_config": TP}),
        ("sgd", "torch_t5_moe_worker:t5_train",
         {"hp": TINY, "state": state, "batches": batches, "mesh_config": TP, **sgd}),
        ("parts", "torch_t5_moe_worker:t5_split_parts",
         {"hp": TINY, "state": state, "batch": {**batch, "dec": dec},
          "mesh_config": SP}),
        ("split", "torch_t5_moe_worker:t5_train",
         {"hp": TINY, "state": state, "batches": batches, "mesh_config": SP,
          "split_seq": True, **sgd}),
        ("data", "torch_t5_moe_worker:t5_train",
         {"hp": TINY, "state": state, "batches": batches, "mesh_config": {"data": 2},
          **sgd}),
        ("dropout_model", "torch_t5_moe_worker:t5_train",
         {"hp": drop, "state": state, "batches": batches, "mesh_config": TP, **sgd}),
        ("dropout_seq", "torch_t5_moe_worker:t5_train",
         {"hp": drop, "state": state, "batches": batches, "mesh_config": SP,
          "split_seq": True, **sgd}),
        *[(f"whole_{axis}", "torch_t5_moe_worker:t5_train",
           {"hp": drop, "state": state, "batches": batches,
            "mesh_config": {"data": 1, axis: 2}, **sgd})
          for axis in ("seq", "expert", "pipe")],
        *[(f"draw_{axis}", "torch_t5_moe_worker:dropout_draw",
           {"shape": DRAW_SHAPE, "mesh_config": {"data": 1, axis: 2}})
          for axis in ("model", "seq")],
        ("run_fn", "torch_t5_moe_worker:t5_run_fn",
         {"examples": examples, "out_dir": os.path.join(root, "run_fn"),
          "hp": run_fn_hp, "steps": 3, "mesh_config": TP}),
    ], os.path.join(root, "w2"))
    return {"batch": batch, "params": params, "state": state, "batches": batches,
            "dec": dec, "root": root, "run_fn_hp": run_fn_hp, "examples": examples,
            2: two}


def _sgd_one(ranks, hp=TINY):
    return tw.t5_train(hp, ranks["state"], ranks["batches"], 3, SGD_LR, "sgd")


def _assert_params(got, want, tol, skip=()):
    assert set(got) == set(want)
    for name, p in want.items():
        if name.endswith(skip):
            continue
        np.testing.assert_allclose(got[name].numpy(), p.numpy(), **tol, err_msg=name)


def test_t5_logits_on_model2_match_the_reference(ranks):
    """Both model ranks hold the reference's teacher-forced logits (the
    reference T5 built on its data = 1 x model = 2 mesh), each from its
    half of the heads, MLP columns, relative-position tables and shared
    vocabulary; a whole state dict loads into those halves."""
    want = np.asarray(_ref_model(_ref_mesh(1, 2)).apply({"params": ranks["params"]},
                                                        ranks["batch"]))
    got = [r["logits"] for r in ranks[2]]
    assert [g["model"] for g in got] == [0, 1]
    assert torch.equal(got[0]["out"], got[1]["out"])
    np.testing.assert_allclose(got[0]["out"].numpy(), want, **TOL)
    d, ff, h = TINY["d_model"], TINY["d_ff"], TINY["n_heads"]
    shapes = got[0]["shapes"]
    assert shapes["shared.weight"] == (TINY["vocab_size"] // 2, d)
    assert shapes["encoder.rel_pos.rel_embedding"] == (32, h // 2)
    assert shapes["decoder.layers.0.cross.query.weight"] == (d // 2, d)
    assert shapes["decoder.layers.0.cross.out.weight"] == (d, d // 2)
    assert shapes["encoder.layers.1.mlp.wi.weight"] == (ff // 2, d)
    assert shapes["encoder.final_norm.weight"] == (d,)
    for g in got:
        m = g["model"]
        for name, dim in (("shared.weight", 0), ("decoder.rel_pos.rel_embedding", 1),
                          ("encoder.layers.0.attn.out.weight", 1),
                          ("decoder.final_norm.weight", None)):
            want_p = ranks["state"][name]
            if dim is not None:
                k = want_p.shape[dim] // 2
                want_p = want_p.narrow(dim, m * k, k)
            assert torch.equal(g["loaded"][name], want_p), name


def test_init_on_model2_draws_one_process_weights(ranks):
    """``init_t5_weights`` on a model built over model = 2 draws every whole
    weight and keeps the rank's slice (a row-parallel kernel's fan-in is
    the whole layer's), so the ranks start from one process's weights."""
    from tpu_pipelines_torch.models.t5 import init_t5_weights
    from tpu_pipelines_torch.parallel.partition import held_slices

    whole = init_t5_weights(build_t5_model(TINY), torch.Generator().manual_seed(7))
    slices = 0
    for rank in ranks[2]:
        got, m = rank["init"]["state"], rank["init"]["model"]
        for name, p in whole.named_parameters():
            want = p.detach()
            if got[name].shape != want.shape:
                dim = next(d for d in range(want.dim())
                           if got[name].shape[d] != want.shape[d])
                k = got[name].shape[dim]
                want = want.narrow(dim, m * k, k)
                slices += 1
            assert torch.equal(got[name], want), name
    assert slices > 20
    assert held_slices(whole, "shared.weight") == {}


def test_train_loop_on_model2_matches_the_reference(ranks):
    """Four Adam steps through ``train_loop(param_partition=
    t5_partition_rules())`` on data = 1 x model = 2: every rank reports the
    reference's losses and returns its parameters (gathered whole)."""
    want, want_hist = _ref_train(ranks["params"], ranks["batches"], _ref_mesh(1, 2),
                                 optax.adam(LR), STEPS)
    for rank in ranks[2]:
        got = rank["train"]
        assert [s for s, _ in got["hist"]] == list(range(1, STEPS + 1))
        np.testing.assert_allclose([l for _, l in got["hist"]],
                                   [l for _, l in want_hist], **TOL)
        _assert_params(got["params"], want, TOL, NON_IDENTIFIABLE)


def test_shared_embedding_trains_through_both_uses_as_one_process(ranks):
    """SGD (Adam would hide a doubled gradient) at lr 0.5 through the
    vocabulary-parallel lookup and the tied logits: the shared table's
    gradient lands on each rank's own rows once, and the gathered
    parameters equal one process's."""
    one = _sgd_one(ranks)
    moved = (one["params"]["shared.weight"] - ranks["state"]["shared.weight"]).abs().max()
    assert moved > 1e-3
    for rank in ranks[2]:
        got = rank["sgd"]
        np.testing.assert_allclose([l for _, l in got["hist"]],
                                   [l for _, l in one["hist"]], **ONE)
        _assert_params(got["params"], one["params"], ONE)


def test_greedy_and_beam_over_model2_match_the_reference(ranks):
    """Greedy and beam decoding over model = 2, flash-decode on each rank's
    2 heads and its rows of the relative-position bias: every rank holds
    the full logits and makes the reference's choices (the reference's
    generate functions run its dense computation; they take no mesh)."""
    b = ranks["batch"]
    want, want_done = jt5.make_greedy_generate(_ref_model(), max_decode_len=L, eos_id=1)(
        ranks["params"], b["inputs"], b["input_mask"])
    want_beam, want_score = jt5.make_beam_generate(
        _ref_model(), beam_size=3, max_decode_len=L, eos_id=1)(
            ranks["params"], b["inputs"], b["input_mask"])
    for rank in ranks[2]:
        got = rank["generate"]
        assert got["cache_heads"] == TINY["n_heads"] // 2
        np.testing.assert_array_equal(got["greedy"].numpy(), np.asarray(want))
        np.testing.assert_array_equal(got["done"].numpy(), np.asarray(want_done))
        np.testing.assert_array_equal(got["beam"].numpy(), np.asarray(want_beam))
        np.testing.assert_allclose(got["score"].numpy(), np.asarray(want_score), **TOL)
    assert torch.equal(ranks[2][0]["generate"]["logits0"], ranks[2][1]["generate"]["logits0"])


@pytest.mark.parametrize("part", ["encoded", "decoded", "logits"])
def test_split_sequence_blocks_equal_one_process(ranks, part):
    """T5 on seq = 2 with its token features split: each rank's block of
    (a) the encoder's output (the bias built for the whole length), (b)
    the decoder's logits for one process's decoder inputs
    (cross-attention over the whole encoder output, gathered over seq)
    and (c) the teacher-forced logits (the right shift takes the previous
    rank's last target), concatenated, equal one process's."""
    one = tw.t5_split_parts(TINY, ranks["state"], {**ranks["batch"], "dec": ranks["dec"]},
                            None)
    got = torch.cat([r["parts"][part] for r in ranks[2]], dim=1)
    assert [r["parts"]["seq"] for r in ranks[2]] == [0, 1]
    np.testing.assert_allclose(got.numpy(), one[part].numpy(), **ONE)


def test_split_sequence_loss_is_the_whole_masked_mean(ranks):
    """(d) The blocks hold unequal target counts, so a mean of per-block
    masked means is not the masked mean; the split run's losses and
    parameters after three SGD steps equal one process's."""
    for b in ranks["batches"]:
        mask = b["targets"] > 0
        half = mask.shape[1] // 2
        assert mask[:, :half].sum() != mask[:, half:].sum()
    one = _sgd_one(ranks)
    for rank in ranks[2]:
        got = rank["split"]
        np.testing.assert_allclose([l for _, l in got["hist"]],
                                   [l for _, l in one["hist"]], **ONE)
        _assert_params(got["params"], one["params"], ONE)


def test_split_sequence_train_loop_matches_the_reference(ranks):
    """Three SGD steps of T5 on seq = 2 with ``long_context_batch_partition``
    over inputs and targets: the reference's losses and parameters (its
    gradients times lr) on its seq = 2 mesh."""
    want, want_hist = _ref_train(ranks["params"], ranks["batches"],
                                 _ref_mesh(1, 1, 2), optax.sgd(SGD_LR), 3,
                                 rules=False, bp=True)
    for rank in ranks[2]:
        got = rank["split"]
        np.testing.assert_allclose([l for _, l in got["hist"]],
                                   [l for _, l in want_hist], **TOL)
        _assert_params(got["params"], want, TOL)


def test_data_axis_loss_is_the_whole_batch_masked_mean(ranks):
    """On data = 2 the two ranks' rows hold unequal target counts, so a
    mean of per-rank masked means is not the reference's one masked mean
    over the whole batch; the implicit mode's loss sums the count over
    ``data``, and three SGD steps give one process's losses and
    parameters and the reference's on its data = 2 mesh."""
    for b in ranks["batches"]:
        mask = b["targets"] > 0
        half = mask.shape[0] // 2
        assert mask[:half].sum() != mask[half:].sum()
    one = _sgd_one(ranks)
    want, want_hist = _ref_train(ranks["params"], ranks["batches"], _ref_mesh(2),
                                 optax.sgd(SGD_LR), 3)
    for rank in ranks[2]:
        got = rank["data"]
        np.testing.assert_allclose([l for _, l in got["hist"]],
                                   [l for _, l in one["hist"]], **ONE)
        _assert_params(got["params"], one["params"], ONE)
        np.testing.assert_allclose([l for _, l in got["hist"]],
                                   [l for _, l in want_hist], **TOL)
        _assert_params(got["params"], want, TOL)


@pytest.mark.parametrize("axis,dim", [("model", 2), ("seq", 1)])
def test_a_rank_draws_its_block_of_one_process_mask(ranks, axis, dim):
    """``Dropout`` on a rank's block (its columns over model, the hidden
    site's split; its block of a split sequence) draws the whole shape's
    mask and keeps its block: the ranks' blocks, concatenated, are one
    process's mask, in two draws in a row (the generators advance
    alike)."""
    one = tw.dropout_draw(DRAW_SHAPE, None)["draws"]
    assert not torch.equal(one[0], one[1])
    for i in range(2):
        got = torch.cat([r[f"draw_{axis}"]["draws"][i] for r in ranks[2]], dim=dim)
        assert torch.equal(got, one[i])


@pytest.mark.parametrize("name", ["dropout_model", "dropout_seq"])
def test_two_ranks_at_dropout_draw_one_process_masks(ranks, name):
    """At dropout 0.1 each split site draws the whole activation's mask
    and keeps the rank's block (T5's hidden site: its d_ff columns over
    model; every site: its block of a split sequence), so two ranks
    train as one process does."""
    one = _sgd_one(ranks, {**TINY, "dropout_rate": 0.1})
    plain = _sgd_one(ranks)
    assert one["hist"] != plain["hist"]
    for rank in ranks[2]:
        got = rank[name]
        np.testing.assert_allclose([l for _, l in got["hist"]],
                                   [l for _, l in one["hist"]], **ONE)
        _assert_params(got["params"], one["params"], ONE)


@pytest.mark.parametrize("axis", ["seq", "expert", "pipe"])
def test_t5_replicated_on_other_axes_trains_as_one_process(ranks, axis):
    """T5 names none of seq, expert and pipe in its rules: built on such a
    mesh without a ``batch_partition`` (whole rows a rank) it is
    replicated, and each rank computes one process's run, dropout 0.1
    included."""
    one = _sgd_one(ranks, {**TINY, "dropout_rate": 0.1})
    for rank in ranks[2]:
        got = rank[f"whole_{axis}"]
        np.testing.assert_allclose([l for _, l in got["hist"]],
                                   [l for _, l in one["hist"]], **ONE)
        _assert_params(got["params"], one["params"], ONE)


def test_run_fn_deals_rows_over_data_alone(ranks):
    """``t5_module.run_fn`` on model = 2 (T5 replicated, as the reference's
    ``run_fn`` builds it): both ranks of the one data coordinate train on
    the same rows, ``batch_size`` of them, and report one process's
    losses at that batch."""
    r0, r1 = (r["run_fn"] for r in ranks[2])
    assert len(r0["rows"]) == 3
    for a, b in zip(r0["rows"], r1["rows"]):
        assert a.shape[0] == ranks["run_fn_hp"]["batch_size"]
        np.testing.assert_array_equal(a, b)
    one = tw.t5_run_fn(ranks["examples"], os.path.join(ranks["root"], "one"),
                       ranks["run_fn_hp"], 3, None)
    for a, b in zip(r0["rows"], one["rows"]):
        np.testing.assert_array_equal(a, b)
    for got in (r0, r1):
        np.testing.assert_allclose([l for _, l in got["losses"]],
                                   [l for _, l in one["losses"]], rtol=0, atol=1e-6)


def test_vocabulary_and_heads_divisibility_in_one_process():
    """T5-small's vocabulary (32,128) and the T5 DAG's (a multiple of 64)
    split over model = 2; a vocabulary that does not divide gives the
    reference's divisibility problem and the port's build raises
    ``ValueError``, as BERT's does."""
    for vocab, n, bad in ((32128, 2, False), (64 * 37, 2, False), (30522, 4, True)):
        hp = {**TINY, "vocab_size": vocab}
        sizes = {"data": 1, "model": n, "seq": 1, "expert": 1, "pipe": 1}
        mesh = DeviceMesh(None, 0, sizes, torch.device("cpu"))
        with torch.device("meta"):
            model = build_t5_model(hp)
        got = port_part.validate_partition(
            model, port_part.make_param_partition(model, port_part.t5_partition_rules()),
            mesh)
        shapes = jax.eval_shape(lambda: _ref_t5(hp).init(
            jax.random.key(0), _batch()))["params"]
        want = ref_part.validate_partition(
            shapes, ref_part.make_param_partition(shapes, jt5.t5_partition_rules()),
            _ref_mesh(1, n) if n <= 4 else None)
        assert len([p for p in got if p.startswith("shared.")]) == len(
            [p for p in want if p.startswith("shared")]) == int(bad)
        if bad:
            with pytest.raises(ValueError, match=f"{vocab} vocabulary rows not divisible"):
                with torch.device("meta"):
                    build_t5_model(hp, mesh=mesh)


def _ref_t5(hp):
    return jt5.T5(**{k: hp[k] for k in TINY}, dtype=jnp.float32)
