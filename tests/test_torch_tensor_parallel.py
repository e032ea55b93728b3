"""Tensor parallelism (ROADMAP.md A6b) on the CPU over gloo
(tests/torch_tp_worker.py, one CPU thread a rank), against the reference
on its virtual 8-device CPU mesh and against one process.

  - tiny BERT (classifier and MLM head, f32 compute) on data=2 x model=2
    with the flax weights loaded into each rank's heads, MLP columns and
    vocabulary rows: each rank's rows' output equals the reference's at
    rtol 1e-4, atol 1e-5;
  - four Adam steps through ``train_loop`` with ``bert_partition_rules``
    on data=2 x model=2: losses and parameters equal the reference's
    ``train_loop`` on its data=2 x model=2 mesh at rtol 1e-4, atol 1e-5
    (but the key bias: the softmax cancels its gradient, which is
    rounding alone in both packages, and Adam turns rounding into steps
    of up to its lr, so the runs part on it; its gradient is held near
    zero in both packages instead);
    a rank's query weight and its Adam moments are its half (the
    reference's test_model_parallel_param_and_optstate_sharding);
  - the vocabulary-parallel MLM head through two SGD steps: the
    parameters equal one process's at the same tolerance (a gather whose
    backward summed the ranks' identical gradients would double them);
  - ring attention composed with ``model`` (data=1 x seq=2 x model=2,
    whole rows a rank) against the reference's dense BERT in bf16, the
    reference's test_bert_ring_attention_matches_dense tolerance 2e-2;
  - at dropout 0.1 the ranks report the same losses and hold every
    replicated parameter bit for bit;
  - the divisibility problems, and the shapes an MoE layer and T5 hold
    on the axes A6c ported, in one process.
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
import torch_tp_worker as tp
from tpu_pipelines.models import bert as ref_bert
from tpu_pipelines.models import transformer as ref_tf
from tpu_pipelines.parallel import partition as ref_part
from tpu_pipelines.trainer import TrainLoopConfig as RefConfig
from tpu_pipelines.trainer import train_loop as ref_train_loop
from tpu_pipelines_torch.models import transformer as port_tf
from tpu_pipelines_torch.models.bert import build_bert_model
from tpu_pipelines_torch.models.convert import bert_state_dict_from_flax
from tpu_pipelines_torch.parallel import partition as port_part
from tpu_pipelines_torch.parallel.mesh import DeviceMesh

TINY = {"vocab_size": 64, "d_model": 64, "n_layers": 2, "n_heads": 4,
        "d_ff": 128, "max_len": 32, "dropout_rate": 0.0, "num_classes": 3,
        "attn_impl": "dense"}
TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
STEPS = 4
LR = 1e-4
# The key projection's bias adds q.b to every score of a query's row,
# which the softmax cancels: its gradient is zero but for rounding, and
# Adam turns that rounding into steps of up to LR (the reference's and
# one process's runs part on it as far).  It is left out of the parameter
# parity; test_the_key_bias_gradient_is_rounding_alone_in_both_packages
# holds its gradient near zero instead.
NON_IDENTIFIABLE = ".attn.key.bias"
# A key bias's gradient against the query bias's of its layer: f32
# rounding (9e-7 at most in the tiny model, both packages) is below it.
KEY_BIAS_GRAD_RATIO = 1e-5


def _batch(b=8, l=16, seed=0, mlm=False):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(4, l + 1, size=b)
    mask = np.arange(l)[None, :] < lengths[:, None]
    ids = np.where(mask, rng.integers(1, TINY["vocab_size"], size=(b, l)), 0)
    label = (rng.integers(0, TINY["vocab_size"], size=(b, l)) if mlm
             else ids[:, 0] % TINY["num_classes"])
    return {"input_ids": ids.astype(np.int32), "attention_mask": mask.astype(np.int32),
            "label": label.astype(np.int32)}


def _features(batch):
    return {k: v for k, v in batch.items() if k != "label"}


def _ref_model(head="classifier", dtype=jnp.float32):
    enc = ref_bert.BertEncoder(
        vocab_size=TINY["vocab_size"], d_model=TINY["d_model"],
        n_layers=TINY["n_layers"], n_heads=TINY["n_heads"], d_ff=TINY["d_ff"],
        max_len=TINY["max_len"], dropout_rate=0.0, dtype=dtype)
    if head == "mlm":
        return ref_bert.BertMLMHead(encoder=enc)
    return ref_bert.BertClassifier(encoder=enc, num_classes=TINY["num_classes"],
                                   dropout_rate=0.0)


def _ref_mesh(data, model, seq=1):
    devs = np.array(jax.devices()[:data * model * seq]).reshape(data, model, seq, 1, 1)
    return Mesh(devs, ("data", "model", "seq", "expert", "pipe"))


def _reference_train(params, batches):
    """The reference's train_loop on data=2 x model=2 with its BERT rules."""
    mesh = _ref_mesh(2, 2)
    model = _ref_model()

    def loss_fn(p, b, rng):
        logits = model.apply({"params": p}, _features(b))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(b["label"], jnp.int32)).mean(), {}

    hist = []
    out, _ = ref_train_loop(
        loss_fn=loss_fn, init_params_fn=lambda rng, b: params,
        optimizer=optax.adam(LR), train_iter=iter(batches),
        config=RefConfig(train_steps=STEPS, batch_size=len(batches[0]["label"]),
                         log_every=1, window_steps=1, prng_impl=None,
                         param_partition=ref_part.make_param_partition(
                             params, ref_bert.bert_partition_rules())),
        mesh=mesh, metrics_cb=lambda s, m: hist.append((s, float(m["loss"]))))
    return bert_state_dict_from_flax(jax.tree.map(np.asarray, out)), hist


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tp"))
    batch = _batch()
    params = jax.tree.map(np.asarray, _ref_model().init(jax.random.key(0),
                                                        _features(batch))["params"])
    mlm_params = jax.tree.map(np.asarray, _ref_model("mlm").init(
        jax.random.key(1), _features(batch))["params"])
    state = bert_state_dict_from_flax(params)
    mlm_state = bert_state_dict_from_flax(mlm_params)
    batches = [_batch(seed=s) for s in range(STEPS)]
    mlm_batches = [_batch(seed=10 + s, mlm=True) for s in range(2)]
    tp_mesh = {"data": 2, "model": 2}
    four = w.spawn(4, [
        ("logits", "torch_tp_worker:bert_tp_logits",
         {"hp": TINY, "state": state, "batch": _features(batch),
          "mesh_config": tp_mesh}),
        ("mlm_logits", "torch_tp_worker:bert_tp_logits",
         {"hp": {**TINY, "head": "mlm"}, "state": mlm_state,
          "batch": _features(batch), "mesh_config": tp_mesh}),
        ("ring", "torch_tp_worker:bert_tp_logits",
         {"hp": {**TINY, "attn_impl": "ring"}, "state": state,
          "batch": _features(batch), "f32": False,
          "mesh_config": {"data": 1, "seq": 2, "model": 2}}),
        ("train", "torch_tp_worker:bert_tp_train",
         {"hp": TINY, "state": state, "batches": batches, "steps": STEPS, "lr": LR}),
        ("mlm_train", "torch_tp_worker:bert_tp_train",
         {"hp": TINY, "state": mlm_state, "batches": mlm_batches, "steps": 2,
          "lr": 0.5, "opt": "sgd", "head": "mlm"}),
        ("dropout", "torch_tp_worker:bert_tp_dropout",
         {"hp": TINY, "state": state, "batches": batches, "steps": 2}),
    ], os.path.join(root, "w4"))
    return {"batch": batch, "params": params, "mlm_params": mlm_params,
            "state": state, "mlm_state": mlm_state, "batches": batches,
            "mlm_batches": mlm_batches, 4: four}


@pytest.mark.parametrize("head", ["classifier", "mlm"])
def test_bert_logits_on_data2_model2_match_the_reference(ranks, head):
    """Rank (d, m) holds data rows d's output; both model ranks hold the
    same, each from its half of the heads, MLP columns and vocabulary
    (the MLM head's logits gathered over ``model``)."""
    params = ranks["params" if head == "classifier" else "mlm_params"]
    want = np.asarray(_ref_model(head).apply({"params": params},
                                             _features(ranks["batch"])))
    got = [r["logits" if head == "classifier" else "mlm_logits"] for r in ranks[4]]
    assert [(g["data"], g["model"]) for g in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert torch.equal(got[0]["out"], got[1]["out"])
    assert torch.equal(got[2]["out"], got[3]["out"])
    np.testing.assert_allclose(torch.cat([got[0]["out"], got[2]["out"]]).numpy(),
                               want, **TOL)
    shapes = got[0]["shapes"]
    assert shapes["encoder.layers.0.attn.query.weight"] == (32, 64)
    assert shapes["encoder.layers.0.attn.out.weight"] == (64, 32)
    assert shapes["encoder.layers.0.mlp.wi.weight"] == (64, 64)
    assert shapes["encoder.layers.0.mlp.wo.weight"] == (64, 64)
    assert shapes["encoder.embed.weight"] == (32, 64)
    assert shapes["encoder.pos_embed.weight"] == (32, 64)
    if head == "mlm":
        assert shapes["mlm_head.weight"] == (32, 64)


def test_train_loop_on_data2_model2_matches_the_reference(ranks):
    """Four Adam steps: every rank reports the reference's losses, and the
    model the loop returns (gathered whole) holds its parameters."""
    want, want_hist = _reference_train(ranks["params"], ranks["batches"])
    for rank in ranks[4]:
        got = rank["train"]
        assert [s for s, _ in got["hist"]] == list(range(1, STEPS + 1))
        np.testing.assert_allclose([l for _, l in got["hist"]],
                                   [l for _, l in want_hist], **TOL)
        assert set(got["params"]) == set(want)
        for name, p in want.items():
            if name.endswith(NON_IDENTIFIABLE):
                continue
            np.testing.assert_allclose(got["params"][name].numpy(), p.numpy(),
                                       **TOL, err_msg=name)


def test_sharded_query_weight_and_its_adam_moments_hold_a_half(ranks):
    """The reference's test_model_parallel_param_and_optstate_sharding: a
    rank's query weight is its model coordinate's half of the whole (rows
    of its heads) and Adam's moments follow it."""
    for rank in ranks[4]:
        got = rank["train"]
        _, m = got["coords"]
        whole = got["params"]["encoder.layers.0.attn.query.weight"]
        half = whole.shape[0] // 2
        assert got["slice"].shape == (half, whole.shape[1])
        assert torch.equal(got["slice"], whole[m * half:(m + 1) * half])
        assert {k: tuple(v.shape) for k, v in got["state"].items()
                if v.dim()} == {"exp_avg": (half, whole.shape[1]),
                                "exp_avg_sq": (half, whole.shape[1])}
    # A model built on the mesh loads the whole state dict into the same
    # cut: its rank's rows (heads, vocabulary) or columns, and the whole
    # of a replicated table.
    state = ranks["state"]
    for rank in ranks[4]:
        got, m = rank["logits"]["loaded"], rank["logits"]["model"]
        for name, dim in (("encoder.layers.0.attn.query.weight", 0),
                          ("encoder.layers.0.attn.out.weight", 1),
                          ("encoder.layers.1.mlp.wi.bias", 0),
                          ("encoder.embed.weight", 0),
                          ("encoder.pos_embed.weight", None)):
            want = state[name]
            if dim is not None:
                k = want.shape[dim] // 2
                want = want.narrow(dim, m * k, k)
            assert torch.equal(got[name], want), name


def test_the_key_bias_gradient_is_rounding_alone_in_both_packages(ranks):
    """The key bias left out of the parameter parity above: the softmax
    cancels its gradient, so in the reference and in the port (one
    process, f32) it is within KEY_BIAS_GRAD_RATIO of its layer's query
    bias gradient, which is not small."""
    b = ranks["batches"][0]
    model = _ref_model()

    def loss(p):
        logits = model.apply({"params": p}, _features(b))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(b["label"], jnp.int32)).mean()

    ref = bert_state_dict_from_flax(jax.tree.map(
        np.asarray, jax.grad(loss)(ranks["params"])))
    port = tp._f32(build_bert_model(TINY))
    port.load_state_dict(ranks["state"])
    logits = port({k: torch.as_tensor(v) for k, v in _features(b).items()})
    torch.nn.functional.cross_entropy(
        logits.float(), torch.as_tensor(b["label"]).long()).backward()
    grads = {n: p.grad for n, p in port.named_parameters()}
    keys = [n for n in grads if n.endswith(NON_IDENTIFIABLE)]
    assert len(keys) == TINY["n_layers"]
    for name in keys:
        query = name.replace(".key.", ".query.")
        for g in (ref, grads):
            scale = float(g[query].abs().max())
            assert scale > 1e-3, query
            assert float(g[name].abs().max()) <= KEY_BIAS_GRAD_RATIO * scale, name


def test_vocabulary_parallel_mlm_head_trains_as_one_process(ranks):
    """Two SGD steps at lr 0.5 through the MLM head's vocabulary split: the
    gathered parameters equal one process's run."""
    one = tp.bert_tp_train(TINY, ranks["mlm_state"], ranks["mlm_batches"], 2,
                           lr=0.5, opt="sgd", head="mlm")
    for rank in ranks[4]:
        got = rank["mlm_train"]
        np.testing.assert_allclose([l for _, l in got["hist"]],
                                   [l for _, l in one["hist"]], **TOL)
        for name, p in one["params"].items():
            np.testing.assert_allclose(got["params"][name].numpy(), p.numpy(),
                                       **TOL, err_msg=name)
    moved = (one["params"]["mlm_head.weight"]
             - ranks["mlm_state"]["mlm_head.weight"]).abs().max()
    assert moved > 1e-3


def test_ring_attention_composed_with_model(ranks):
    """data=1 x seq=2 x model=2 with ring attention on the rank's heads
    (whole rows a rank, its block of them through the ring): every rank's
    output is the reference's dense BERT's (bf16 blocks, its test's 2e-2)."""
    want = np.asarray(_ref_model(dtype=jnp.bfloat16).apply(
        {"params": ranks["params"]}, _features(ranks["batch"])))
    got = [r["ring"]["out"] for r in ranks[4]]
    for g in got[1:]:
        assert torch.equal(g, got[0])
    np.testing.assert_allclose(got[0].float().numpy(), want, **BF16_TOL)


def test_replicated_parameters_stay_bit_for_bit_at_dropout(ranks):
    """At dropout 0.1 the model ranks draw the same masks from the step's
    seed; the replicated parameters' gradients are averaged over model
    and data, so all four ranks hold them bit for bit and report the same
    losses."""
    got = [r["dropout"] for r in ranks[4]]
    assert len(got[0]["replicated"]) > 10
    for g in got[1:]:
        assert g["hist"] == got[0]["hist"]
        for name, p in got[0]["replicated"].items():
            assert torch.equal(g["replicated"][name], p), name
    assert got[0]["hist"] != ranks[4][0]["train"]["hist"][:2]


def test_divisibility_problems_and_unported_axes_in_one_process():
    """BERT's vocabulary of 30,522 splits over model = 2 and not over 4,
    as the reference says; dense attention's temporaries divide heads by
    ``model`` and rows by ``data`` as the reference's; an MoE layer on a
    model axis holds its experts' halves of d_ff and T5 builds on every
    axis (ROADMAP.md A6c)."""
    hp = {**TINY, "vocab_size": 30522}
    tokens = np.ones((2, 8), np.int32)
    shapes = jax.eval_shape(lambda: ref_bert.build_bert_model(
        {**hp, "head": "mlm"}).init(jax.random.key(0), {"input_ids": tokens}))["params"]
    ref_partition = ref_part.make_param_partition(shapes, ref_bert.bert_partition_rules())
    with torch.device("meta"):
        model = build_bert_model({**hp, "head": "mlm"})
    partition = port_part.make_param_partition(model, port_part.bert_partition_rules())
    for n in (2, 4):
        sizes = {"data": 1, "model": n, "seq": 1, "expert": 1, "pipe": 1}
        mesh = DeviceMesh(None, 0, sizes, torch.device("cpu"))
        got = port_part.validate_partition(model, partition, mesh)
        want = ref_part.validate_partition(shapes, ref_partition, _ref_mesh(1, n))
        vocab = [p for p in got if "embed.weight" in p or "mlm_head" in p]
        assert len(vocab) == len([p for p in want if "embed/embedding" in p
                                  or "mlm_head" in p]) == (0 if n == 2 else 2)
        if n == 4:
            with pytest.raises(ValueError,
                               match="30522 vocabulary rows not divisible"):
                build_bert_model(hp, mesh=mesh)
    mesh = DeviceMesh(None, 0, {"data": 2, "model": 2, "seq": 1, "expert": 1,
                                "pipe": 1}, torch.device("cpu"))
    ref_mesh = _ref_mesh(2, 2)
    for args in ((8, 12, 128, 128), (7, 3, 64, 32)):
        assert port_tf.dense_attn_expected_temp_bytes(*args, mesh=mesh) == \
            ref_tf.dense_attn_expected_temp_bytes(*args, mesh=ref_mesh)
    # Refused until A6c: an MoE layer on a model axis holds its experts'
    # d_ff/2 columns, and T5 builds on every axis (its heads, columns,
    # relative-position tables and shared vocabulary halved over model;
    # tests/test_torch_moe_tensor_parallel.py and
    # tests/test_torch_t5_parallel.py train both on gloo ranks).
    moe = build_bert_model({**TINY, "moe_experts": 2}, mesh=mesh)
    assert tuple(moe.encoder.layers[1].moe.wi.shape) == (2, TINY["d_model"],
                                                         TINY["d_ff"] // 2)
    assert tuple(moe.encoder.layers[1].moe.wo.shape) == (2, TINY["d_ff"] // 2,
                                                         TINY["d_model"])
    from tpu_pipelines_torch.models.t5 import build_t5_model

    for axis in ("model", "pipe", "seq", "expert"):
        sizes = {"data": 1, "model": 1, "seq": 1, "expert": 1, "pipe": 1, axis: 2}
        with torch.device("meta"):
            t5 = build_t5_model({}, mesh=DeviceMesh(None, 0, sizes, torch.device("cpu")))
        n = 2 if axis == "model" else 1
        assert tuple(t5.shared.weight.shape) == (32128 // n, 512)
        assert tuple(t5.encoder.rel_pos.rel_embedding.shape) == (32, 8 // n)
        assert tuple(t5.decoder.layers[0].cross.query.weight.shape) == (512 // n, 512)
