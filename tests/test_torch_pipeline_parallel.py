"""Pipeline parallelism (ROADMAP.md A6b) on the CPU over gloo
(tests/torch_tp_worker.py, one CPU thread a rank), against the reference
on its virtual 8-device CPU mesh and against one process.

  - ``gpipe`` at (S, M) = (4, 4), (4, 6), (2, 6) against the reference's
    ``gpipe`` (its tests/test_pipeline_parallel.py setups): the forward,
    the stage gradients of the summed output against the reference's
    gradients of its sequential composition, and transformer blocks as
    stages; 2e-5 (f32);
  - the reference's ValueErrors for microbatches that do not divide the
    batch or a microbatch the ``data`` axis does not divide;
  - the staged classifier: the port's sequential path equals the
    reference's (weights carried by ``models/convert.py``), and on
    data=2 x pipe=2 each rank's rows' logits equal both, with the embed
    and head gradients each pipe rank holds equal to one process's, 2e-5;
  - dp2 x pp2 through the Trainer component (``staged_module.py``) against
    the sequential dp2 run on the same rows: the final loss at the
    reference test's rel 2e-4 / abs 2e-5 (tests/test_pp_trainer.py); the
    payload holds both stages and predicts with no mesh.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_dp_worker as w
import torch_tp_worker as tp
from tpu_pipelines.models import staged as ref_staged
from tpu_pipelines.models.transformer import TransformerBlock as RefBlock
from tpu_pipelines.parallel.pipeline_parallel import gpipe as ref_gpipe
from tpu_pipelines_torch.models import staged as port_staged
from tpu_pipelines_torch.models.convert import (
    block_state_dict_from_flax,
    staged_state_dict_from_flax,
)
from tpu_pipelines_torch.parallel.mesh import DeviceMesh
from tpu_pipelines_torch.parallel.pipeline_parallel import gpipe

TOL = dict(rtol=2e-5, atol=2e-5)
FORWARD = [(4, 4), (4, 6), (2, 6)]
STAGED_HP = {**port_staged.DEFAULT_HPARAMS, "n_stages": 2}
TRAIN_STEPS = 12
# The sequential run's stage count is its hyperparameter's (the pipeline
# run's is its pipe axis): both train two stages.
TRAIN_HP = {"batch_size": 32, "n_stages": 2}


def _ref_mesh(data, pipe):
    devs = np.array(jax.devices()[:data * pipe]).reshape(data, 1, 1, 1, pipe)
    return Mesh(devs, ("data", "model", "seq", "expert", "pipe"))


def _ref_mlp_stage(params, x):
    return x + jnp.tanh(x @ params["w"]) @ params["v"]


def _ref_sequential(params, x):
    for i in range(params["w"].shape[0]):
        x = _ref_mlp_stage({k: v[i] for k, v in params.items()}, x)
    return x


def _ref_pipelined(stage_fn, params, x, stages, micro, data):
    mesh = _ref_mesh(data, stages)
    sp = jax.tree_util.tree_map(lambda p: jax.device_put(
        p, NamedSharding(mesh, P("pipe", *([None] * (p.ndim - 1))))), params)
    return np.asarray(jax.jit(lambda p, x: ref_gpipe(
        stage_fn, p, x, mesh=mesh, num_microbatches=micro))(sp, jnp.asarray(x)))


def _transformer_case():
    """The reference test's four transformer blocks as stages."""
    block = RefBlock(n_heads=2, head_dim=8, d_ff=32, dropout_rate=0.0,
                     dtype=jnp.float32)
    x = np.random.default_rng(4).normal(size=(8, 8, 16)).astype(np.float32)
    keys = jax.random.split(jax.random.key(0), 4)
    per_stage = [jax.tree.map(np.asarray, block.init(keys[i], jnp.asarray(x))["params"])
                 for i in range(4)]
    stacked = jax.tree_util.tree_map(lambda *leaves: np.stack(leaves), *per_stage)
    want = jnp.asarray(x)
    for p in per_stage:
        want = block.apply({"params": p}, want)
    port = [block_state_dict_from_flax(p) for p in per_stage]
    state = {n: torch.stack([s[n] for s in port]) for n in port[0]}
    return block, stacked, x, np.asarray(want), state


def _staged_tokens(n=16, seed=5):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(2, 64, size=(n, 16)).astype(np.int64)
    return tokens, (tokens[:, 0] % 4).astype(np.int64)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pp"))
    x = np.random.default_rng(1).normal(size=(24, 16)).astype(np.float32)
    cases = [{"kind": "forward", "stages": s, "micro": m, "x": x,
              "params": tp.stacked_params(s, 16)} for s, m in FORWARD]
    xg = np.random.default_rng(3).normal(size=(16, 8)).astype(np.float32)
    cases.append({"kind": "grad", "stages": 4, "micro": 4, "x": xg,
                  "params": tp.stacked_params(4, 8, seed=2)})
    _, _, xt, want_t, state_t = _transformer_case()
    cases.append({"kind": "transformer", "stages": 4, "micro": 4, "x": xt,
                  "params": state_t})
    model = ref_staged.build_staged_model({"n_stages": 2})
    tokens, labels = _staged_tokens()
    params = jax.tree.map(np.asarray, model.init(jax.random.key(0), tokens))
    npz = os.path.join(root, "tokens.npz")
    rng = np.random.default_rng(7)
    t = rng.integers(2, 64, size=(1024, 16))
    np.savez(npz, tokens=t.astype(np.int64), label=(t[:, 0] % 4).astype(np.int64))
    batch = {"tokens": rng.integers(2, 64, size=(8, 16)).astype(np.int64)}
    four = w.spawn(4, [
        ("gpipe", "torch_tp_worker:gpipe_cases", {"cases": cases}),
        ("staged", "torch_tp_worker:staged_pipe",
         {"hp": STAGED_HP, "state": staged_state_dict_from_flax(params),
          "tokens": tokens, "labels": labels}),
        ("component", "torch_tp_worker:staged_component",
         {"npz": npz, "out_dir": os.path.join(root, "pp"),
          "mesh": {"data": 2, "pipe": 2}, "steps": TRAIN_STEPS, "batch": batch,
          "hp": TRAIN_HP}),
    ], os.path.join(root, "w4"))
    two = w.spawn(2, [
        ("component", "torch_tp_worker:staged_component",
         {"npz": npz, "out_dir": os.path.join(root, "seq"),
          "mesh": {"data": 2, "pipe": 1}, "steps": TRAIN_STEPS, "batch": batch,
          "hp": TRAIN_HP}),
    ], os.path.join(root, "w2"))
    return {"cases": cases, "want_t": want_t, "params": params, "tokens": tokens,
            "labels": labels, "batch": batch, 4: four, 2: two}


def _gathered(ranks, i):
    """Case i's output, each data coordinate's rows (equal on every pipe
    rank) in data order."""
    got = [r["gpipe"][i] for r in ranks[4]]
    by_data = {}
    for g in got:
        if g["data"] in by_data:
            assert torch.equal(by_data[g["data"]], g["out"])
        by_data[g["data"]] = g["out"]
    return torch.cat([by_data[d] for d in sorted(by_data)]).numpy()


@pytest.mark.parametrize("case", range(len(FORWARD)),
                         ids=[f"S{s}-M{m}" for s, m in FORWARD])
def test_gpipe_forward_matches_the_reference(ranks, case):
    """Stage s on pipe rank s alone; the output on every pipe rank equals
    the reference's gpipe on its (data, pipe) mesh and its sequential
    composition."""
    spec = ranks["cases"][case]
    s, m = spec["stages"], spec["micro"]
    want = _ref_pipelined(_ref_mlp_stage, spec["params"], spec["x"], s, m, 8 // s)
    np.testing.assert_allclose(_gathered(ranks, case), want, **TOL)
    np.testing.assert_allclose(
        want, np.asarray(_ref_sequential(spec["params"], jnp.asarray(spec["x"]))),
        **TOL)


def test_gpipe_gradients_match_the_reference_sequential(ranks):
    """The backward pipeline (the inverse permutations) gives each stage
    the gradient the reference takes of its sequential composition."""
    i = len(FORWARD)
    spec = ranks["cases"][i]
    x = jnp.asarray(spec["x"])
    want = jax.jit(jax.grad(lambda p: _ref_sequential(p, x).sum()))(spec["params"])
    want_pipe = jax.jit(jax.grad(lambda p: ref_gpipe(
        _ref_mlp_stage, p, x, mesh=_ref_mesh(2, 4), num_microbatches=4).sum()))(
            spec["params"])
    got = {r["gpipe"][i]["pipe"]: r["gpipe"][i]["grads"] for r in ranks[4]}
    assert sorted(got) == [0, 1, 2, 3]
    for name in ("w", "v"):
        stacked = torch.stack([got[s][name] for s in range(4)]).numpy()
        np.testing.assert_allclose(stacked, np.asarray(want[name]), **TOL)
        np.testing.assert_allclose(stacked, np.asarray(want_pipe[name]), **TOL)


def test_gpipe_transformer_stages_match_the_blocks_in_order(ranks):
    """Four transformer blocks as four stages reproduce the reference's
    block-by-block forward and its gpipe."""
    i = len(FORWARD) + 1
    block, stacked, x, want, _ = _transformer_case()
    np.testing.assert_allclose(_gathered(ranks, i), want, **TOL)
    want_pipe = _ref_pipelined(lambda p, a: block.apply({"params": p}, a),
                               stacked, x, 4, 4, 2)
    np.testing.assert_allclose(_gathered(ranks, i), want_pipe, **TOL)


@pytest.mark.parametrize("rows,micro,match", [
    (10, 4, "batch 10 not divisible by microbatches 4"),
    (12, 4, "microbatch size 3 not divisible by mesh axis data=2")])
def test_gpipe_rejects_indivisible_microbatches(rows, micro, match):
    """The reference's errors, on its test's data=2 x pipe=4 mesh (a rank
    passes its rows: half the batch)."""
    mesh = DeviceMesh(None, 0, {"data": 2, "model": 1, "seq": 1, "expert": 1,
                                "pipe": 4}, torch.device("cpu"))
    params = {k: torch.from_numpy(v) for k, v in tp.stacked_params(4, 8).items()}
    with pytest.raises(ValueError, match=match):
        gpipe(tp.mlp_stage, params, torch.zeros(rows // 2, 8), mesh=mesh,
              num_microbatches=micro)
    with pytest.raises(ValueError, match=match.split(" not")[0]):
        ref_gpipe(_ref_mlp_stage, tp.stacked_params(4, 8),
                  jnp.zeros((rows, 8), jnp.float32), mesh=_ref_mesh(2, 4),
                  num_microbatches=micro)


def _port_sequential(params):
    model = port_staged.build_staged_model(STAGED_HP)
    model.load_state_dict(staged_state_dict_from_flax(params))
    return model


def test_staged_sequential_path_matches_the_reference(ranks):
    """The reference's staged classifier and the port's, both with their
    stages in order, on the same weights."""
    model = ref_staged.build_staged_model({"n_stages": 2})
    want = np.asarray(model.apply(ranks["params"], ranks["tokens"]))
    got = _port_sequential(ranks["params"])(torch.as_tensor(ranks["tokens"]))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_staged_on_pipe2_matches_both_and_embed_head_gradients_one_process(ranks):
    """data=2 x pipe=2: each rank holds its stage ([1, ...]); its rows'
    logits equal the reference's and the port's sequential path, each
    stage's gradient is one process's slice, and every pipe rank holds
    one process's whole gradient of embed and head (the input enters the
    pipeline through ``enter_partial``, the outputs leave through
    ``leave_partial``)."""
    model = ref_staged.build_staged_model({"n_stages": 2})
    want = np.asarray(model.apply(ranks["params"], ranks["tokens"]))
    one = _port_sequential(ranks["params"])
    got = [r["staged"] for r in ranks[4]]
    assert [(g["data"], g["pipe"]) for g in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert got[0]["shapes"]["stages.layers.0.attn.query.weight"] == (1, 32, 32)
    half = len(ranks["tokens"]) // 2
    for g in got:
        rows = slice(g["data"] * half, (g["data"] + 1) * half)
        np.testing.assert_allclose(g["logits"].numpy(), want[rows], **TOL)
        one.zero_grad()
        torch.nn.functional.cross_entropy(
            one(torch.as_tensor(ranks["tokens"][rows])),
            torch.as_tensor(ranks["labels"][rows])).backward()
        for name, p in one.named_parameters():
            want_grad = p.grad[g["pipe"]:g["pipe"] + 1] if name.startswith(
                "stages.") else p.grad
            np.testing.assert_allclose(g["grads"][name].numpy(), want_grad.numpy(),
                                       **TOL, err_msg=name)


def test_dp2_pp2_through_the_trainer_component(ranks):
    """The staged module through the Trainer on {"data": 2, "pipe": 2}
    trains the network the sequential {"data": 2, "pipe": 1} run trains on
    the same rows: the same final loss at the reference test's tolerance,
    on every rank."""
    pp = [r["component"]["props"] for r in ranks[4]]
    seq = [r["component"]["props"] for r in ranks[2]]
    for props in pp + seq:
        assert props["steps_completed"] == TRAIN_STEPS
        assert np.isfinite(props["final_loss"])
    assert len({p["final_loss"] for p in pp}) == 1
    assert seq[0]["final_loss"] == pytest.approx(pp[0]["final_loss"],
                                                 rel=2e-4, abs=2e-5)
    assert ranks[4][0]["component"]["hp"]["n_stages"] == 2


def test_the_payload_holds_both_stages_and_predicts_with_no_mesh(ranks):
    """Rank 0 exports the gathered model: its stages carry the leading
    dim 2, and it predicts with no mesh what the sequential run's payload
    predicts (the two trained the same network)."""
    pp, seq = ranks[4][0]["component"], ranks[2][0]["component"]
    assert pp["lead"] == [2]
    assert pp["logits"].shape == (8, 4) and np.isfinite(pp["logits"]).all()
    np.testing.assert_allclose(pp["logits"], seq["logits"], rtol=2e-4, atol=2e-4)
