"""Ring and Ulysses attention (ROADMAP.md A6a) on the CPU over gloo,
against the reference's ``tpu_pipelines/parallel/ring_attention.py`` on
its virtual 8-device CPU mesh: the cases of tests/test_ring_attention.py.

Each ``seq`` size (2, 4) is one group of spawned processes
(tests/torch_sp_worker.py, one CPU thread a rank) that runs every case
once; each rank returns its block of the output and the gradients of its
term of ``sum(out ** 2)`` for its q, k, v blocks, and the blocks are
concatenated in rank order.  Tolerances, f32 on both sides: forward 2e-5
and gradients 1e-4 (the reference test's own: two libraries' f32 sums in
other orders, the ring's online softmax against one softmax).  Causal
rows with a padding mask are compared where at least one key is allowed
(the reference's rule: dense softmax leaves a row with none uniform, the
ring zero).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_dp_worker as w
import torch_sp_worker as sp
from tpu_pipelines.parallel import ring_attention as ref
from tpu_pipelines.parallel.mesh import MeshConfig as RefMeshConfig
from tpu_pipelines.parallel.mesh import make_mesh as ref_make_mesh
from tpu_pipelines_torch.parallel import ring_attention as port
from tpu_pipelines_torch.parallel.mesh import DeviceMesh

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
CASES = [{"impl": impl, "causal": causal, "masked": masked,
          "h": 8 if impl == "ulysses" else 4}
         for impl in ("ring", "ulysses") for causal in (False, True)
         for masked in (False, True)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sp"))
    return {n: w.spawn(n, [("attn", "torch_sp_worker:attention",
                            {"cases": CASES})], os.path.join(root, f"w{n}"))
            for n in (2, 4)}


def _ref_mesh(n):
    return ref_make_mesh(RefMeshConfig(data=1, seq=n),
                         devices=jax.devices()[:n])


def _reference(case, n):
    """The reference's output and gradients of sum(out ** 2), global."""
    q, k, v = (jnp.asarray(t) for t in sp.qkv(h=case["h"]))
    mask = jnp.asarray(sp.padding_mask()) if case["masked"] else None
    mesh = _ref_mesh(n)
    fn = ref.ring_attention if case["impl"] == "ring" else ref.ulysses_attention
    spec = NamedSharding(mesh, P("data", "seq", "model", None))
    q, k, v = (jax.device_put(t, spec) for t in (q, k, v))

    def loss(q, k, v):
        out = fn(q, k, v, mesh=mesh, causal=case["causal"], kv_mask=mask)
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _rows_with_a_key(case):
    l = 16
    mask = sp.padding_mask() if case["masked"] else np.ones((2, l), np.int32)
    pos = np.arange(l)
    allowed = (pos[:, None] >= pos[None, :]) if case["causal"] else np.ones((l, l), bool)
    return (allowed[None] & (mask[:, None, :] > 0)).any(-1)      # [b, l]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{c['impl']}-{'causal' if c['causal'] else 'full'}"
                              f"{'-masked' if c['masked'] else ''}" for c in CASES])
def test_sequence_parallel_attention_matches_the_reference(ranks, n, i):
    case = CASES[i]
    got = [r["attn"][i] for r in ranks[n]]
    out = torch.cat([g["out"] for g in got], dim=1).numpy()
    grads = [torch.cat([g[k] for g in got], dim=1).numpy()
             for k in ("dq", "dk", "dv")]
    want_out, want_grads = _reference(case, n)
    ok = _rows_with_a_key(case)[:, :, None, None]
    np.testing.assert_allclose(np.where(ok, out, 0), np.where(ok, want_out, 0),
                               **FWD_TOL)
    if ok.all():
        for g, want in zip(grads, want_grads):
            np.testing.assert_allclose(g, want, **GRAD_TOL)
    # Dense attention on the gathered arrays gives the same (the
    # reference's ring == dense test).
    q, k, v = (torch.from_numpy(t) for t in sp.qkv(h=case["h"]))
    mask = torch.from_numpy(sp.padding_mask()) if case["masked"] else None
    dense = port.dense_attention(q, k, v, causal=case["causal"], kv_mask=mask)
    np.testing.assert_allclose(np.where(ok, out, 0),
                               np.where(ok, dense.numpy(), 0), **FWD_TOL)


def _mesh(seq):
    return DeviceMesh(None, 0, {"data": 1, "model": 1, "seq": seq,
                                "expert": 1, "pipe": 1}, torch.device("cpu"))


def test_seq_axis_of_one_is_dense_attention():
    """The reference's ``n == 1`` branch: both functions are dense
    attention, bit for bit."""
    q, k, v = (torch.from_numpy(t) for t in sp.qkv(b=8, l=4))
    mask = torch.from_numpy(sp.padding_mask(b=8, l=4))
    want = port.dense_attention(q, k, v, kv_mask=mask)
    for fn in (port.ring_attention, port.ulysses_attention):
        assert torch.equal(fn(q, k, v, mesh=_mesh(1), kv_mask=mask), want)
    np.testing.assert_allclose(
        want.numpy(), np.asarray(ref.dense_attention(
            *(jnp.asarray(t.numpy()) for t in (q, k, v)),
            kv_mask=jnp.asarray(mask.numpy()))), **FWD_TOL)


def test_the_reference_errors():
    """A length the axis does not divide, and a local head count the axis
    does not divide: the reference's ValueError texts."""
    mesh = ref_make_mesh(RefMeshConfig(data=2, seq=4))
    q, k, v = sp.qkv(b=2, l=18, h=2)
    with pytest.raises(ValueError) as want:
        jax.jit(lambda q, k, v: ref.ring_attention(q, k, v, mesh=mesh))(q, k, v)
    with pytest.raises(ValueError) as got:
        port.check_divisible(18, _mesh(4))
    assert str(got.value) == str(want.value)
    q, k, v = sp.qkv(b=2, l=16, h=2)
    with pytest.raises(ValueError) as want:
        jax.jit(lambda q, k, v: ref.ulysses_attention(q, k, v, mesh=mesh))(q, k, v)
    local = [torch.from_numpy(t[:, :4]) for t in (q, k, v)]
    with pytest.raises(ValueError) as got:
        port.ulysses_attention(*local, mesh=_mesh(4))
    assert str(got.value) == str(want.value)


def test_long_context_batch_partition_selects_token_features():
    """The reference's helper's keys (tests/test_fsdp_window.py), as the
    port's spec tuples."""
    batch = {
        "tokens": np.zeros((8, 4096), np.int32),
        "mask": np.zeros((8, 4096), np.float32),
        "labels": np.zeros((8,), np.int32),
        "short": np.zeros((8, 3), np.float32),
    }
    devs = np.array(jax.devices()[:8]).reshape(1, 1, 8, 1, 1)
    ref_mesh = jax.sharding.Mesh(devs, ("data", "model", "seq", "expert", "pipe"))
    want = ref.long_context_batch_partition(batch, ref_mesh)
    got = port.long_context_batch_partition(batch, _mesh(8))
    assert got == {k: tuple(v) for k, v in want.items()}
    assert got == {"tokens": ("data", "seq"), "mask": ("data", "seq")}
    assert port.long_context_batch_partition(batch, _mesh(1)) == {}
