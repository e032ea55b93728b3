"""The port's T5 generation against the JAX package's, on a tiny model.

Greedy and beam search (tokens equal, beam scores within 2e-5), beam size 1
against greedy, EOS then pad, sampling that repeats from one generator
seed, and params handed in beside the module's own.  The model and the
tolerances are those of ``tests/torch_t5_tiny.py``.
"""

import numpy as np
import pytest
import torch

import torch_t5_tiny as tiny
from tpu_pipelines.models import t5 as jt5
from tpu_pipelines_torch.models import t5 as pt5

TINY = tiny.TINY
TOL = tiny.TOL


@pytest.fixture(scope="module")
def flax_params():
    return tiny.flax_params()


def test_greedy_tokens_equal_and_sampling_repeats(flax_params):
    inputs, mask, _ = tiny.batch(seed=3, b=3)
    L = 6
    want, want_done = jt5.make_greedy_generate(
        tiny.jax_model(), max_decode_len=L, eos_id=1)(flax_params, inputs, mask)
    model, params = tiny.port_model(flax_params)
    greedy = pt5.make_greedy_generate(model, max_decode_len=L, eos_id=1)
    with torch.no_grad():
        got, done = greedy(params, torch.from_numpy(inputs),
                           torch.from_numpy(mask))
    assert got.dtype == torch.int32 and got.shape == (3, L)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(done.numpy(), np.asarray(want_done))

    sample = pt5.make_greedy_generate(model, max_decode_len=L, temperature=0.8)
    with pytest.raises(ValueError, match="requires a generator"):
        sample(params, torch.from_numpy(inputs))
    with torch.no_grad():
        a, _ = sample(params, torch.from_numpy(inputs),
                      generator=torch.Generator().manual_seed(7))
        b, _ = sample(params, torch.from_numpy(inputs),
                      generator=torch.Generator().manual_seed(7))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="temperature"):
        pt5.make_greedy_generate(model, temperature=-1.0)


def test_greedy_emits_eos_then_pad(flax_params):
    model, params = tiny.port_model(flax_params)
    inputs = torch.tensor([[5, 9, 3, 2, 0, 0], [7, 7, 7, 7, 7, 7]])
    with torch.no_grad():
        first, _ = pt5.make_greedy_generate(model, max_decode_len=6, eos_id=1)(
            params, inputs)
    # Take a token the model does emit as EOS: everything after it is pad.
    eos = int(first[0, 1])
    with torch.no_grad():
        tokens, done = pt5.make_greedy_generate(
            model, max_decode_len=6, eos_id=eos)(params, inputs)
    assert bool(done[0])
    for row, fin in zip(tokens.tolist(), done.tolist()):
        if eos in row:
            at = row.index(eos)
            assert fin and all(t == 0 for t in row[at + 1:])


def test_beam_tokens_and_scores_match(flax_params):
    inputs, mask, _ = tiny.batch(seed=4, b=3)
    L = 6
    want, want_score = jt5.make_beam_generate(
        tiny.jax_model(), beam_size=4, max_decode_len=L, eos_id=1)(
            flax_params, inputs, mask)
    model, params = tiny.port_model(flax_params, "flash")
    with torch.no_grad():
        got, score = pt5.make_beam_generate(
            model, beam_size=4, max_decode_len=L, eos_id=1)(
                params, torch.from_numpy(inputs), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(score.numpy(), np.asarray(want_score), **TOL)


def test_beam_size_one_is_greedy(flax_params):
    model, params = tiny.port_model(flax_params)
    inputs = torch.tensor([[5, 9, 3, 2, 0, 0], [11, 4, 8, 1, 2, 3]])
    mask = (inputs > 0).to(torch.int32)
    with torch.no_grad():
        g, _ = pt5.make_greedy_generate(model, max_decode_len=5, eos_id=1)(
            params, inputs, mask)
        b, _ = pt5.make_beam_generate(model, beam_size=1, max_decode_len=5,
                                      eos_id=1)(params, inputs, mask)
    torch.testing.assert_close(g, b, rtol=0, atol=0)


def test_params_other_than_the_modules_run_through_functional_call(
        flax_params):
    """A params dict the module does not hold runs the module with it (the
    reference passes params to every call); the module keeps its own."""
    model, params = tiny.port_model(flax_params)
    other = {name: t * 2.0 for name, t in params.items()}
    inputs = torch.tensor([[5, 9, 3, 2, 1, 1]])
    twin = pt5.T5(**TINY, dtype=torch.float32).eval()
    twin.load_state_dict(other)
    with torch.no_grad():
        got, _ = pt5.make_greedy_generate(model, max_decode_len=4)(other, inputs)
        want, _ = pt5.make_greedy_generate(twin, max_decode_len=4)(
            dict(twin.state_dict()), inputs)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(model.shared.weight, params["shared.weight"])
