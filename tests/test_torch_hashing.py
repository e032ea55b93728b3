"""The port's FNV-1a string hashing (``tpu_pipelines_torch/utils/hashing.py``)
against a per-row pure-Python FNV-1a and the JAX package's copy."""

import numpy as np
import pytest

from tpu_pipelines.utils import hashing as ref_hashing
from tpu_pipelines_torch.components import example_gen
from tpu_pipelines_torch.data.examples_io import Table
from tpu_pipelines_torch.utils import hashing

MASK = (1 << 64) - 1


def _fnv_py(text, h=int(hashing.FNV_OFFSET)):
    for c in text:
        h = ((h ^ ord(c)) * int(hashing.FNV_PRIME)) & MASK
    return h


def _strings(rng, n, lo, hi, alphabet="abc,.-0123456789é漢"):
    return [
        "".join(rng.choice(list(alphabet), size=int(rng.integers(lo, hi + 1))))
        for _ in range(n)
    ]


@pytest.mark.parametrize("n,lo,hi", [
    (1, 0, 0),          # one empty row
    (5, 0, 40),         # some rows empty, ragged lengths
    (64, 300, 300),     # every row one length: no masked tail
    (3, 2000, 2100),    # a few long rows
    (200, 1, 12),       # many short rows
])
def test_hash_strings_equals_per_row_fnv_and_the_reference(n, lo, hi):
    rng = np.random.default_rng(n + lo + hi)
    values = _strings(rng, n, lo, hi)
    got = hashing.hash_strings(values)
    assert [int(x) for x in got] == [_fnv_py(v) for v in values]
    np.testing.assert_array_equal(got, ref_hashing.hash_strings(values))


def test_fnv1a_update_continues_given_states_and_leaves_them_alone(monkeypatch):
    rng = np.random.default_rng(7)
    first, second = _strings(rng, 9, 0, 30), _strings(rng, 9, 0, 30)
    start = hashing.hash_strings(first)
    kept = start.copy()
    # Blocks of a few code points: the unmasked prefix spans several.
    monkeypatch.setattr(hashing, "_BLOCK_CODES", 20)
    got = hashing.fnv1a_update(start, np.asarray(second))
    np.testing.assert_array_equal(start, kept)
    assert [int(x) for x in got] == [
        _fnv_py(b, _fnv_py(a)) for a, b in zip(first, second)]


def test_row_hash_buckets_of_long_float_rows_equal_the_joined_text_hash():
    rng = np.random.default_rng(3)
    table = Table({"image": rng.normal(size=(3, 4000)).astype(np.float32),
                   "label": np.arange(3)})
    kinds = example_gen.column_kinds(table)
    got = example_gen._row_hash_buckets(table, kinds, 1000)
    texts = {name: example_gen.arrow_text(table.columns[name],
                                          table.null_mask(name), kinds[name])
             for name in table.column_names}
    want = [_fnv_py("\x1f".join(str(texts[name][i]) for name in table.column_names))
            % 1000 for i in range(3)]
    assert list(got) == want
