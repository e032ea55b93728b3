"""The port's tokenizer core (``transform/native_tokenizer.py`` over
``csrc/host/tokenizer_core.cc``) against the reference's native core and its
Python engine (``tpu_pipelines/transform/``): the ids ``encode_batch``
gives, the vocabulary counter's counts, the routing of rows that are not
ASCII, and the process-pool route of a column that is mostly not ASCII.
Every comparison is exact.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tpu_pipelines.transform import graph as ref_graph
from tpu_pipelines.transform import native_tokenizer as ref_native
from tpu_pipelines_torch.transform import graph
from tpu_pipelines_torch.transform import native_tokenizer as native

WP_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "un", "##believ",
            "##able", "##s", "cat", "dog", ",", ".", "!", "run", "##ning",
            "_odd", "x9", "##9", "caf", "##é"]
PLAIN_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "hello", "world", ","]

ROWS = [
    "the cat, the dog!",
    "unbelievable runs running",
    "UNBELIEVABLE CATS",          # lowercase + wordpiece tails
    "zzz qqq",                    # all [UNK]
    "",                           # empty
    None,                         # None -> ""
    "x9 _odd x99",
    "a" * 500,                    # a long word with no pieces
    "the " * 50,                  # truncated at max_len
    "cat..cat,,cat!!",            # punctuation split per character
    "tabs\tand\nnewlines cat\x1c",
    "café naïve CAFÉ",            # not ASCII: the Python engine
    "Straße ǅ ﬁ",                 # unicode lowercasing and \w
]


def _params(max_len=16, lowercase=True):
    return {"max_len": max_len, "lowercase": lowercase}


def _engine(core, vocab, params):
    table = {v: i for i, v in enumerate(vocab)}
    wp = any(v.startswith("##") for v in vocab)
    return lambda subset: core(subset, params, table, wp)


def _port_ids(col, vocab, params):
    out = native.encode_batch(np.asarray(col, dtype=object), params,
                              {"vocab": list(vocab)},
                              _engine(graph._tokenize_core, vocab, params))
    assert out is not None
    return out


@pytest.fixture(scope="module")
def reference_core():
    if not ref_native.available():
        pytest.skip("the reference's tokenizer core cannot build")


@pytest.mark.parametrize("lowercase", [True, False])
@pytest.mark.parametrize("vocab", [WP_VOCAB, PLAIN_VOCAB],
                         ids=["wordpiece", "plain"])
def test_ids_equal_the_reference_core_and_the_python_engine(
        reference_core, vocab, lowercase):
    params = _params(lowercase=lowercase)
    col = np.asarray(ROWS, dtype=object)
    native.reset_counters()
    got = _port_ids(col, vocab, params)
    seen = native.counters()
    want = ref_native.encode_batch(
        col, params, {"vocab": list(vocab)},
        _engine(ref_graph._tokenize_core, vocab, params))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, _engine(ref_graph._tokenize_core, vocab, params)(col))
    assert seen["native_rows"] == len(ROWS) - 2
    assert seen["python_rows"] == 2


@settings(max_examples=40, deadline=None)
@given(rows=st.lists(
    st.one_of(st.none(), st.text(max_size=30),
              st.text(alphabet="abcdefgilnorstuvx9_ ,.!\t", max_size=40)),
    min_size=1, max_size=12),
    max_len=st.integers(2, 12))
def test_drawn_rows_encode_as_the_python_engine(rows, max_len):
    params = _params(max_len=max_len)
    col = np.asarray(rows, dtype=object)
    np.testing.assert_array_equal(
        _port_ids(col, WP_VOCAB, params),
        _engine(ref_graph._tokenize_core, WP_VOCAB, params)(col))


def test_apply_tokenize_routes_as_the_reference():
    node = graph.Node(id=0, op="tokenize", inputs=[], params=_params(),
                      dtype="int32")
    ref_node = ref_graph.Node(id=0, op="tokenize", inputs=[],
                              params=_params(), dtype="int32")
    col = np.asarray(ROWS * 3, dtype=object)
    np.testing.assert_array_equal(
        graph._apply_tokenize(node, {"vocab": list(WP_VOCAB)}, col),
        ref_graph._apply_tokenize(ref_node, {"vocab": list(WP_VOCAB)}, col))


def test_a_mostly_non_ascii_column_takes_the_process_pool(monkeypatch):
    """More rows that are not ASCII than ``max_python_rows``: encode_batch
    gives None and ``_apply_tokenize`` fans the Python engine out over a
    process pool, whose ids equal the inline engine's."""
    col = np.asarray(["café", "naïve cat", "the dog"] * 4, dtype=object)
    assert native.encode_batch(col, _params(), {"vocab": list(WP_VOCAB)},
                               lambda s: pytest.fail("inline engine"),
                               max_python_rows=5) is None
    monkeypatch.setattr(graph, "_TOK_MIN_PARALLEL_ROWS", 4)
    pools = []
    import concurrent.futures as cf

    real = cf.ProcessPoolExecutor

    class Counted(real):
        def __init__(self, *a, **k):
            pools.append(k.get("max_workers"))
            super().__init__(*a, **k)

    monkeypatch.setattr(cf, "ProcessPoolExecutor", Counted)
    monkeypatch.setattr(graph.os, "cpu_count", lambda: 2)
    node = graph.Node(id=0, op="tokenize", inputs=[], params=_params(),
                      dtype="int32")
    native.reset_counters()
    got = graph._apply_tokenize(node, {"vocab": list(WP_VOCAB)}, col)
    assert pools == [2]
    assert native.counters() == {"native_rows": 0, "python_rows": len(col),
                                 "count_native_rows": 0,
                                 "count_python_rows": 0}
    np.testing.assert_array_equal(
        got, _engine(ref_graph._tokenize_core, WP_VOCAB, _params())(col))


def _py_counts(texts, lowercase=True):
    out = {}
    for t in texts:
        for tok in ref_graph._pretokenize(t, lowercase):
            out[tok] = out.get(tok, 0) + 1
    return out


@pytest.mark.parametrize("lowercase", [True, False])
def test_counter_counts_equal_the_reference_core_and_the_python_engine(
        reference_core, lowercase):
    texts = ["Hello, world! hello WORLD", "", None, 123, "a_b-c d.e",
             "tabs\tand\nnewlines", "!!!", "under_score_9", 2.5]
    col = np.asarray(texts, dtype=object)
    ascii_rows, others = graph._split_ascii_rows(col)
    assert others == []
    port = native.NativeTokenCounter(lowercase)
    port.add_ascii_rows(ascii_rows)
    ref = ref_native.NativeTokenCounter(lowercase)
    ref.add_ascii_rows(ref_graph._split_ascii_rows(col)[0])
    assert port.counts() == ref.counts() == _py_counts(texts, lowercase)
    arr = graph._tokenize_stringify(col)
    port_u = native.NativeTokenCounter(lowercase)
    assert port_u.add_unicode_array(arr)
    assert port_u.counts() == _py_counts(texts, lowercase)


def test_counter_refuses_a_unicode_array_that_is_not_ascii():
    counter = native.NativeTokenCounter(True)
    assert not counter.add_unicode_array(np.asarray(["café", "cat"]))
    assert counter.counts() == {}


@pytest.mark.parametrize("chunk", [1, 5, 35])
def test_vocabulary_pass_equals_the_references(chunk):
    """``_acc_update`` over streamed chunks then ``_acc_finalize``: the
    native counter for ASCII rows, Python for the others, merged; the
    vocabulary equals the reference's pass and the serial count's."""
    texts = ["heLLo wörld", "hello there", "naïve café", None, "a b a",
             "Straße", "the cat, the dog!"] * 5
    params = {"lowercase": True, "vocab_size": 30}
    node = graph.Node(id=0, op="tokenize", inputs=[], params=params,
                      dtype="int32")
    ref_node = ref_graph.Node(id=0, op="tokenize", inputs=[], params=params,
                              dtype="int32")
    acc, ref_acc = graph._acc_init(node), ref_graph._acc_init(ref_node)
    native.reset_counters()
    for i in range(0, len(texts), chunk):
        part = np.asarray(texts[i:i + chunk], object)
        acc = graph._acc_update(node, acc, part, None)
        ref_acc = ref_graph._acc_update(ref_node, ref_acc, part, False)
    seen = native.counters()
    got = graph._acc_finalize(node, acc)
    assert got == ref_graph._acc_finalize(ref_node, ref_acc)
    counts = _py_counts(texts)
    terms = sorted(counts, key=lambda t: (-counts[t], t))
    assert got["vocab"] == list(graph.SPECIAL_TOKENS) + terms[:26]
    assert seen["count_native_rows"] + seen["count_python_rows"] == len(texts)
    assert seen["count_python_rows"] == 15


def test_max_len_below_two_is_refused():
    with pytest.raises(ValueError, match="max_len"):
        native.NativeTokenizer(WP_VOCAB, True).encode_ascii_rows([b"x"], 1)
