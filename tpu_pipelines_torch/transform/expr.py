"""Column-expression DAG built by ``preprocessing_fn(inputs, tft)``: the
port's copy of ``tpu_pipelines/transform/expr.py``.

Each ``ColumnRef`` is a node: an input column, a stateless op over other
columns, or an analyzer-backed op whose parameters come from a full pass over
the dataset.  The DAG is JSON-serializable; evaluation backends live in
``graph.py``.

Dtype classes: STRING columns live on host (numpy object arrays); NUMERIC
columns may evaluate on host or on-chip.  Analyzer ops that consume strings
(vocab lookup, hashing) emit NUMERIC — they are the host→device frontier.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Union

STRING = "STRING"
NUMERIC = "NUMERIC"

Scalar = Union[int, float]


@dataclasses.dataclass(frozen=True)
class OpDef:
    name: str
    out_dtype: str            # STRING | NUMERIC | "same"
    is_analyzer: bool = False


# Stateless elementwise ops (NUMERIC in → NUMERIC out unless noted).
_STATELESS = [
    OpDef("add", "same"), OpDef("sub", "same"), OpDef("mul", "same"),
    OpDef("div", "same"), OpDef("log1p", NUMERIC), OpDef("log", NUMERIC),
    OpDef("sqrt", NUMERIC), OpDef("abs", NUMERIC), OpDef("clip", NUMERIC),
    OpDef("cast", NUMERIC), OpDef("fill_missing", "same"),
    OpDef("where", "same"), OpDef("equal", NUMERIC), OpDef("greater", NUMERIC),
    OpDef("less", NUMERIC), OpDef("one_hot", NUMERIC),
    OpDef("hash_strings", NUMERIC),
    OpDef("identity", "same"),
]
_ANALYZERS = [
    OpDef("z_score", NUMERIC, is_analyzer=True),
    OpDef("scale_to_0_1", NUMERIC, is_analyzer=True),
    OpDef("vocab_apply", NUMERIC, is_analyzer=True),
    OpDef("bucketize", NUMERIC, is_analyzer=True),
    # text -> [n, max_len] int token ids (host-side; SURVEY.md §7 hard part 5)
    OpDef("tokenize", NUMERIC, is_analyzer=True),
]
OPS: Dict[str, OpDef] = {o.name: o for o in _STATELESS + _ANALYZERS}


class ColumnRef:
    """Symbolic column; supports arithmetic sugar (``x * 2``, ``x + y``)."""

    def __init__(
        self,
        graph: "GraphBuilder",
        node_id: int,
        dtype: str,
    ):
        self.graph = graph
        self.id = node_id
        self.dtype = dtype

    # arithmetic sugar ------------------------------------------------------
    def _bin(self, op: str, other: Union["ColumnRef", Scalar]) -> "ColumnRef":
        return self.graph.add_op(op, [self, other])

    def __add__(self, other):
        return self._bin("add", other)

    def __radd__(self, other):
        return self._bin("add", other)

    def __sub__(self, other):
        return self._bin("sub", other)

    def __mul__(self, other):
        return self._bin("mul", other)

    def __rmul__(self, other):
        return self._bin("mul", other)

    def __truediv__(self, other):
        return self._bin("div", other)

    def __repr__(self):
        return f"ColumnRef(#{self.id}, {self.dtype})"


REF_KEY = "ref"


def is_ref(x: Any) -> bool:
    """True if an entry of ``Node.inputs`` references another node."""
    return isinstance(x, dict) and REF_KEY in x


def ref_id(x: Any) -> int:
    return int(x[REF_KEY])


@dataclasses.dataclass
class Node:
    id: int
    op: str                    # "input" or an OPS name
    # Node references are {"ref": id}; anything else is a literal scalar.
    # (A bare int would be ambiguous with literal operands like `x > 0`.)
    inputs: List[Any]
    params: Dict[str, Any]
    dtype: str
    name: str = ""             # input column name for op == "input"

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Node":
        return cls(**d)


class GraphBuilder:
    """Accumulates nodes as preprocessing_fn executes."""

    def __init__(self):
        self.nodes: List[Node] = []
        self._input_ids: Dict[str, int] = {}

    def input(self, name: str, dtype: str) -> ColumnRef:
        if name in self._input_ids:
            nid = self._input_ids[name]
            return ColumnRef(self, nid, self.nodes[nid].dtype)
        node = Node(
            id=len(self.nodes), op="input", inputs=[], params={},
            dtype=dtype, name=name,
        )
        self.nodes.append(node)
        self._input_ids[name] = node.id
        return ColumnRef(self, node.id, dtype)

    def add_op(
        self,
        op: str,
        inputs: Sequence[Union[ColumnRef, Scalar]],
        params: Optional[Dict[str, Any]] = None,
    ) -> ColumnRef:
        opdef = OPS[op]
        in_vals: List[Any] = []
        in_dtypes: List[str] = []
        for x in inputs:
            if isinstance(x, ColumnRef):
                if x.graph is not self:
                    raise ValueError("mixing ColumnRefs from different graphs")
                in_vals.append({REF_KEY: x.id})
                in_dtypes.append(x.dtype)
            elif isinstance(x, (int, float)):
                in_vals.append(x)
                in_dtypes.append(NUMERIC)
            else:
                raise TypeError(
                    f"op {op!r}: operand must be ColumnRef or scalar, got "
                    f"{type(x).__name__}"
                )
        if opdef.out_dtype == "same":
            dtype = STRING if STRING in in_dtypes else NUMERIC
        else:
            dtype = opdef.out_dtype
        node = Node(
            id=len(self.nodes), op=op, inputs=in_vals,
            params=dict(params or {}), dtype=dtype,
        )
        self.nodes.append(node)
        return ColumnRef(self, node.id, dtype)


class TftNamespace:
    """The ``tft`` argument to preprocessing_fn: analyzers + stateless ops.

    Naming follows tf.Transform's public API (``scale_to_z_score``,
    ``compute_and_apply_vocabulary``, ``bucketize``, ``hash_strings``) so the
    reference's Transform recipes port by renaming only.
    """

    def __init__(self, builder: GraphBuilder):
        self._b = builder

    # ---- analyzers (full-pass state)
    def scale_to_z_score(self, x: ColumnRef) -> ColumnRef:
        return self._b.add_op("z_score", [x])

    def scale_to_0_1(self, x: ColumnRef) -> ColumnRef:
        return self._b.add_op("scale_to_0_1", [x])

    def compute_and_apply_vocabulary(
        self, x: ColumnRef, top_k: Optional[int] = None,
        num_oov_buckets: int = 1, frequency_threshold: int = 0,
    ) -> ColumnRef:
        return self._b.add_op(
            "vocab_apply", [x],
            {"top_k": top_k, "num_oov_buckets": num_oov_buckets,
             "frequency_threshold": frequency_threshold},
        )

    def bucketize(self, x: ColumnRef, num_buckets: int) -> ColumnRef:
        return self._b.add_op("bucketize", [x], {"num_buckets": num_buckets})

    def tokenize(
        self, x: ColumnRef, max_len: int, vocab_size: int = 8000,
        lowercase: bool = True, vocab_file: Optional[str] = None,
    ) -> ColumnRef:
        """Text column -> [n, max_len] int32 ids: [CLS] tokens… [SEP] [PAD]….

        Without ``vocab_file`` the analyzer learns a word-level vocabulary
        (most frequent ``vocab_size`` terms) in the full pass; with one, it
        loads it (one term per line; '##'-prefixed pieces switch matching to
        greedy wordpiece, the BERT convention).  Ids 0-3 are reserved:
        [PAD]=0 [UNK]=1 [CLS]=2 [SEP]=3.  Derive an attention mask with
        ``tft.greater(ids, 0)``.
        """
        return self._b.add_op(
            "tokenize", [x],
            {"max_len": max_len, "vocab_size": vocab_size,
             "lowercase": lowercase, "vocab_file": vocab_file},
        )

    # ---- stateless
    def hash_strings(self, x: ColumnRef, hash_buckets: int) -> ColumnRef:
        return self._b.add_op(
            "hash_strings", [x], {"hash_buckets": hash_buckets}
        )

    def one_hot(self, x: ColumnRef, depth: int) -> ColumnRef:
        return self._b.add_op("one_hot", [x], {"depth": depth})

    def log1p(self, x: ColumnRef) -> ColumnRef:
        return self._b.add_op("log1p", [x])

    def log(self, x: ColumnRef) -> ColumnRef:
        return self._b.add_op("log", [x])

    def sqrt(self, x: ColumnRef) -> ColumnRef:
        return self._b.add_op("sqrt", [x])

    def abs(self, x: ColumnRef) -> ColumnRef:
        return self._b.add_op("abs", [x])

    def clip(self, x: ColumnRef, min_value: float, max_value: float) -> ColumnRef:
        return self._b.add_op(
            "clip", [x], {"min_value": min_value, "max_value": max_value}
        )

    def cast(self, x: ColumnRef, dtype: str = "float32") -> ColumnRef:
        return self._b.add_op("cast", [x], {"dtype": dtype})

    def fill_missing(self, x: ColumnRef, default: Any = 0) -> ColumnRef:
        return self._b.add_op("fill_missing", [x], {"default": default})

    def where(self, cond: ColumnRef, a, b) -> ColumnRef:
        return self._b.add_op("where", [cond, a, b])

    def equal(self, x: ColumnRef, value: Any) -> ColumnRef:
        # String comparison keeps the literal in params (host-only op).
        if isinstance(value, str):
            return self._b.add_op("equal", [x], {"value": value})
        return self._b.add_op("equal", [x, value])

    def greater(self, x: ColumnRef, value) -> ColumnRef:
        return self._b.add_op("greater", [x, value])

    def less(self, x: ColumnRef, value) -> ColumnRef:
        return self._b.add_op("less", [x, value])
