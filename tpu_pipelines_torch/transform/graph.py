"""TransformGraph: analysis, host/device evaluation, serialization.

The port of ``tpu_pipelines/transform/graph.py``.  The serialized DAG is
the only definition of preprocessing, in the same format as the
reference's (``save`` / ``load``: a graph saved by either package loads in
the other).  It is interpreted in two places:

  * ``apply_host``: vectorized numpy, as the reference's (materialization
    on the CPU, the semantics reference);
  * the device side: ``split_host_device`` cuts the DAG at the
    string->numeric frontier with the reference's partition and ``c<id>``
    interface names; the numeric subgraph runs through a torch evaluator,
    one function per op, on the device of its input tensors
    (``apply_device`` for materialization, the exported payload's
    ``predict`` for serving).  Its semantics are the numpy ones in f32:
    ``one_hot`` gives all-zero rows for out-of-range ids, ``bucketize`` is a
    left-side search over f32 boundaries returning int32, ``fill_missing``
    replaces NaN, ``where`` tests ``!= 0``; every scalar operand is an f32
    tensor on the device, so ``+ - * /`` round as numpy's f32 ops do.

The numeric analyzers (moments for ``z_score``, min/max for
``scale_to_0_1``) run as torch reductions in float64 on the device the
caller passes (``analyze_chunks(..., device=...)``), numpy float64 without
one.  The reference reduced in f32 on a TPU, which has no f64; the H100
has, so the card's states equal the host's up to the order of the sums
(``ROADMAP.md`` C).  Tokenization runs as the reference's: the native core
(``transform/native_tokenizer.py`` over ``csrc/host/tokenizer_core.cc``)
counts and encodes the ASCII rows, the Python engine the others, and a
process pool of the Python engine takes a column whose rows are mostly not
ASCII.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_pipelines_torch.data.schema import FeatureType, Schema
from tpu_pipelines_torch.transform.expr import (
    NUMERIC,
    OPS,
    STRING,
    ColumnRef,
    GraphBuilder,
    Node,
    TftNamespace,
    is_ref,
    ref_id,
)

GRAPH_FILE = "transform_graph.json"
STATE_FILE = "analyzer_state.npz"
VOCAB_DIR = "vocabularies"
# v2: Node.inputs encodes node references as {"ref": id} (bare ints are
# literal scalars).  v1 graphs (bare-int refs) are rejected, not mis-read.
GRAPH_FORMAT = "transform-graph/v2"


class _LazyInputs:
    """Dict-like view handed to preprocessing_fn; creates inputs on access."""

    def __init__(self, builder: GraphBuilder, dtypes: Dict[str, str]):
        self._b = builder
        self._dtypes = dtypes

    def __getitem__(self, name: str) -> ColumnRef:
        if name not in self._dtypes:
            raise KeyError(
                f"preprocessing_fn requested unknown feature {name!r}; "
                f"schema has {sorted(self._dtypes)}"
            )
        return self._b.input(name, self._dtypes[name])

    def keys(self):
        return self._dtypes.keys()

    def __contains__(self, name: str) -> bool:
        return name in self._dtypes


def _schema_dtypes(schema: Schema) -> Dict[str, str]:
    return {
        name: STRING if f.type == FeatureType.BYTES else NUMERIC
        for name, f in schema.features.items()
    }


def _stable_hash_strings(values: np.ndarray, buckets: int) -> np.ndarray:
    from tpu_pipelines_torch.utils.hashing import hash_buckets

    return hash_buckets(values, buckets).astype(np.int32)


class TransformGraph:
    """A resolved (or being-resolved) preprocessing DAG."""

    def __init__(
        self,
        nodes: List[Node],
        outputs: Dict[str, int],
        state: Optional[Dict[int, Dict[str, Any]]] = None,
    ):
        self.nodes = nodes
        self.outputs = outputs
        self.state: Dict[int, Dict[str, Any]] = state or {}
        # Lazy (host_fn, device_fn) pair for apply_device, set once under
        # the lock (shard threads materialize through one graph).
        self._device_apply = None
        self._device_apply_lock = threading.Lock()

    # ------------------------------------------------------------ building

    @classmethod
    def build(
        cls,
        preprocessing_fn: Callable,
        schema: Schema,
    ) -> "TransformGraph":
        builder = GraphBuilder()
        tft = TftNamespace(builder)
        inputs = _LazyInputs(builder, _schema_dtypes(schema))
        out = preprocessing_fn(inputs, tft)
        if not isinstance(out, dict) or not out:
            raise ValueError(
                "preprocessing_fn must return a non-empty dict of ColumnRefs"
            )
        outputs: Dict[str, int] = {}
        for name, ref in out.items():
            if not isinstance(ref, ColumnRef):
                raise TypeError(
                    f"preprocessing_fn output {name!r} is "
                    f"{type(ref).__name__}, expected ColumnRef"
                )
            outputs[name] = ref.id
        return cls(builder.nodes, outputs)

    # ------------------------------------------------------------ analysis

    def analyze(self, data: Dict[str, np.ndarray]) -> None:
        """Full-pass analysis of an in-memory dataset (single chunk)."""
        self.analyze_chunks(lambda: iter([data]))

    def analyze_chunks(
        self,
        chunks_fn: Callable[[], Any],
        device: Any = None,
    ) -> None:
        """Resolve every analyzer by streaming chunks — the Beam-less
        full pass (SURVEY.md §3.4): per-chunk partial states accumulate and
        merge, so no column is ever materialized whole.

        ``chunks_fn()`` returns a fresh iterator of dict-of-numpy chunks per
        pass.  Nested analyzers (z-score of a bucketized column) resolve in
        multiple passes: pass k handles analyzers whose upstream analyzers
        resolved in passes < k — the tf.Transform phase structure.

        ``device``: where the numeric accumulators (moments, min/max) run,
        as float64 torch reductions; None = numpy float64 on the host.
        """
        if device is not None:
            from tpu_pipelines_torch.utils.device import resolve_device

            device = resolve_device(device)
        upstream_analyzers = self._upstream_analyzers()
        guard = 0
        while True:
            unresolved = [
                n for n in self.nodes
                if n.op in OPS and OPS[n.op].is_analyzer
                and n.id not in self.state
            ]
            if not unresolved:
                break
            ready = [
                n for n in unresolved
                if all(
                    a in self.state for a in upstream_analyzers[n.id]
                    if a != n.id
                )
            ]
            if not ready:
                raise RuntimeError(
                    "analyzer dependency cycle: "
                    f"{[n.op for n in unresolved]}"
                )
            # Analyzers whose state is derivable without data (vocab files).
            pending = []
            for node in ready:
                st = _finalize_dataless(node)
                if st is not None:
                    self.state[node.id] = st
                else:
                    pending.append(node)
            if not pending:
                guard += 1
                if guard > len(self.nodes) + 1:
                    raise RuntimeError("analysis did not converge")
                continue
            # One streaming pass accumulating all pending-ready analyzers.
            accs = {n.id: _acc_init(n) for n in pending}
            needed = [n.id for n in pending]
            for chunk in chunks_fn():
                vals = self._eval_available(chunk, needed)
                for node in pending:
                    arg = vals[ref_id(node.inputs[0])]
                    accs[node.id] = _acc_update(
                        node, accs[node.id], arg, device
                    )
            for node in pending:
                self.state[node.id] = _acc_finalize(node, accs[node.id])

    def _upstream_analyzers(self) -> Dict[int, set]:
        """Per node: ids of analyzer nodes among its ancestors (and itself's
        direct analyzer inputs) — the phase-ordering relation."""
        up: Dict[int, set] = {}
        for node in self.nodes:  # nodes are already topologically ordered
            s: set = set()
            for a in node.inputs:
                if is_ref(a):
                    aid = ref_id(a)
                    s |= up[aid]
                    if OPS.get(self.nodes[aid].op) and OPS[self.nodes[aid].op].is_analyzer:
                        s.add(aid)
            up[node.id] = s
        return up

    def _eval_available(
        self, data: Dict[str, Any], target_ids: List[int]
    ) -> Dict[int, Any]:
        """Evaluate just the nodes feeding ``target_ids``'s inputs, using
        resolved analyzer states only (callers guarantee reachability)."""
        need: set = set()
        stack = [
            ref_id(a)
            for t in target_ids
            for a in self.nodes[t].inputs if is_ref(a)
        ]
        while stack:
            nid = stack.pop()
            if nid in need:
                continue
            need.add(nid)
            stack.extend(
                ref_id(a) for a in self.nodes[nid].inputs if is_ref(a)
            )
        subset = [n.id for n in self.nodes if n.id in need]
        return self._eval(data, subset=subset)

    # ---------------------------------------------------------- evaluation

    def apply_host(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Vectorized numpy evaluation: the semantics reference, and the
        materialization path when the user chooses the host."""
        vals = self._eval(batch)
        return {name: vals[nid] for name, nid in self.outputs.items()}

    def apply_device(
        self, batch: Dict[str, np.ndarray], device: Any = "cuda"
    ) -> Dict[str, np.ndarray]:
        """Materialize one batch through the host/device split: string ops
        in numpy (``host_fn``), the interface moved to ``device``, the
        numeric subgraph through the torch evaluator there, the outputs
        back as numpy.  Equal to ``apply_host`` up to f32 rounding of the
        transcendental ops; both interpret the same DAG.  A failure raises:
        nothing gives way to the host path.
        """
        from tpu_pipelines_torch.utils.device import resolve_device

        dev = resolve_device(device)
        with self._device_apply_lock:
            if self._device_apply is None:
                host_fn, device_fn, iface_names = self.split_host_device()
                # A string-valued output crossing the interface (e.g. an
                # identity passthrough of a raw string column) cannot be a
                # tensor: such a graph materializes host-side and
                # device_apply_active reports it.
                strings = any(
                    self.nodes[int(k[1:])].dtype == STRING for k in iface_names
                )
                self._device_apply = (
                    (None, None) if strings else (host_fn, device_fn))
        host_fn, device_fn = self._device_apply
        if device_fn is None:
            return self.apply_host(batch)
        iface = {
            k: torch.from_numpy(np.require(v, requirements=["C", "W"])).to(dev)
            for k, v in host_fn(batch).items()
        }
        with torch.inference_mode():
            out = device_fn(iface)
        return {k: v.cpu().numpy() for k, v in out.items()}

    @property
    def device_apply_active(self) -> Optional[bool]:
        """None before apply_device first ran; False when this graph's
        interface carries strings and it materializes host-side; True when
        chunks really go through the torch evaluator on the device.
        Callers recording "ran on device" must check this, not assume."""
        if self._device_apply is None:
            return None
        return self._device_apply[1] is not None

    def _eval(
        self,
        data: Dict[str, Any],
        subset: Optional[List[int]] = None,
    ) -> Dict[int, Any]:
        """Numpy evaluation of every node (or of ``subset``)."""
        vals: Dict[int, Any] = {}
        nodes = (
            self.nodes if subset is None
            else [self.nodes[i] for i in subset]
        )
        for node in nodes:
            if node.id in vals:
                continue
            if node.op == "input":
                if node.name not in data:
                    raise KeyError(
                        f"transform input feature {node.name!r} missing from batch"
                    )
                vals[node.id] = data[node.name]
                continue
            args = [
                vals[ref_id(a)] if is_ref(a) else a for a in node.inputs
            ]
            opdef = OPS[node.op]
            if opdef.is_analyzer:
                if node.id not in self.state:
                    raise RuntimeError(
                        f"analyzer node #{node.id} ({node.op}) has no "
                        "state; run analyze() first"
                    )
                vals[node.id] = _apply_analyzer(
                    node, self.state[node.id], args[0]
                )
            else:
                vals[node.id] = _apply_stateless(node, args)
        return vals

    # ------------------------------------------------- host/device split

    def split_host_device(
        self,
    ) -> Tuple[Callable, Callable, List[str]]:
        """Partition at the string→numeric frontier.

        Returns ``(host_fn, device_fn, interface_names)``:
          - ``host_fn(batch) -> {iface_name: np.ndarray}`` runs string ops
            (vocab lookup, hashing) plus passthrough of numeric inputs;
          - ``device_fn(iface) -> outputs`` is pure numeric: the torch
            evaluator over tensors (on the device they lie on), to run
            beside the model forward;
          - the interface is the list of array names crossing host→device.

        Skew safety: both functions are interpretations of the same DAG.
        """
        host_nodes: set = set()
        for node in self.nodes:
            if node.op == "input":
                if node.dtype == STRING:
                    host_nodes.add(node.id)
                continue
            arg_ids = [ref_id(a) for a in node.inputs if is_ref(a)]
            consumes_string = any(
                self.nodes[a].dtype == STRING for a in arg_ids
            )
            if consumes_string or node.dtype == STRING:
                host_nodes.add(node.id)

        # Interface: numeric-valued nodes that device-side nodes consume but
        # are produced on host (string-derived ids), plus numeric inputs.
        iface_ids: List[int] = []
        for node in self.nodes:
            if node.id in host_nodes:
                continue
            if node.op == "input":
                if node.id not in iface_ids:
                    iface_ids.append(node.id)
                continue
            for a in node.inputs:
                if is_ref(a) and ref_id(a) in host_nodes:
                    if ref_id(a) not in iface_ids:
                        iface_ids.append(ref_id(a))
        # Outputs computed entirely on host also cross the boundary.
        for name, nid in self.outputs.items():
            if nid in host_nodes and nid not in iface_ids:
                iface_ids.append(nid)

        iface_names = [f"c{nid}" for nid in iface_ids]
        device_subset = [
            n.id for n in self.nodes if n.id not in host_nodes
        ]

        def host_fn(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
            vals = self._eval_host_side(batch, host_nodes, iface_ids)
            return {f"c{nid}": vals[nid] for nid in iface_ids}

        def device_fn(iface: Dict[str, Any]) -> Dict[str, Any]:
            preset = {nid: iface[f"c{nid}"] for nid in iface_ids}
            vals = self._eval_torch(preset, device_subset)
            return {name: vals[nid] for name, nid in self.outputs.items()}

        return host_fn, device_fn, iface_names

    def _eval_host_side(
        self, batch: Dict[str, np.ndarray], host_nodes: set, iface_ids: List[int]
    ) -> Dict[int, Any]:
        """Evaluate host nodes + numeric inputs needed at the interface."""
        vals: Dict[int, Any] = {}
        needed = set(iface_ids)
        for node in self.nodes:
            if node.op == "input":
                if node.id in host_nodes or node.id in needed:
                    if node.name not in batch:
                        raise KeyError(
                            f"feature {node.name!r} missing from batch"
                        )
                    vals[node.id] = batch[node.name]
                continue
            if node.id not in host_nodes:
                continue
            args = [
                vals[ref_id(a)] if is_ref(a) else a for a in node.inputs
            ]
            opdef = OPS[node.op]
            if opdef.is_analyzer:
                if node.id not in self.state:
                    raise RuntimeError(
                        f"analyzer node #{node.id} unresolved; run analyze()"
                    )
                vals[node.id] = _apply_analyzer(
                    node, self.state[node.id], args[0]
                )
            else:
                vals[node.id] = _apply_stateless(node, args)
        return vals

    def _eval_torch(
        self, preset: Dict[int, torch.Tensor], subset: List[int]
    ) -> Dict[int, torch.Tensor]:
        """The device side: every node of ``subset`` through the torch
        evaluator, from the interface tensors in ``preset``."""
        vals: Dict[int, torch.Tensor] = dict(preset)
        for nid in subset:
            node = self.nodes[nid]
            if nid in vals:
                continue
            if node.op == "input":
                raise KeyError(
                    f"numeric input {node.name!r} (c{nid}) missing from the "
                    "device interface"
                )
            args = [
                vals[ref_id(a)] if is_ref(a) else a for a in node.inputs
            ]
            if OPS[node.op].is_analyzer:
                if nid not in self.state:
                    raise RuntimeError(
                        f"analyzer node #{nid} ({node.op}) has no state; "
                        "run analyze() first"
                    )
                vals[nid] = _torch_analyzer(node, self.state[nid], args[0])
            else:
                vals[nid] = _torch_stateless(node, args)
        return vals

    # -------------------------------------------------------- persistence

    def save(self, uri: str) -> None:
        os.makedirs(uri, exist_ok=True)
        graph_json = {
            "format": GRAPH_FORMAT,
            "nodes": [n.to_json() for n in self.nodes],
            "outputs": self.outputs,
        }
        with open(os.path.join(uri, GRAPH_FILE), "w") as f:
            json.dump(graph_json, f, indent=2, sort_keys=True)
        arrays: Dict[str, np.ndarray] = {}
        vocab_meta: Dict[str, Dict] = {}
        for nid, st in self.state.items():
            for key, val in st.items():
                if key.startswith("_"):
                    continue  # derived caches (e.g. tokenize _table)
                if key == "vocab":
                    # Human-inspectable vocabulary files, one term per line —
                    # the tf.Transform vocab-file convention.
                    vdir = os.path.join(uri, VOCAB_DIR)
                    os.makedirs(vdir, exist_ok=True)
                    vpath = os.path.join(vdir, f"vocab_{nid}.txt")
                    with open(vpath, "w") as f:
                        for term in val:
                            f.write(f"{term}\n")
                    vocab_meta[str(nid)] = {"size": len(val)}
                else:
                    arrays[f"{nid}:{key}"] = np.asarray(val)
        np.savez(os.path.join(uri, STATE_FILE), **arrays)
        with open(os.path.join(uri, "vocab_meta.json"), "w") as f:
            json.dump(vocab_meta, f)

    @classmethod
    def load(cls, uri: str) -> "TransformGraph":
        with open(os.path.join(uri, GRAPH_FILE)) as f:
            graph_json = json.load(f)
        fmt = graph_json.get("format")
        if fmt != GRAPH_FORMAT:
            raise ValueError(
                f"transform graph at {uri!r} has format {fmt!r}, expected "
                f"{GRAPH_FORMAT!r}; re-run the Transform component"
            )
        nodes = [Node.from_json(d) for d in graph_json["nodes"]]
        outputs = {k: int(v) for k, v in graph_json["outputs"].items()}
        state: Dict[int, Dict[str, Any]] = {}
        npz_path = os.path.join(uri, STATE_FILE)
        if os.path.exists(npz_path):
            data = np.load(npz_path)
            for key in data.files:
                nid_s, skey = key.split(":", 1)
                state.setdefault(int(nid_s), {})[skey] = data[key]
        meta_path = os.path.join(uri, "vocab_meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                vocab_meta = json.load(f)
            for nid_s in vocab_meta:
                vpath = os.path.join(uri, VOCAB_DIR, f"vocab_{nid_s}.txt")
                with open(vpath) as f:
                    vocab = [line.rstrip("\n") for line in f]
                state.setdefault(int(nid_s), {})["vocab"] = vocab
        return cls(nodes, outputs, state)

    # --------------------------------------------------------------- misc

    def output_feature_names(self) -> List[str]:
        return sorted(self.outputs)

    def input_feature_names(self) -> List[str]:
        """Raw columns the graph actually reads — the projection set for
        column-pruned reads (schema features the preprocessing_fn never
        touched are never read)."""
        return sorted({n.name for n in self.nodes if n.op == "input"})

    def tokenizer_vocab_sizes(self) -> Dict[str, int]:
        """Resolved vocab size per tokenize-producing output column.

        Lets a trainer module size its embedding table from what the
        tokenizer actually learned (plus OOV-free specials), instead of
        guessing — ids are always < this size.
        """
        out: Dict[str, int] = {}
        for name, nid in self.outputs.items():
            node = self.nodes[nid]
            if node.op == "tokenize" and nid in self.state:
                out[name] = len(self.state[nid]["vocab"])
        return out


# ---------------------------------------------------------------- operators


def _finite_f64(col, device) -> torch.Tensor:
    return torch.from_numpy(np.array(col, np.float64).ravel()).to(device)


def _moments_chunk(col, device):
    """(count, sum, sum_sq) over non-NaN values of one chunk, in float64:
    a torch reduction on ``device``, numpy without one."""
    if device is not None:
        x = _finite_f64(col, device)
        ok = ~torch.isnan(x)
        xz = torch.where(ok, x, torch.zeros((), dtype=x.dtype, device=x.device))
        c, s, ss = torch.stack(
            [ok.sum().to(torch.float64), xz.sum(), (xz * xz).sum()]
        ).tolist()
        return float(c), float(s), float(ss)
    x = np.asarray(col, np.float64).ravel()
    x = x[~np.isnan(x)]
    return float(len(x)), float(x.sum()), float((x * x).sum())


def _minmax_chunk(col, device):
    """(count, min, max) over non-NaN values of one chunk (float64 torch
    reductions on ``device``, numpy without one)."""
    if device is not None:
        x = _finite_f64(col, device)
        ok = ~torch.isnan(x)
        inf = torch.full((), float("inf"), dtype=x.dtype, device=x.device)
        c, lo, hi = torch.stack([
            ok.sum().to(torch.float64),
            torch.where(ok, x, inf).min() if x.numel() else inf,
            torch.where(ok, x, -inf).max() if x.numel() else -inf,
        ]).tolist()
        return float(c), float(lo), float(hi)
    x = np.asarray(col, np.float64).ravel()
    x = x[~np.isnan(x)]
    if not len(x):
        return 0.0, np.inf, -np.inf
    return float(len(x)), float(x.min()), float(x.max())


# Mergeable quantile summary for bucketize: raw values accumulate until the
# buffer exceeds _SKETCH_COMPRESS, then compress to _SKETCH_SIZE weighted
# quantile points.  Uncompressed summaries finalize through np.quantile
# exactly, so small datasets match the in-memory semantics bit-for-bit.
_SKETCH_SIZE = 2048
_SKETCH_COMPRESS = 8192


def _weighted_quantile(values, weights, qs):
    order = np.argsort(values, kind="stable")
    v, w = values[order], weights[order]
    cw = (np.cumsum(w) - 0.5 * w) / w.sum()
    return np.interp(qs, cw, v)


def _sketch_add(sk: Dict[str, Any], vals: np.ndarray) -> Dict[str, Any]:
    if len(vals):
        sk["values"] = np.concatenate([sk["values"], vals])
        sk["weights"] = np.concatenate(
            [sk["weights"], np.ones(len(vals), np.float64)]
        )
    if len(sk["values"]) > _SKETCH_COMPRESS:
        total = sk["weights"].sum()
        qs = (np.arange(_SKETCH_SIZE) + 0.5) / _SKETCH_SIZE
        sk["values"] = _weighted_quantile(sk["values"], sk["weights"], qs)
        sk["weights"] = np.full(
            _SKETCH_SIZE, total / _SKETCH_SIZE, np.float64
        )
        sk["compressed"] = True
    return sk


def _acc_init(node: Node) -> Dict[str, Any]:
    if node.op == "z_score":
        return {"count": 0.0, "sum": 0.0, "sumsq": 0.0}
    if node.op == "scale_to_0_1":
        return {"count": 0.0, "min": np.inf, "max": -np.inf}
    if node.op in ("vocab_apply", "tokenize"):
        return {"counts": {}}
    if node.op == "bucketize":
        return {
            "values": np.zeros(0, np.float64),
            "weights": np.zeros(0, np.float64),
            "compressed": False,
        }
    raise ValueError(f"unknown analyzer {node.op!r}")


def _acc_update(
    node: Node, acc: Dict[str, Any], col, device
) -> Dict[str, Any]:
    if node.op == "z_score":
        c, s, ss = _moments_chunk(col, device)
        acc["count"] += c
        acc["sum"] += s
        acc["sumsq"] += ss
        return acc
    if node.op == "scale_to_0_1":
        c, lo, hi = _minmax_chunk(col, device)
        acc["count"] += c
        acc["min"] = min(acc["min"], lo)
        acc["max"] = max(acc["max"], hi)
        return acc
    if node.op == "vocab_apply":
        uniq, counts = np.unique(_stringify_column(col), return_counts=True)
        merged = acc["counts"]
        for term, cnt in zip(uniq, counts):
            merged[str(term)] = merged.get(str(term), 0) + int(cnt)
        return acc
    if node.op == "bucketize":
        vals = np.asarray(col, np.float64).ravel()
        _sketch_add(acc, vals[~np.isnan(vals)])
        return acc
    if node.op == "tokenize":
        _count_pretokens_into(acc, col, node.params.get("lowercase", True))
        return acc
    raise ValueError(f"unknown analyzer {node.op!r}")


def _count_pretokens_into(acc: Dict[str, Any], col, lowercase: bool) -> None:
    """Accumulate the vocabulary-build token counts for one chunk: the
    native counter for ASCII rows (the counts stay in its hash map until
    finalize), Python's unicode-exact pretokenizer for the others.  The
    reference's process pool of the Python counter serves a build without
    the native core, which the port does not have (a failed build
    raises)."""
    from tpu_pipelines_torch.transform import native_tokenizer

    native = acc.get("_native_counter")
    if native is None:
        native = acc["_native_counter"] = native_tokenizer.NativeTokenCounter(
            lowercase)
    strs = _tokenize_stringify(col)
    # All-ASCII fast path: the U-dtype UCS4 buffer crosses the FFI as it is.
    if native.add_unicode_array(strs):
        return
    ascii_rows, others = _split_ascii_rows(col, strs=strs)
    native.add_ascii_rows(ascii_rows)
    counts = acc["counts"]
    for text in others:
        for tok in _pretokenize(text, lowercase):
            counts[tok] = counts.get(tok, 0) + 1
    native_tokenizer._count(count_python_rows=len(others))


def _tokenize_stringify(col) -> np.ndarray:
    """Per-element ``str(value)`` as a U-dtype array: the exact text the
    per-row Python engine tokenizes (floats keep their decimal text, None
    becomes "")."""
    arr = np.asarray(col)
    if arr.dtype == object:
        # None pretokenizes to no tokens ("" in the Python engine).
        mask = np.frompyfunc(lambda x: x is None, 1, 1)(arr).astype(bool)
        if mask.any():
            arr = arr.copy()
            arr[mask] = ""
    return np.asarray(arr.ravel(), dtype="U")


def _split_ascii_rows(col, strs: Optional[np.ndarray] = None):
    """(ascii_rows: List[bytes], other_texts: List[str]) for the native
    routing: one vectorized encode for an all-ASCII column, row by row
    otherwise."""
    if strs is None:
        strs = _tokenize_stringify(col)
    try:
        return [bytes(b) for b in np.char.encode(strs, "ascii")], []
    except UnicodeEncodeError:
        pass
    ascii_rows, others = [], []
    for s in strs:
        try:
            ascii_rows.append(str(s).encode("ascii"))
        except UnicodeEncodeError:
            others.append(str(s))
    return ascii_rows, others


def _acc_finalize(node: Node, acc: Dict[str, Any]) -> Dict[str, Any]:
    p = node.params
    if node.op == "z_score":
        c = acc["count"]
        if not c:
            return {"mean": 0.0, "std": 1.0}
        mean = acc["sum"] / c
        var = max(0.0, acc["sumsq"] / c - mean * mean)
        std = var ** 0.5
        return {"mean": mean, "std": std if std > 0 else 1.0}
    if node.op == "scale_to_0_1":
        if not acc["count"]:
            return {"min": 0.0, "max": 1.0}
        lo, hi = acc["min"], acc["max"]
        return {"min": lo, "max": hi if hi > lo else lo + 1.0}
    if node.op == "vocab_apply":
        terms = acc["counts"]
        uniq = np.asarray(sorted(terms), dtype=object)
        counts = np.asarray([terms[t] for t in uniq], np.int64)
        if p.get("frequency_threshold", 0):
            keep = counts >= p["frequency_threshold"]
            uniq, counts = uniq[keep], counts[keep]
        # Order: descending frequency, then lexical — deterministic.
        order = np.lexsort((uniq, -counts))
        vocab = [str(uniq[i]) for i in order]
        if p.get("top_k"):
            vocab = vocab[: p["top_k"]]
        return {"vocab": vocab}
    if node.op == "bucketize":
        qs = np.linspace(0, 1, p["num_buckets"] + 1)[1:-1]
        if not len(acc["values"]):
            return {"boundaries": np.zeros(0)}
        if acc["compressed"]:
            boundaries = _weighted_quantile(
                acc["values"], acc["weights"], qs
            )
        else:
            boundaries = np.quantile(acc["values"], qs)
        return {"boundaries": np.unique(boundaries)}
    if node.op == "tokenize":
        counts = acc["counts"]
        native = acc.pop("_native_counter", None)
        if native is not None:
            # Drain the core's hash map once; merge with the Python-side
            # counts of the rows that are not ASCII.
            for tok, n in native.counts().items():
                counts[tok] = counts.get(tok, 0) + n
        # descending frequency, then lexical — deterministic
        terms = sorted(counts, key=lambda t: (-counts[t], t))
        budget = max(0, int(p.get("vocab_size", 8000)) - len(SPECIAL_TOKENS))
        return {"vocab": list(SPECIAL_TOKENS) + terms[:budget]}
    raise ValueError(f"unknown analyzer {node.op!r}")


def _finalize_dataless(node: Node) -> Optional[Dict[str, Any]]:
    """State derivable without a data pass (tokenize with a fixed vocab)."""
    if node.op == "tokenize" and node.params.get("vocab_file"):
        with open(node.params["vocab_file"]) as f:
            vocab = [line.rstrip("\n") for line in f if line.rstrip("\n")]
        missing = [t for t in SPECIAL_TOKENS if t not in vocab]
        if missing:
            raise ValueError(
                f"tokenize vocab_file {node.params['vocab_file']!r} lacks "
                f"special tokens {missing}; the ids-0-3 = "
                "[PAD]/[UNK]/[CLS]/[SEP] contract requires them"
            )
        return {"vocab": vocab}
    return None


def _stringify_column(col) -> np.ndarray:
    """Column → unicode array, vectorized (ints stringify like str(int))."""
    col = np.asarray(col)
    if col.dtype == object or col.dtype.kind in ("U", "S"):
        return np.asarray(col, dtype="U")
    return col.ravel().astype(np.int64).astype("U")


SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]")
_PUNCT_SPLIT = None  # compiled lazily


def _pretokenize(text, lowercase: bool) -> List[str]:
    """Whitespace + punctuation split (the BERT basic-tokenizer convention)."""
    global _PUNCT_SPLIT
    if _PUNCT_SPLIT is None:
        import re

        _PUNCT_SPLIT = re.compile(r"\w+|[^\w\s]")
    s = "" if text is None else str(text)
    if lowercase:
        s = s.lower()
    return _PUNCT_SPLIT.findall(s)


def _wordpiece(tok: str, table: Dict[str, int], unk: int) -> List[int]:
    """Greedy longest-match-first wordpiece (BERT); whole-word if present."""
    if tok in table:
        return [table[tok]]
    ids: List[int] = []
    start = 0
    while start < len(tok):
        end = len(tok)
        piece_id = None
        while start < end:
            sub = tok[start:end] if start == 0 else "##" + tok[start:end]
            if sub in table:
                piece_id = table[sub]
                break
            end -= 1
        if piece_id is None:
            return [unk]
        ids.append(piece_id)
        start = end
    return ids


def _tokenize_core(
    col, params: Dict[str, Any], table: Dict[str, int], has_wordpiece: bool
) -> np.ndarray:
    unk = table.get("[UNK]", 1)
    cls_id = table.get("[CLS]", 2)
    sep_id = table.get("[SEP]", 3)
    max_len = int(params["max_len"])
    lowercase = params.get("lowercase", True)
    out = np.zeros((len(col), max_len), dtype=np.int32)  # 0 = [PAD]
    for i, text in enumerate(col):
        ids = [cls_id]
        for tok in _pretokenize(text, lowercase):
            if has_wordpiece:
                ids.extend(_wordpiece(tok, table, unk))
            else:
                ids.append(table.get(tok, unk))
            if len(ids) >= max_len - 1:
                break
        ids = ids[: max_len - 1] + [sep_id]
        out[i, : len(ids)] = ids
    return out


# A column of at least this many rows fans the Python engine out over a
# process pool (the reference's thresholds).
_TOK_MIN_PARALLEL_ROWS = 4096
_TOK_MAX_WORKERS = 8
_TOK_CTX = None


def _tok_init(params: Dict[str, Any], vocab: List[str]) -> None:
    global _TOK_CTX
    table = {v: i for i, v in enumerate(vocab)}
    _TOK_CTX = (params, table, any(v.startswith("##") for v in vocab))


def _tok_chunk(rows) -> np.ndarray:
    params, table, has_wordpiece = _TOK_CTX
    return _tokenize_core(rows, params, table, has_wordpiece)


def _apply_tokenize(node: Node, state: Dict[str, Any], col) -> np.ndarray:
    """Tokenize a column: the native core first (its rows that are not
    ASCII through the Python engine), then a process-pool fan-out of the
    Python engine when more than ``_TOK_MIN_PARALLEL_ROWS`` rows are not
    ASCII, then the engine inline for a small column."""
    from tpu_pipelines_torch.transform import native_tokenizer

    p = node.params
    vocab = state["vocab"]
    # Memoized on the state dict: predict() re-enters here per batch.
    table = state.get("_table")
    if table is None:
        table = state["_table"] = {v: i for i, v in enumerate(vocab)}
        state["_has_wordpiece"] = any(v.startswith("##") for v in vocab)
    has_wordpiece = state["_has_wordpiece"]
    native = native_tokenizer.encode_batch(
        col, p, state,
        lambda subset: _tokenize_core(subset, p, table, has_wordpiece),
        max_python_rows=_TOK_MIN_PARALLEL_ROWS,
    )
    if native is not None:
        return native
    native_tokenizer._count(python_rows=len(col))
    workers = min(os.cpu_count() or 1, _TOK_MAX_WORKERS)
    if len(col) >= _TOK_MIN_PARALLEL_ROWS and workers > 1:
        from concurrent.futures import ProcessPoolExecutor

        chunks = [c for c in np.array_split(col, workers * 4) if len(c)]
        with ProcessPoolExecutor(
            max_workers=workers, initializer=_tok_init,
            initargs=(dict(p), list(vocab)),
        ) as ex:
            parts = list(ex.map(_tok_chunk, chunks))
        return np.concatenate(parts, axis=0)
    return _tokenize_core(col, p, table, has_wordpiece)


def _apply_analyzer(node: Node, state: Dict[str, Any], col):
    if node.op == "z_score":
        x = np.asarray(col, dtype=np.float32)
        return (x - float(state["mean"])) / float(state["std"])
    if node.op == "scale_to_0_1":
        x = np.asarray(col, dtype=np.float32)
        lo, hi = float(state["min"]), float(state["max"])
        return (x - lo) / (hi - lo)
    if node.op == "vocab_apply":
        # Host-only (consumes strings / stringified ints).  Vectorized:
        # binary search over the sorted vocab, FNV bucketing for OOV rows —
        # no per-row Python loop (the Beam-parallelism replacement).
        vocab = state["vocab"]
        num_oov = node.params.get("num_oov_buckets", 1) or 0
        strs = _stringify_column(col)
        sorted_vocab = state.get("_sorted_vocab")
        if sorted_vocab is None:
            vocab_arr = np.asarray(vocab, dtype="U")
            order = np.argsort(vocab_arr, kind="stable")
            sorted_vocab = state["_sorted_vocab"] = vocab_arr[order]
            state["_sorted_order"] = order
        order = state["_sorted_order"]
        pos = np.searchsorted(sorted_vocab, strs)
        pos_c = np.minimum(pos, len(sorted_vocab) - 1)
        found = (
            (sorted_vocab[pos_c] == strs) if len(sorted_vocab)
            else np.zeros(len(strs), bool)
        )
        out = np.where(found, order[pos_c], -1).astype(np.int32)
        if num_oov > 0 and not found.all():
            from tpu_pipelines_torch.utils.hashing import hash_buckets

            oov = hash_buckets(strs[~found], num_oov) + len(vocab)
            out[~found] = oov.astype(np.int32)
        return out
    if node.op == "bucketize":
        boundaries = np.asarray(state["boundaries"], dtype=np.float32)
        x = np.asarray(col, dtype=np.float32)
        return np.searchsorted(boundaries, x).astype(np.int32)
    if node.op == "tokenize":
        return _apply_tokenize(node, state, np.asarray(col))
    raise ValueError(f"unknown analyzer {node.op!r}")


def _is_string_array(x) -> bool:
    return isinstance(x, np.ndarray) and (
        x.dtype == object or x.dtype.kind in ("U", "S")
    )


def _apply_stateless(node: Node, args: List[Any]):
    op = node.op
    p = node.params
    if op == "identity":
        return args[0]
    if op == "fill_missing":
        x = args[0]
        default = p.get("default", 0)
        if _is_string_array(x):
            out = np.asarray(
                [default if v is None else v for v in x], dtype=object
            )
            return out
        x = np.asarray(x, dtype=np.float32)
        return np.nan_to_num(x, nan=float(default))
    if op == "hash_strings":
        return _stable_hash_strings(np.asarray(args[0]), p["hash_buckets"])
    if op == "equal" and "value" in p:
        x = np.asarray(args[0])
        return (x.astype(str) == p["value"]).astype(np.float32)
    if op == "one_hot":
        x = np.asarray(args[0]).astype(np.int32)
        depth = p["depth"]
        eye = np.eye(depth, dtype=np.float32)
        clipped = np.clip(x, 0, depth - 1)
        out = eye[clipped]
        # Out-of-range (e.g. OOV -1) rows become all-zero.
        mask = ((x >= 0) & (x < depth)).astype(np.float32)
        return out * mask[..., None]
    if op == "cast":
        return np.asarray(args[0]).astype(p.get("dtype", "float32"))
    if op == "clip":
        x = np.asarray(args[0], dtype=np.float32)
        return np.clip(x, p["min_value"], p["max_value"])

    fa = [
        np.asarray(a, dtype=np.float32)
        if not isinstance(a, (int, float)) else a
        for a in args
    ]
    if op == "add":
        return fa[0] + fa[1]
    if op == "sub":
        return fa[0] - fa[1]
    if op == "mul":
        return fa[0] * fa[1]
    if op == "div":
        return fa[0] / fa[1]
    if op == "log1p":
        return np.log1p(fa[0])
    if op == "log":
        return np.log(fa[0])
    if op == "sqrt":
        return np.sqrt(fa[0])
    if op == "abs":
        return np.abs(fa[0])
    if op == "equal":
        return (fa[0] == fa[1]).astype(np.float32)
    if op == "greater":
        return (fa[0] > fa[1]).astype(np.float32)
    if op == "less":
        return (fa[0] < fa[1]).astype(np.float32)
    if op == "where":
        return np.where(fa[0] != 0, fa[1], fa[2])
    raise ValueError(f"unknown op {op!r}")


# ------------------------------------------------------- the torch evaluator
#
# One function per op, in torch idiom, with the numpy semantics above in f32.
# Scalars become f32 tensors on the operand's device, so an op with a
# scalar is the same f32 op as numpy's (a CPU scalar would let CUDA divide
# by multiplying with a reciprocal).


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float32 else x.to(torch.float32)


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    raise ValueError("device op without a tensor operand")


# One f32 0-d tensor per (constant, device).  A constant operand stays a
# device tensor (a CPU scalar would let PyTorch turn x / c into x * (1/c),
# which is not numpy's f32 division), and it is made once: a serving step
# is run eagerly before it is captured as a CUDA graph, and a capture may
# not copy from the host.
_CONSTANTS: Dict[Tuple[float, torch.device], torch.Tensor] = {}


def _constant(value: float, dev: torch.device) -> torch.Tensor:
    key = (float(value), torch.device(dev))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.tensor(key[0], dtype=torch.float32,
                                           device=dev)
    return t


def _operand(a, dev: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return _f32(a)
    return _constant(a, dev)


def _t_add(a, b):
    return a + b


def _t_sub(a, b):
    return a - b


def _t_mul(a, b):
    return a * b


def _t_div(a, b):
    return a / b


def _t_equal(a, b):
    return (a == b).to(torch.float32)


def _t_greater(a, b):
    return (a > b).to(torch.float32)


def _t_less(a, b):
    return (a < b).to(torch.float32)


def _t_where(cond, a, b):
    return torch.where(cond != 0, a, b)


_T_ELEMENTWISE = {
    "add": _t_add, "sub": _t_sub, "mul": _t_mul, "div": _t_div,
    "equal": _t_equal, "greater": _t_greater, "less": _t_less,
    "where": _t_where,
    "log1p": torch.log1p, "log": torch.log, "sqrt": torch.sqrt,
    "abs": torch.abs,
}


def _t_one_hot(x: torch.Tensor, depth: int) -> torch.Tensor:
    """f32 one-hot of int32-truncated ids; an id outside [0, depth) gives
    an all-zero row."""
    ids = x.to(torch.int32)
    classes = torch.arange(depth, dtype=torch.int32, device=x.device)
    return (ids[..., None] == classes).to(torch.float32)


def _torch_stateless(node: Node, args: List[Any]) -> torch.Tensor:
    op, p = node.op, node.params
    if op == "identity":
        return args[0]
    if op in ("hash_strings",) or (op == "equal" and "value" in p):
        raise ValueError(f"op {op!r} consumes strings; it runs host-side")
    if op == "fill_missing":
        return torch.nan_to_num(_f32(args[0]), nan=float(p.get("default", 0)))
    if op == "one_hot":
        return _t_one_hot(args[0], int(p["depth"]))
    if op == "cast":
        return args[0].to(getattr(torch, p.get("dtype", "float32")))
    if op == "clip":
        return torch.clamp(
            _f32(args[0]), float(p["min_value"]), float(p["max_value"])
        )
    fn = _T_ELEMENTWISE.get(op)
    if fn is None:
        raise ValueError(f"unknown op {op!r}")
    dev = _device_of(args)
    return fn(*[_operand(a, dev) for a in args])


def _state_tensor(state: Dict[str, Any], key: str, dev: torch.device):
    """An analyzer state value as an f32 tensor on ``dev``, cached on the
    state dict per device (not saved: ``save`` skips "_" keys)."""
    cache = state.setdefault("_torch", {})
    t = cache.get((key, dev))
    if t is None:
        t = cache[(key, dev)] = torch.as_tensor(
            np.asarray(state[key], np.float32)
        ).to(dev)
    return t


def _torch_analyzer(node: Node, state: Dict[str, Any], x) -> torch.Tensor:
    dev = x.device
    if node.op == "z_score":
        return (_f32(x) - _state_tensor(state, "mean", dev)) / _state_tensor(
            state, "std", dev)
    if node.op == "scale_to_0_1":
        lo = _state_tensor(state, "min", dev)
        # (hi - lo) rounds in f32, as numpy's (x - lo) / (hi - lo) with
        # Python floats does not: take the numpy span, rounded once.
        span = float(state["max"]) - float(state["min"])
        return (_f32(x) - lo) / _constant(span, dev)
    if node.op == "bucketize":
        return torch.searchsorted(
            _state_tensor(state, "boundaries", dev), _f32(x).contiguous()
        ).to(torch.int32)
    raise ValueError(
        f"analyzer {node.op!r} consumes strings; it runs host-side"
    )
