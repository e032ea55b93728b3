"""Layer 2: TPP2xx code rules over executor and module-file sources.

The port's copy of ``tpu_pipelines/analysis/code_rules.py``: the same rule
ids, severities and finding fields.  Where the JAX package looks inside a
``jax.jit`` region, the port looks inside a *captured region*, the code
that a CUDA-graph capture or ``torch.compile`` records once and replays:

  * a function handed to ``train_loop(loss_fn=...)`` (the port's loop
    captures forward, backward and update as one CUDA graph), resolved
    through the module's globals when it is defined outside the source
    being read;
  * the body of a ``with torch.cuda.graph(...)`` block;
  * functions handed to ``torch.cuda.make_graphed_callables``;
  * ``@torch.compile`` functions and ``torch.compile(f)``.

The same hazards break a capture or are baked in by it: a host sync
(``.item()``, ``.cpu()``, ``.numpy()``, ``.tolist()``,
``torch.cuda.synchronize()``, ``float()``/``int()``/``bool()`` on a
tensor; TPP203), ``time.*`` / ``random.*`` / ``np.random.*`` (TPP204), a
Python branch on a tensor argument (TPP205), and, in a hand-rolled loop
beside ``TrainLoopConfig(window_steps>1)``, per-step ``.to(device)`` /
``torch.tensor(..., device=...)`` traffic (TPP207).

Where the graph rules see the IR, these see the *code* each node will run:
``inspect.getsource`` of every component executor plus the user entry
points the component loads by path (Trainer ``run_fn``, Transform
``preprocessing_fn``, declared per component via ``LINT_MODULE_FNS``).
Detection is static and shallow: the analyzer never calls user code
(loading a module file executes its top level, as the runner would; a
failure there is itself a finding, TPP206).  Heuristics err toward
silence outside captured regions and are line-suppressible with
``# tpp: disable=TPPnnn``.
"""

from __future__ import annotations

import ast
import inspect
import os
import re
import textwrap
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Set, Tuple

from tpu_pipelines_torch.analysis.findings import (
    ERROR,
    WARN,
    Finding,
    suppressed_in_source,
)
from tpu_pipelines_torch.data.shard_plan import fork_unsafe_reason
from tpu_pipelines_torch.utils.fingerprint import stable_token

_HOST_SYNC_BUILTINS = {"float", "int", "bool"}
# Tensor methods that copy to the host and wait for the device.
_HOST_SYNC_METHODS = {"item", "cpu", "numpy", "tolist"}
# Dotted-call prefixes that bake a host-side value in at capture time.
_IMPURE_PREFIXES = (
    "time.time", "time.perf_counter", "time.monotonic",
    "random.", "np.random.", "numpy.random.",
)


# ---------------------------------------------------------- captured regions


def _dotted(node: ast.AST) -> str:
    """'torch.compile' for Attribute chains, 'f' for Names, '' otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_compile_expr(node: ast.AST) -> bool:
    """Does this expression denote ``torch.compile`` itself?"""
    name = _dotted(node)
    return name == "torch.compile" or name.endswith(".torch.compile")


def _compile_marked(deco: ast.AST) -> bool:
    """True for @torch.compile / @torch.compile(...) /
    @partial(torch.compile, ...)."""
    if _is_compile_expr(deco):
        return True
    if isinstance(deco, ast.Call):
        if _is_compile_expr(deco.func):
            return True
        if _dotted(deco.func).endswith("partial"):
            return any(_is_compile_expr(a) for a in deco.args)
    return False


def _is_graph_block(item: ast.withitem) -> bool:
    """``with torch.cuda.graph(g, ...):``"""
    expr = item.context_expr
    return isinstance(expr, ast.Call) and (
        _dotted(expr.func) in ("torch.cuda.graph", "cuda.graph")
    )


def _params(fn: ast.AST) -> Set[str]:
    args = fn.args
    return {
        a.arg
        for a in (
            list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
        )
    }


def _captured_callables(tree: ast.AST) -> Iterator[ast.AST]:
    """Expressions the source hands to a capture: ``train_loop``'s
    ``loss_fn``, ``make_graphed_callables``' callables and
    ``torch.compile``'s argument."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        callee = _dotted(node.func)
        if callee == "train_loop" or callee.endswith(".train_loop"):
            for kw in node.keywords:
                if kw.arg == "loss_fn":
                    yield kw.value
        elif callee.endswith("make_graphed_callables") and node.args:
            first = node.args[0]
            if isinstance(first, (ast.Tuple, ast.List)):
                yield from first.elts
            else:
                yield first
        elif _is_compile_expr(node.func):
            yield from node.args


def _regions(src: "_Source", fn: Optional[Callable]):
    """Yield (source, region node, param names) for every statically
    visible captured region of ``src``: captured defs and lambdas of its
    own tree, ``torch.cuda.graph`` blocks (params: the enclosing def's),
    and module-level functions a capture names that are defined outside
    the source, resolved through ``fn``'s globals."""
    tree = src.tree
    defs = {
        n.name: n for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }
    named: Set[str] = set()
    for expr in _captured_callables(tree):
        if isinstance(expr, ast.Lambda):
            yield src, expr, {a.arg for a in expr.args.args}
        elif isinstance(expr, ast.Name):
            named.add(expr.id)
    for node in defs.values():
        if node.name in named or any(
            _compile_marked(d) for d in node.decorator_list
        ):
            yield src, node, _params(node)
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for inner in ast.walk(node):
                if isinstance(inner, ast.With) and any(
                    _is_graph_block(i) for i in inner.items
                ):
                    yield src, inner, _params(node)
    globs = getattr(fn, "__globals__", None) or {}
    for name in sorted(named - set(defs)):
        target = globs.get(name)
        if not inspect.isfunction(target):
            continue
        other = _Source(target)
        if other.tree is None or not other.tree.body:
            continue
        top = other.tree.body[0]
        if isinstance(top, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield other, top, _params(top)


def _region_body(region: ast.AST):
    if isinstance(region, ast.Lambda):
        return [region.body]
    return region.body


# ------------------------------------------------------------ source loading


class _Source:
    """A callable's source + real file/line mapping, or None if unknown."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.file = ""
        self.start = 1
        self.lines: List[str] = []
        self.tree: Optional[ast.AST] = None
        try:
            self.file = inspect.getsourcefile(fn) or ""
            lines, start = inspect.getsourcelines(fn)
        except (OSError, TypeError):
            return
        self.start = start
        self.lines = lines
        try:
            self.tree = ast.parse(textwrap.dedent("".join(lines)))
        except SyntaxError:
            self.tree = None

    def line_of(self, node: ast.AST) -> int:
        return self.start + getattr(node, "lineno", 1) - 1

    def text_at(self, node: ast.AST) -> str:
        idx = getattr(node, "lineno", 1) - 1
        if 0 <= idx < len(self.lines):
            return self.lines[idx]
        return ""


def _finding(
    src: _Source, node: ast.AST, rule: str, severity: str, node_id: str,
    message: str, fix: str,
) -> Optional[Finding]:
    if suppressed_in_source(src.text_at(node), rule):
        return None
    return Finding(
        rule=rule, severity=severity, node_id=node_id, message=message,
        file=src.file, line=src.line_of(node), fix=fix,
    )


# ------------------------------------------------------------------- checks


def _check_capture_hazards(
    src: _Source, node_id: str, fn_label: str, fn: Optional[Callable]
) -> List[Finding]:
    out: List[Finding] = []
    for region_src, region, params in _regions(src, fn):
        region_name = getattr(region, "name", None) or (
            "<with torch.cuda.graph>" if isinstance(region, ast.With)
            else "<lambda>"
        )
        for stmt in _region_body(region):
            for node in ast.walk(stmt):
                f = _check_region_node(
                    region_src, node, params, node_id, fn_label, region_name
                )
                if f:
                    out.append(f)
    return out


def _check_region_node(
    src, node, params, node_id, fn_label, region_name
) -> Optional[Finding]:
    if isinstance(node, ast.Call):
        # TPP203: host sync, a tensor read back to the host (or a wait).
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _HOST_SYNC_METHODS
            and not node.args
        ):
            return _finding(
                src, node, "TPP203", ERROR, node_id,
                f"{fn_label}: .{node.func.attr}() inside captured "
                f"{region_name!r} forces a device->host sync (a CUDA-graph "
                "capture fails on it; torch.compile breaks the graph)",
                "return the tensor and read it outside the captured "
                "region (train_loop reads its metrics after the replay)",
            )
        dotted = _dotted(node.func)
        if dotted.endswith("cuda.synchronize"):
            return _finding(
                src, node, "TPP203", ERROR, node_id,
                f"{fn_label}: {dotted}() inside captured {region_name!r} "
                "waits on the device; a stream capture refuses it",
                "synchronize outside the captured region",
            )
        if (
            isinstance(node.func, ast.Name)
            and node.func.id in _HOST_SYNC_BUILTINS
            and node.args
            and not isinstance(node.args[0], ast.Constant)
        ):
            return _finding(
                src, node, "TPP203", ERROR, node_id,
                f"{fn_label}: {node.func.id}() on a tensor inside captured "
                f"{region_name!r} reads it back to the host (a sync the "
                "capture cannot record)",
                "keep values as tensors inside the region; convert outside",
            )
        # TPP204: impurity, host time or randomness baked in at capture.
        if dotted and any(
            dotted == p or dotted.startswith(p) for p in _IMPURE_PREFIXES
        ):
            return _finding(
                src, node, "TPP204", WARN, node_id,
                f"{fn_label}: {dotted}() inside captured {region_name!r} "
                "runs once at capture time, then is constant for every "
                "replay",
                "pass the value in as a tensor argument, or draw from a "
                "torch.Generator registered with the graph",
            )
    # TPP205: Python control flow on a tensor argument.
    if isinstance(node, (ast.If, ast.While)):
        names = {
            n.id for n in ast.walk(node.test) if isinstance(n, ast.Name)
        }
        hits = sorted(names & params)
        if hits:
            return _finding(
                src, node.test, "TPP205", WARN, node_id,
                f"{fn_label}: Python `{type(node).__name__.lower()}` on "
                f"argument(s) {hits} inside captured {region_name!r}; on a "
                "tensor it syncs the host (the capture fails), and on a "
                "static value the branch taken at capture is replayed "
                "every step",
                "use torch.where / masked arithmetic; keep genuinely "
                "static choices outside the captured region",
            )
    return None


def _check_map_shards_payload(
    src: _Source, node_id: str, fn_label: str, fn: Callable
) -> List[Finding]:
    """TPP202: payloads handed to map_shards must survive fork+pickle."""
    out: List[Finding] = []
    nested_defs = {
        n.name
        for n in ast.walk(src.tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call):
            continue
        callee = _dotted(node.func)
        if not (callee == "map_shards" or callee.endswith(".map_shards")):
            continue
        if not node.args:
            continue
        payload = node.args[0]
        if isinstance(payload, ast.Lambda):
            f = _finding(
                src, payload, "TPP202", ERROR, node_id,
                f"{fn_label}: lambda passed to map_shards cannot be "
                "pickled across the fork process pool",
                "hoist it to a module-level function taking plain-data "
                "args (the per-shard worker contract), or use thread_map",
            )
            if f:
                out.append(f)
        elif isinstance(payload, ast.Name):
            if payload.id in nested_defs:
                f = _finding(
                    src, payload, "TPP202", ERROR, node_id,
                    f"{fn_label}: nested function {payload.id!r} passed "
                    "to map_shards is not picklable (and its closure "
                    "rides into the fork)",
                    "hoist the worker to module level; pass captured "
                    "state as explicit plain-data task args",
                )
                if f:
                    out.append(f)
            else:
                out.extend(_check_resolved_payload(
                    src, payload, node_id, fn_label, fn
                ))
    return out


def _check_resolved_payload(
    src: _Source, payload: ast.Name, node_id: str, fn_label: str,
    fn: Callable,
) -> List[Finding]:
    """Resolve a module-level payload name and inspect its captured state
    (closure cells + defaults) for fork-unsafe values."""
    target = getattr(fn, "__globals__", {}).get(payload.id)
    if not callable(target):
        return []
    out = []
    for kind, name, value in _captured_state(target):
        reason = fork_unsafe_reason(value)
        if reason is None:
            continue
        f = _finding(
            src, payload, "TPP202", ERROR, node_id,
            f"{fn_label}: map_shards worker {payload.id!r} carries a "
            f"{reason} via {kind} {name!r}; it cannot cross the fork/"
            "pickle boundary (locks deadlock, handles alias, device "
            "tensors are invalid in the child)",
            "open handles / build device state inside the worker, per "
            "shard, instead of capturing it",
        )
        if f:
            out.append(f)
    return out


def _captured_state(fn: Callable):
    """(kind, name, value) for closure cells and argument defaults."""
    code = getattr(fn, "__code__", None)
    cells = getattr(fn, "__closure__", None) or ()
    names = getattr(code, "co_freevars", ()) if code else ()
    for name, cell in zip(names, cells):
        try:
            yield "closure cell", name, cell.cell_contents
        except ValueError:
            continue
    for i, value in enumerate(getattr(fn, "__defaults__", None) or ()):
        yield "default", f"arg[{-len(fn.__defaults__) + i}]", value
    for name, value in (getattr(fn, "__kwdefaults__", None) or {}).items():
        yield "default", name, value


# Per-iteration host/device traffic: exactly what the captured training
# window exists to remove.
_HOST_TRAFFIC_TAILS = {"cuda", "cpu", "numpy", "synchronize"}
_HOST_READ_DOTTED = {"np.asarray", "numpy.asarray"}
_TENSOR_FACTORIES = {"torch.tensor", "torch.as_tensor", "torch.from_numpy"}


def _moves_to_device(node: ast.Call) -> bool:
    """``x.to(device)`` / ``x.to("cuda")`` / ``x.to(..., device=...)``:
    a ``.to`` whose target is a device (not a dtype)."""
    if any(kw.arg == "device" for kw in node.keywords):
        return True
    if not node.args:
        return False
    first = node.args[0]
    if isinstance(first, ast.Constant) and isinstance(first.value, str):
        return first.value.split(":")[0] in ("cuda", "cpu")
    return "device" in _dotted(first).lower() or "dev" == _dotted(first)


def _host_traffic(node: ast.Call) -> str:
    """The dotted name of a per-step host/device transfer, '' if none."""
    dotted = _dotted(node.func)
    tail = dotted.rsplit(".", 1)[-1] if dotted else ""
    if isinstance(node.func, ast.Attribute) and node.func.attr == "to":
        return (dotted or ".to") if _moves_to_device(node) else ""
    if dotted in _TENSOR_FACTORIES:
        return dotted if any(
            kw.arg == "device" for kw in node.keywords
        ) else ""
    if tail in _HOST_TRAFFIC_TAILS or dotted in _HOST_READ_DOTTED:
        return dotted or tail
    if isinstance(node.func, ast.Attribute) and (
        node.func.attr in _HOST_TRAFFIC_TAILS
    ):
        return f".{node.func.attr}"
    return ""


def _window_steps_configured(tree: ast.AST) -> bool:
    """True when any TrainLoopConfig(...) call in the source pins
    ``window_steps`` to a static int > 1 (the statically-decidable case;
    dynamic values stay silent — heuristics err toward silence)."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if not _dotted(node.func).endswith("TrainLoopConfig"):
            continue
        for kw in node.keywords:
            if (
                kw.arg == "window_steps"
                and isinstance(kw.value, ast.Constant)
                and isinstance(kw.value.value, int)
                and kw.value.value > 1
            ):
                return True
    return False


def _check_window_host_traffic(
    src: _Source, node_id: str, fn_label: str
) -> List[Finding]:
    """TPP207: a hand-rolled per-step loop defeats the configured window.

    With ``window_steps > 1`` the framework loop stages the whole window
    on the card and replays its captured step; a ``.to(device)`` /
    ``torch.tensor(..., device=...)`` / ``.cpu()`` / synchronize inside a
    Python ``for``/``while`` body in the same source re-introduces the
    per-iteration host round-trip the window was configured to remove."""
    if not _window_steps_configured(src.tree):
        return []
    out: List[Finding] = []
    for loop in ast.walk(src.tree):
        if not isinstance(loop, (ast.For, ast.While)):
            continue
        for node in ast.walk(loop):
            if not isinstance(node, ast.Call):
                continue
            dotted = _host_traffic(node)
            if not dotted:
                continue
            f = _finding(
                src, node, "TPP207", WARN, node_id,
                f"{fn_label}: per-step {dotted}() inside a "
                f"`{type(loop).__name__.lower()}` loop body while "
                "TrainLoopConfig(window_steps>1) is configured — each "
                "iteration pays the host round-trip the window was meant "
                "to amortize",
                "feed batches through the framework train_loop (its "
                "windowed infeed stages the whole window on the card), or "
                "set window_steps=1 if per-step host access is intended",
            )
            if f:
                out.append(f)
    return out


# Static names that pin the attention sequence length in the same call /
# hparam dict as an attn_impl choice (BERT-style hp dicts use max_len).
_SEQ_KEYS = ("seq_len", "max_len", "max_seq_len")


def _const_str_pairs(node: ast.AST):
    """(key, value_node) pairs for call keywords and str-keyed dict
    literals — the two ways model configs spell attn_impl."""
    if isinstance(node, ast.Call):
        for kw in node.keywords:
            if kw.arg:
                yield kw.arg, kw.value
    elif isinstance(node, ast.Dict):
        for key, value in zip(node.keys, node.values):
            if isinstance(key, ast.Constant) and isinstance(key.value, str):
                yield key.value, value


def _check_flash_below_crossover(
    src: _Source, node_id: str, fn_label: str
) -> List[Finding]:
    """TPP208: attn_impl="flash" hard-coded where the COMMITTED autotune
    table says dense wins for the statically-known shape.

    Only fires when the sequence length is pinned to an int constant in
    the same call/dict as the attn_impl choice AND sits below every
    crossover in the repo-committed table (dense measured faster on every
    tuned device) — dynamic shapes and untuned devices stay silent.
    """
    try:
        from tpu_pipelines_torch.ops.autotune import committed_crossovers

        crossovers = committed_crossovers()
    except Exception:
        return []
    if not crossovers:
        return []
    floor = min(crossovers.values())
    kinds = ", ".join(sorted(crossovers))
    out: List[Finding] = []
    for node in ast.walk(src.tree):
        pairs = dict(_const_str_pairs(node))
        impl = pairs.get("attn_impl")
        if not (
            isinstance(impl, ast.Constant) and impl.value == "flash"
        ):
            continue
        seq = None
        for name in _SEQ_KEYS:
            val = pairs.get(name)
            if isinstance(val, ast.Constant) and isinstance(val.value, int):
                seq = val.value
                break
        if seq is None or seq >= floor:
            continue
        f = _finding(
            src, impl, "TPP208", WARN, node_id,
            f'{fn_label}: attn_impl="flash" hard-coded at statically-known '
            f"seq {seq}, below every committed autotune crossover (dense "
            f"attention measured faster up to {floor} on: {kinds})",
            'use attn_impl="auto" (measured crossover + OOM guard), or '
            "re-sweep on your device and commit the new table entry if "
            "flash genuinely wins at this shape",
        )
        if f:
            out.append(f)
    return out


# Source-level markers that the module already does per-host input
# assignment (the remedies TPP210 points at); their presence anywhere in
# the source silences the rule for the whole module.
_PER_HOST_INPUT_MARKERS = ("per_host_input_config", "assigned_shard_files")
# InputConfig keywords that pin an explicit per-host shard; a call
# carrying either is already sharded and stays silent.
_SHARD_KWARGS = {"shard_index", "num_shards"}


def _mesh_configured(tree: ast.AST) -> bool:
    """True when the source statically configures a multi-chip mesh: a
    ``make_mesh(...)`` call, or ``TrainLoopConfig(mesh_config=...)`` with
    anything but the constant None."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        if dotted == "make_mesh" or dotted.endswith(".make_mesh"):
            return True
        if dotted.endswith("TrainLoopConfig"):
            for kw in node.keywords:
                if kw.arg == "mesh_config" and not (
                    isinstance(kw.value, ast.Constant)
                    and kw.value.value is None
                ):
                    return True
    return False


def _check_mesh_unsharded_input(
    src: _Source, node_id: str, fn_label: str
) -> List[Finding]:
    """TPP210: a mesh is configured but every host iterates the full
    dataset.

    With a ``Mesh``/``mesh_config`` in play the code is written for
    multi-chip — but an ``InputConfig(...)`` with no ``shard_index``/
    ``num_shards`` (and no ``per_host_input_config`` /
    ``assigned_shard_files`` anywhere in the module) means every host
    decodes every row and drops all but 1/N of them: the silent
    multi-chip input tax.  Single-process runs are unaffected (the
    per-host helper is a no-op there), so the remedy costs nothing."""
    if not _mesh_configured(src.tree):
        return []
    mentioned = {
        n.id for n in ast.walk(src.tree) if isinstance(n, ast.Name)
    } | {
        n.attr for n in ast.walk(src.tree) if isinstance(n, ast.Attribute)
    }
    if mentioned & set(_PER_HOST_INPUT_MARKERS):
        return []
    out: List[Finding] = []
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        if not (dotted == "InputConfig" or dotted.endswith(".InputConfig")):
            continue
        if _SHARD_KWARGS & {kw.arg for kw in node.keywords}:
            continue
        f = _finding(
            src, node, "TPP210", WARN, node_id,
            f"{fn_label}: a mesh is configured but this InputConfig has "
            "no per-host shard (shard_index/num_shards) — every host "
            "decodes the full dataset and drops the rows it doesn't "
            "feed, the silent multi-chip input tax",
            "wrap the config in per_host_input_config(...) (derives the "
            "shard from the process topology; over a sharded "
            "Examples artifact each host then reads only its own shard "
            "files), or pin shard_index/num_shards explicitly",
        )
        if f:
            out.append(f)
    return out


# Keys whose presence in a serving call/config declares the payload
# autoregressive (decode geometry the predict path never takes).
_DECODE_KEYS = ("max_decode_len", "max_new_tokens", "beam_size")


def _check_whole_request_decode(
    src: _Source, node_id: str, fn_label: str
) -> List[Finding]:
    """TPP209: autoregressive decode geometry configured next to an
    explicit non-generative serving ``model_type``.

    A whole-request-batching endpoint serves a generation for its FULL
    decode before any co-batched request advances — one long generation
    pins its replica (a beam-4 generation against greedy ones).
    Fires only when one call / dict literal pins BOTH facts statically:
    ``model_type`` a string constant other than "generative" AND a decode
    key (``max_decode_len``/``max_new_tokens``/``beam_size``) an int
    constant.  Configs that omit model_type (training hparams, predict
    deployments) stay silent.
    """
    out: List[Finding] = []
    for node in ast.walk(src.tree):
        pairs = dict(_const_str_pairs(node))
        mt = pairs.get("model_type")
        if not (
            isinstance(mt, ast.Constant)
            and isinstance(mt.value, str)
            and mt.value != "generative"
        ):
            continue
        decode_key = None
        for name in _DECODE_KEYS:
            val = pairs.get(name)
            if isinstance(val, ast.Constant) and isinstance(val.value, int):
                decode_key = name
                break
        if decode_key is None:
            continue
        f = _finding(
            src, mt, "TPP209", WARN, node_id,
            f"{fn_label}: model_type={mt.value!r} with autoregressive "
            f"decode geometry ({decode_key}) — whole-request batching "
            "serves each generation to completion, so one long decode "
            "pins its replica and stalls every co-batched request",
            'set model_type="generative" (continuous batching: sequences '
            "join per decode step and leave at EOS; serving/generative.py, "
            "docs/SERVING.md)",
        )
        if f:
            out.append(f)
    return out


# Keys whose presence in a multi-replica serving config declares a health
# story: either an SLO the batcher can enforce (slo_p99_ms/_s) or an
# explicit supervisor knob.  Any one of them silences TPP212.
_SUPERVISION_KEYS = (
    "slo_p99_ms", "slo_p99_s",
    "supervisor_interval_s", "supervisor_queue_age_s",
    "supervisor_breaker_failures", "supervisor_breaker_open_s",
)


def _check_unsupervised_fleet(
    src: _Source, node_id: str, fn_label: str
) -> List[Finding]:
    """TPP212: a multi-replica serving fleet configured with no SLO and
    no supervision.

    ``replicas > 1`` buys redundancy only if something notices when a
    replica stops answering — otherwise the latency-aware router keeps
    offering traffic to a wedged or dead peer and the fleet degrades to
    "N-1 replicas plus a tarpit".  Fires when one call / dict literal
    pins ``replicas`` to an int constant above 1 and names neither an
    SLO (``slo_p99_ms``/``slo_p99_s``) nor any supervisor knob
    (``supervisor_*``) in the same mapping.  Single-replica configs and
    dynamic replica counts stay silent.
    """
    out: List[Finding] = []
    for node in ast.walk(src.tree):
        pairs = dict(_const_str_pairs(node))
        reps = pairs.get("replicas")
        if not (
            isinstance(reps, ast.Constant)
            and isinstance(reps.value, int)
            and reps.value > 1
        ):
            continue
        if any(name in pairs for name in _SUPERVISION_KEYS):
            continue
        f = _finding(
            src, reps, "TPP212", WARN, node_id,
            f"{fn_label}: replicas={reps.value} with no slo_p99_ms and no "
            "supervisor knobs — nothing detects a wedged or dead replica, "
            "so the router keeps offering it traffic and redundancy buys "
            "nothing",
            "set supervisor_interval_s (heartbeat + queue-age probes, "
            "circuit breaking, in-place rebuild; docs/SERVING.md "
            '"Self-healing fleet") or at least slo_p99_ms so queue-age '
            "wedge detection has a budget",
        )
        if f:
            out.append(f)
    return out


# Keys whose presence anywhere in the module declares a data-watch story
# for a deployed model: ExampleValidator's batch drift/skew comparators
# armed, or the serving tier's live monitoring plane sampling the stream
# (observability/drift.py).  Any one of them silences TPP215.
_DATA_WATCH_KEYS = (
    "drift_threshold", "drift_js_threshold",
    "skew_linf_threshold", "skew_js_threshold",
    "skew_feature_thresholds", "monitor_sample_rate",
)


def _mentions_key(tree: ast.AST, names) -> bool:
    """Like :func:`_mentions`, but for CONFIG keys: matches bare names,
    keyword arguments, and string constants (dict-literal keys and
    Parameter name strings all count as a mention)."""
    wanted = set(names)
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and node.id in wanted:
            return True
        if isinstance(node, ast.keyword) and node.arg in wanted:
            return True
        if (
            isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and node.value in wanted
        ):
            return True
    return False


def _check_unwatched_deploy(
    src: _Source, node_id: str, fn_label: str
) -> List[Finding]:
    """TPP215: a pipeline that deploys to a live fleet with no data
    watch.

    ``serving_push_url`` hot-reloads every blessed push into a serving
    fleet — from that moment live traffic is scored by a model whose
    training distribution nobody is comparing against.  Fires when one
    call / dict literal pins ``serving_push_url`` to a non-empty string
    constant and the module mentions neither an ExampleValidator drift/
    skew threshold nor a ``monitor_sample_rate`` knob.  Env-configured
    push URLs (TPP_SERVING_PUSH_URL) and watched deployments stay
    silent."""
    if _mentions_key(src.tree, _DATA_WATCH_KEYS):
        return []
    out: List[Finding] = []
    for node in ast.walk(src.tree):
        pairs = dict(_const_str_pairs(node))
        url = pairs.get("serving_push_url")
        if not (
            isinstance(url, ast.Constant)
            and isinstance(url.value, str)
            and url.value.strip()
        ):
            continue
        f = _finding(
            src, url, "TPP215", WARN, node_id,
            f"{fn_label}: serving_push_url deploys into a live fleet but "
            "the module arms neither ExampleValidator drift/skew "
            "thresholds nor monitor_sample_rate — a deployed model "
            "nobody is watching can rot for a full retrain cadence "
            "before anything notices",
            "arm ExampleValidator (drift_threshold / "
            "skew_linf_threshold vs the training baseline) or sample "
            "the live stream with ModelServer(monitor_sample_rate=...) "
            '(docs/OBSERVABILITY.md "Live drift & skew")',
        )
        if f:
            out.append(f)
    return out


# Source-level markers that the module shards parameters: the train loop's
# explicit spec tree or a model's (regex, PartitionSpec) rule list.  Their
# presence arms TPP213.
_PARTITION_MARKERS = ("param_partition", "partition_rules")
# dp_collective values that can honour a param partition: "fsdp" gathers /
# reduce-scatters the shards inside the scan window; "auto" resolves from
# TPP_DP_COLLECTIVE at run time so the pin is not static.
_FSDP_CAPABLE_MODES = {"fsdp", "auto"}


def _mentions(tree: ast.AST, names) -> bool:
    wanted = set(names)
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and node.id in wanted:
            return True
        if isinstance(node, ast.Attribute) and node.attr in wanted:
            return True
        if isinstance(node, ast.keyword) and node.arg in wanted:
            return True
        if (
            isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and node.value in wanted
        ):
            return True
    return False


def _check_pinned_dp_with_partition(
    src: _Source, node_id: str, fn_label: str
) -> List[Finding]:
    """TPP213: params are sharded but dp_collective is statically pinned
    to an explicit non-fsdp mode.

    A module that configures ``param_partition`` (or model
    ``partition_rules``) wants ZeRO-3-style sharded parameters — but
    ``dp_collective="psum_bucketed"`` / ``"ordered"`` keep a replicated
    copy of every param on every device and the train loop refuses the
    combination at startup.  Fires when any call / dict literal pins
    ``dp_collective`` to a string constant outside {"fsdp", "auto"} while
    either partition marker appears anywhere in the module.  ``None`` /
    ``"auto"`` (implicit GSPMD honours the specs) and ``"fsdp"`` stay
    silent, as do dynamic mode values: the reference's findings.  The
    port's implicit mode takes ``expert``, ``model`` and ``pipe`` specs
    (expert, tensor and pipeline parallelism) and refuses data-axis specs
    (they need ``"fsdp"``), which the loop says at startup."""
    if not _mentions(src.tree, _PARTITION_MARKERS):
        return []
    out: List[Finding] = []
    for node in ast.walk(src.tree):
        pairs = dict(_const_str_pairs(node))
        dp = pairs.get("dp_collective")
        if not (
            isinstance(dp, ast.Constant)
            and isinstance(dp.value, str)
            and dp.value not in _FSDP_CAPABLE_MODES
        ):
            continue
        f = _finding(
            src, dp, "TPP213", WARN, node_id,
            f"{fn_label}: dp_collective={dp.value!r} pinned next to "
            "param_partition/partition_rules — the explicit psum/ordered "
            "modes keep params replicated on every device, so the "
            "partition is never applied and the train loop rejects the "
            "pair at startup",
            'set dp_collective="fsdp" (shards params over the data axis, '
            "per-layer all-gather in the scan window, reduce-scatter "
            "grads) or leave it None/\"auto\" so implicit GSPMD honours "
            "the specs",
        )
        if f:
            out.append(f)
    return out


def _check_closure_staleness(
    src: _Source, node_id: str, fn_label: str, fn: Callable
) -> List[Finding]:
    """TPP201: fingerprint_callable hashes source + stably-encodable
    captured values.  A closure cell whose value has no stable encoding is
    invisible to the executor version hash — edit the captured config and
    yesterday's cached executions still hit."""
    out: List[Finding] = []
    for kind, name, value in _captured_state(fn):
        if kind != "closure cell":
            continue
        token, stable = stable_token(value)
        del token
        if stable:
            continue
        if suppressed_in_source(src.lines[0] if src.lines else "", "TPP201"):
            continue
        out.append(Finding(
            rule="TPP201", severity=WARN, node_id=node_id,
            message=(
                f"{fn_label}: closure captures {name!r} "
                f"({type(value).__name__}) with no stable encoding; the "
                "executor version hash cannot see changes to it, so "
                "cached executions go stale silently"
            ),
            file=src.file, line=src.start,
            fix="pass it through exec_properties (cache-keyed) or make "
                "it a JSON-native / stably-reprable value",
        ))
    return out


# ---------------------------------------------------------------- entrypoint


def check_callable(
    fn: Callable, node_id: str, label: str = ""
) -> List[Finding]:
    """All TPP2xx checks for one callable; silent when source is missing
    (builtins, C extensions — nothing static analysis can say)."""
    src = _Source(fn)
    label = label or getattr(fn, "__qualname__", repr(fn))
    out: List[Finding] = []
    out.extend(_check_closure_staleness(src, node_id, label, fn))
    if src.tree is None:
        return out
    out.extend(_check_capture_hazards(src, node_id, label, fn))
    out.extend(_check_map_shards_payload(src, node_id, label, fn))
    out.extend(_check_window_host_traffic(src, node_id, label))
    out.extend(_check_flash_below_crossover(src, node_id, label))
    out.extend(_check_whole_request_decode(src, node_id, label))
    out.extend(_check_unsupervised_fleet(src, node_id, label))
    out.extend(_check_unwatched_deploy(src, node_id, label))
    out.extend(_check_mesh_unsharded_input(src, node_id, label))
    out.extend(_check_pinned_dp_with_partition(src, node_id, label))
    return out


def check_component_code(comp: Any) -> List[Finding]:
    """TPP2xx findings for one Component: its executor plus every module-
    file entry point it declares via ``LINT_MODULE_FNS``."""
    out: List[Finding] = []
    cls = type(comp)
    executor = getattr(cls, "EXECUTOR", None)
    if executor is not None:
        out.extend(check_callable(executor, comp.id, f"executor {cls.__name__}"))
    module_file = comp.exec_properties.get("module_file")
    if isinstance(module_file, str) and module_file:
        for entry in getattr(cls, "LINT_MODULE_FNS", ()):
            out.extend(_check_module_entry(comp.id, module_file, entry))
    return out


def _check_module_entry(
    node_id: str, module_file: str, entry: str
) -> List[Finding]:
    from tpu_pipelines_torch.utils.module_loader import load_fn

    try:
        fn = load_fn(module_file, entry)
    except Exception as e:  # import error, missing attr, bad path
        return [Finding(
            rule="TPP206", severity=ERROR, node_id=node_id,
            message=(
                f"module entry point {entry!r} failed to load from "
                f"{module_file}: {type(e).__name__}: {e}"
            ),
            file=module_file,
            fix=f"the runner will fail at this node; fix {entry!r} in "
                "the module file before running",
        )]
    return check_callable(fn, node_id, f"{entry} ({module_file})")


# ------------------------------------------------- repo-level rules (TPP211)

# The port's own metric catalog: families only the port emits (its kernels'
# launch counters, its CUDA-graph accounting).  docs/ stays the shared
# catalog; both rules read this file beside it.
PORT_CATALOG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "METRICS.md"
)


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(PORT_CATALOG))


def _read_docs(paths: Sequence[str]) -> str:
    """The catalogs' text; a missing file reads as an empty catalog."""
    text = ""
    for path in paths:
        try:
            with open(path, "r", encoding="utf-8") as fh:
                text += fh.read()
        except OSError:
            pass
    return text


# A serving_decode_* time-series name as it appears in source: the full
# string constant is the metric name (not a substring of a longer message).
_DECODE_METRIC_RE = re.compile(r"serving_decode_[a-z0-9_]+\Z")


def check_serving_metric_docs(
    serving_dir: Optional[str] = None, doc_path: Optional[str] = None
) -> List[Finding]:
    """TPP211: every ``serving_decode_*`` metric name emitted under the
    port's ``serving/`` must be listed in ``docs/SERVING.md`` (or the
    port's own catalog, ``tpu_pipelines_torch/METRICS.md``).

    The decode metric catalog in the serving doc is the operator contract —
    dashboards and the SLO monitor (``observability/slo.py``) are built from
    it, so a series that ships undocumented is invisible to both.  This is a
    repo-level check (no pipeline or callable in hand): it AST-walks every
    ``.py`` under ``serving_dir`` collecting string constants that *are* a
    ``serving_decode_*`` name and flags any absent from the doc text.

    Defaults resolve against the installed package: ``serving_dir`` is the
    ``tpu_pipelines_torch/serving`` package directory and the catalogs are
    ``docs/SERVING.md`` beside the package root and the port's
    ``METRICS.md``; a ``doc_path`` given reads that file alone, so tests
    can point both at tmp fixtures.  A missing doc
    file is treated as an empty catalog (everything flags), not an error.
    Per-line suppression works as for every code rule:
    ``# tpp: disable=TPP211``.
    """
    if serving_dir is None:
        serving_dir = os.path.join(os.path.dirname(PORT_CATALOG), "serving")
    doc_text = _read_docs(
        [doc_path] if doc_path is not None
        else [os.path.join(_repo_root(), "docs", "SERVING.md"), PORT_CATALOG]
    )

    out: List[Finding] = []
    for dirpath, _dirnames, filenames in sorted(os.walk(serving_dir)):
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    source = fh.read()
                tree = ast.parse(source)
            except (OSError, SyntaxError):
                continue
            lines = source.splitlines()
            seen_here: Set[str] = set()
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Constant)
                        and isinstance(node.value, str)):
                    continue
                name = node.value
                if not _DECODE_METRIC_RE.match(name):
                    continue
                if name in doc_text or name in seen_here:
                    continue
                line_no = getattr(node, "lineno", 0)
                text = lines[line_no - 1] if 0 < line_no <= len(lines) else ""
                if suppressed_in_source(text, "TPP211"):
                    continue
                seen_here.add(name)
                out.append(Finding(
                    rule="TPP211", severity=WARN,
                    node_id="<serving>",
                    message=(
                        f"metric {name!r} is emitted here but not listed "
                        "in docs/SERVING.md — the decode metric catalog "
                        "is the operator contract; an undocumented "
                        "series is invisible to dashboards and the SLO "
                        "monitor"
                    ),
                    file=path, line=line_no,
                    fix=f"add {name!r} to the metric catalog table in "
                        "docs/SERVING.md (name, type, labels, meaning)",
                ))
    return out


# ------------------------------------------------- repo-level rules (TPP214)

# Any Prometheus-suffixed metric-name constant anywhere in the package:
# the TPP211 contract (emitted series must have a catalog row) applied
# repo-wide.  The unit suffixes are the signal — ``*_total`` counters,
# ``*_seconds``/``*_bytes`` gauges and histograms are metric names by
# this repo's own naming convention; bare words like ``"total"`` don't
# match (a prefix is required).
_METRIC_NAME_RE = re.compile(r"[a-z][a-z0-9_]*_(total|seconds|bytes)\Z")


def check_metric_docs(
    package_dir: Optional[str] = None,
    doc_paths: Optional[List[str]] = None,
) -> List[Finding]:
    """TPP214: every metric-name string constant under
    ``tpu_pipelines_torch/`` (``*_total`` / ``*_seconds`` / ``*_bytes``)
    must appear in one of the metric catalogs (``docs/OBSERVABILITY.md``,
    ``docs/SERVING.md``, or the port's own ``METRICS.md`` for families
    only the port emits).

    The repo-wide generalization of TPP211: the serving decode catalog
    turned out to be the only metric surface the lint protected, while
    trainer, runner, data-plane, continuous, and federation families
    shipped unchecked.  Same mechanics — AST string constants matched
    against doc text, per-line ``# tpp: disable=TPP214`` suppression,
    one finding per name per file — but scanning the whole package
    against BOTH docs, so a telemetry family added anywhere without its
    operator-contract row fails the same ``lint`` gate.

    Defaults resolve against the port's package root, its sibling
    ``docs/`` and its ``METRICS.md``; tests point both at tmp fixtures.  Missing doc files read
    as empty catalogs (everything flags), not as errors.
    """
    if package_dir is None:
        package_dir = os.path.dirname(PORT_CATALOG)
    if doc_paths is None:
        doc_paths = [
            os.path.join(_repo_root(), "docs", "OBSERVABILITY.md"),
            os.path.join(_repo_root(), "docs", "SERVING.md"),
            PORT_CATALOG,
        ]
    doc_text = _read_docs(doc_paths)

    out: List[Finding] = []
    for dirpath, _dirnames, filenames in sorted(os.walk(package_dir)):
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    source = fh.read()
                tree = ast.parse(source)
            except (OSError, SyntaxError):
                continue
            lines = source.splitlines()
            seen_here: Set[str] = set()
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Constant)
                        and isinstance(node.value, str)):
                    continue
                name = node.value
                if not _METRIC_NAME_RE.match(name):
                    continue
                if name in doc_text or name in seen_here:
                    continue
                line_no = getattr(node, "lineno", 0)
                text = lines[line_no - 1] if 0 < line_no <= len(lines) else ""
                if suppressed_in_source(text, "TPP214"):
                    continue
                seen_here.add(name)
                out.append(Finding(
                    rule="TPP214", severity=WARN,
                    node_id="<repo>",
                    message=(
                        f"metric-shaped name {name!r} is emitted here but "
                        "listed in none of docs/OBSERVABILITY.md, "
                        "docs/SERVING.md or the port's METRICS.md — the "
                        "metric catalogs are the operator contract; an "
                        "undocumented series is invisible to dashboards "
                        "and alerts"
                    ),
                    file=path, line=line_no,
                    fix=f"add {name!r} to the catalog in docs/"
                        "OBSERVABILITY.md (docs/SERVING.md for serving "
                        "families; tpu_pipelines_torch/METRICS.md for a "
                        "family only the port emits), or suppress a "
                        "non-metric string with "
                        "# tpp: disable=TPP214",
                ))
    return out
