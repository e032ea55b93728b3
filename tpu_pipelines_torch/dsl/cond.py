"""Conditional execution: TFX ``tfx.dsl.Cond`` equivalent.

The port's copy of ``tpu_pipelines/dsl/cond.py``.  Components constructed
inside a ``with Cond(predicate):`` block only execute when the predicate
holds at runtime; otherwise the runner marks them ``COND_SKIPPED`` (not
failed — the run still succeeds) and every downstream consumer of their
outputs cascade-skips the same way.

Predicates are declarative and compile into the IR (no Python callbacks at
runtime), in the reference's JSON:

::

    from tpu_pipelines_torch.dsl.cond import Cond, artifact_property, runtime_parameter

    # Deploy-gated push: only when the run was started with deploy=true.
    with Cond(runtime_parameter("deploy", default=False) == True):  # noqa: E712
        pusher = Pusher(model=..., blessing=...)

    # Property-gated: push only high-accuracy models (beyond the blessing).
    with Cond(artifact_property(
        evaluator.outputs["evaluation"], "overall_metrics.accuracy") >= 0.9):
        pusher = Pusher(...)

``artifact_property`` references an upstream output channel; the producer
becomes a dependency of every conditional node, so the property exists by
the time the predicate is evaluated.  Dotted property paths traverse
nested dicts.  Conditions nest (inner blocks AND with outer ones).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

_OPS = {
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
    "gt": lambda a, b: a is not None and a > b,
    "ge": lambda a, b: a is not None and a >= b,
    "lt": lambda a, b: a is not None and a < b,
    "le": lambda a, b: a is not None and a <= b,
}


@dataclasses.dataclass
class Predicate:
    """One comparison; ``kind`` is "artifact_property" (channel + dotted
    property path) or "runtime_parameter" (name + default)."""

    kind: str
    op: str
    value: Any
    # artifact_property:
    channel: Any = None          # dsl Channel (compile-time only)
    prop: str = ""
    # runtime_parameter:
    param: str = ""
    default: Any = None

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"kind": self.kind, "op": self.op,
                             "value": self.value}
        if self.kind == "artifact_property":
            d["producer"] = self.channel.producer.id
            d["output_key"] = self.channel.output_key
            d["prop"] = self.prop
        else:
            d["param"] = self.param
            d["default"] = self.default
        return d

    def __bool__(self) -> bool:
        # Chained comparisons (`0.5 <= ref <= 0.9`) would silently AND
        # through truthiness and drop the first predicate; make the misuse
        # loud instead (the SQLAlchemy/numpy comparison-builder guard).
        raise TypeError(
            "a Cond predicate has no truth value; chained comparisons like "
            "`lo <= artifact_property(...) <= hi` are not supported — nest "
            "two Cond blocks (or two predicates) instead"
        )


class _Comparable:
    """Builder half of a predicate; comparison operators finish it."""

    def _make(self, op: str, value: Any) -> Predicate:
        raise NotImplementedError

    def __eq__(self, other):  # noqa: D105 — intentional predicate builder
        return self._make("eq", other)

    def __ne__(self, other):
        return self._make("ne", other)

    def __gt__(self, other):
        return self._make("gt", other)

    def __ge__(self, other):
        return self._make("ge", other)

    def __lt__(self, other):
        return self._make("lt", other)

    def __le__(self, other):
        return self._make("le", other)

    __hash__ = None  # comparisons build predicates; not a hashable value


class _PropertyRef(_Comparable):
    def __init__(self, channel, prop: str):
        self.channel = channel
        self.prop = prop

    def _make(self, op: str, value: Any) -> Predicate:
        return Predicate(
            kind="artifact_property", op=op, value=value,
            channel=self.channel, prop=self.prop,
        )


class _ParamRef(_Comparable):
    def __init__(self, param: str, default: Any = None):
        self.param = param
        self.default = default

    def _make(self, op: str, value: Any) -> Predicate:
        return Predicate(
            kind="runtime_parameter", op=op, value=value,
            param=self.param, default=self.default,
        )


def artifact_property(channel, prop: str) -> _PropertyRef:
    """Reference an output artifact's property for a Cond predicate;
    ``prop`` may be a dotted path into nested dict properties.  The channel
    must have a producer component — the predicate is evaluated against the
    producer's published outputs."""
    if getattr(channel, "producer", None) is None:
        raise ValueError(
            "artifact_property requires a channel with a producer component "
            "(e.g. some_node.outputs['key']); a producer-less channel has no "
            "published properties to evaluate"
        )
    return _PropertyRef(channel, prop)


def runtime_parameter(name: str, default: Any = None) -> _ParamRef:
    """Reference a runtime parameter for a Cond predicate."""
    return _ParamRef(name, default)


_ACTIVE: List["Cond"] = []


class Cond:
    def __init__(self, predicate: Predicate):
        if not isinstance(predicate, Predicate):
            raise TypeError(
                "Cond expects a predicate built from artifact_property()/"
                f"runtime_parameter() comparisons, got {type(predicate).__name__}"
            )
        self.predicate = predicate

    def __enter__(self) -> "Cond":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.pop()


def active_predicates() -> List[Predicate]:
    """Predicates of every open Cond block (outermost first) — captured by
    Component.__init__ for nodes constructed inside the blocks."""
    return [c.predicate for c in _ACTIVE]


def _dotted(d: Any, path: str) -> Any:
    cur = d
    for part in path.split("."):
        if not isinstance(cur, dict):
            return None
        cur = cur.get(part)
    return cur


class ConditionUnresolvedError(RuntimeError):
    """The predicate's producer has no published outputs at all.

    Distinct from an unmet predicate: when the producer never executed —
    e.g. a partial run whose range excludes it and left no history —
    silently reporting the gated node as COND_SKIPPED would mask a
    configuration mistake as a legitimately unmet condition.  The runner
    surfaces this as a node FAILURE instead."""


def evaluate_condition(
    cond: Dict[str, Any],
    produced: Dict[str, Dict[str, List[Any]]],
    runtime_parameters: Dict[str, Any],
) -> bool:
    """Evaluate one serialized predicate against this run's state.

    Raises :class:`ConditionUnresolvedError` when the predicate reads an
    artifact property but the producer has no published outputs for the
    key — 'never ran' must not be conflated with 'ran and the property
    does not satisfy the predicate' (which returns False)."""
    op = _OPS[cond["op"]]
    if cond["kind"] == "runtime_parameter":
        actual = runtime_parameters.get(cond["param"], cond.get("default"))
        return bool(op(actual, cond["value"]))
    outputs = produced.get(cond["producer"])
    if not outputs or cond["output_key"] not in outputs:
        # The producer never published AT ALL (the output key is absent,
        # not merely empty): a configuration mistake, not an unmet
        # condition.
        raise ConditionUnresolvedError(
            f"condition on {cond['producer']}.{cond['output_key']}"
            f".{cond['prop']} cannot be evaluated: the producer has no "
            "published outputs in this run or any prior run. In a partial "
            "run, include the producer in the node selection (or run the "
            "full pipeline once first)."
        )
    arts = outputs[cond["output_key"]] or []
    if not arts:
        # The producer RAN and published an empty output list (a Resolver
        # that found nothing, e.g. no blessed model yet): a legitimately
        # unmet condition — skip, don't fail.
        return False
    actual = _dotted(arts[0].properties, cond["prop"])
    return bool(op(actual, cond["value"]))
