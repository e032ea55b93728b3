"""Component model: spec + executor, wired by typed channels.

The port's copy of ``tpu_pipelines/dsl/component.py``.  ``resource_class``
keeps the reference's spelling, ``host`` or ``tpu``, so a compiled IR reads
the same in both packages: here ``tpu`` means "holds the accelerator" (the
GPU), and the runner admits one such node at a time.  Conditions
(``dsl/cond.py``) and lint suppressions wait (``ROADMAP.md`` A18, A20).

A component is (1) a declarative spec — typed input/output channels and
exec-properties — and (2) an executor function invoked by a runner's launcher
with resolved artifacts.  This mirrors the TFX component = spec + driver +
executor split (SURVEY.md §2a); the driver half (input resolution, caching)
lives in the orchestrator.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Type

from tpu_pipelines_torch.dsl.artifact_types import ARTIFACT_TYPES
from tpu_pipelines_torch.metadata.types import Artifact


class Channel:
    """A typed edge: references a producer component's output key.

    Channels are how the Pipeline discovers the DAG — no explicit edge list;
    dependency = consuming another component's output channel, exactly like
    TFX's ``Channel``/artifact-query model.
    """

    def __init__(
        self,
        type_name: str,
        producer: Optional["Component"] = None,
        output_key: str = "",
    ):
        if type_name not in ARTIFACT_TYPES:
            raise ValueError(f"Unknown artifact type: {type_name!r}")
        self.type_name = type_name
        self.producer = producer
        self.output_key = output_key

    def __repr__(self) -> str:
        src = (
            f"{self.producer.id}.{self.output_key}" if self.producer else "<external>"
        )
        return f"Channel({self.type_name} from {src})"


@dataclasses.dataclass
class Parameter:
    """Declared exec-property: type-checked, defaultable."""

    type: type = object
    default: Any = None
    required: bool = False


class RuntimeParameter:
    """Deploy-time placeholder substituted by the runner at run start.

    Equivalent of TFX's ``RuntimeParameter`` (SURVEY.md §5 config system):
    the compiled IR stores the placeholder; ``Runner.run(...,
    runtime_parameters={name: value})`` substitutes it.
    """

    def __init__(self, name: str, default: Any = None):
        self.name = name
        self.default = default

    def __repr__(self) -> str:
        return f"RuntimeParameter({self.name!r}, default={self.default!r})"


@dataclasses.dataclass
class ComponentSpec:
    inputs: Dict[str, str] = dataclasses.field(default_factory=dict)    # key -> artifact type
    outputs: Dict[str, str] = dataclasses.field(default_factory=dict)   # key -> artifact type
    parameters: Dict[str, Parameter] = dataclasses.field(default_factory=dict)
    # Input keys that may be left unwired (e.g. Trainer without a Transform).
    optional_inputs: tuple = ()


@dataclasses.dataclass
class ExecutorContext:
    """Everything an executor sees: resolved artifacts + properties.

    ``inputs``/``outputs`` map spec keys to artifact lists; output artifact
    uris are pre-allocated directories the executor writes into.  ``extras``
    carries runner-provided handles (mesh config, metadata store for
    sub-lineage, tmp dir).
    """

    node_id: str
    inputs: Dict[str, List[Artifact]]
    outputs: Dict[str, List[Artifact]]
    exec_properties: Dict[str, Any]
    tmp_dir: str = ""
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def input(self, key: str) -> Artifact:
        arts = self.inputs.get(key) or []
        if not arts:
            raise KeyError(f"{self.node_id}: no input artifact for {key!r}")
        return arts[0]

    def output(self, key: str) -> Artifact:
        arts = self.outputs.get(key) or []
        if not arts:
            raise KeyError(f"{self.node_id}: no output artifact for {key!r}")
        return arts[0]


# Executor: a plain callable.  Returning a dict merges those entries into the
# execution's recorded properties (e.g. examples/sec from the Trainer).
ExecutorFn = Callable[[ExecutorContext], Optional[Dict[str, Any]]]


def _coerce_retry_policy(value, owner: str):
    """Normalize a RetryPolicy | dict | None into a RetryPolicy (or None).

    Lives here so the DSL accepts the ergonomic forms while the IR always
    carries one canonical shape; a bad value fails at authoring time, not
    minutes into a run.
    """
    if value is None:
        return None
    from tpu_pipelines_torch.robustness import RetryPolicy

    if isinstance(value, RetryPolicy):
        return value
    if isinstance(value, dict):
        try:
            return RetryPolicy(**value) if value else None
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"{owner}: invalid retry_policy {value!r}: {e}"
            ) from e
    raise TypeError(
        f"{owner}: retry_policy must be a RetryPolicy or dict, got "
        f"{type(value).__name__}"
    )


class Component:
    """Base class for pipeline nodes.

    Subclasses declare ``SPEC`` and ``EXECUTOR``; instances are constructed
    with channels for spec inputs and values for spec parameters::

        stats = StatisticsGen(examples=example_gen.outputs["examples"])

    Instances expose ``.outputs[key]`` channels for downstream wiring.
    """

    SPEC: ComponentSpec = ComponentSpec()
    EXECUTOR: Optional[ExecutorFn] = None
    # Bump or override to invalidate cached executions when semantics change
    # in ways source-hashing can't see (e.g. data format revision).
    CACHE_SALT: str = ""
    # Scheduler resource class: "host" components (data/metadata plane) may
    # overlap freely under the concurrent runner; "tpu" components hold the
    # accelerator (the GPU in this port), so at most one executes at a time.
    RESOURCE_CLASS: str = "host"
    # Exec-property keys whose values are *external* filesystem paths (data
    # the pipeline ingests but no upstream node produced).  The driver
    # fingerprints the referenced content into the cache key, so editing the
    # file invalidates the cache even though the path string is unchanged —
    # the equivalent of TFX ExampleGen's input-fingerprint/span mechanism.
    EXTERNAL_INPUT_PARAMETERS: tuple = ()
    # Execution deadline in seconds (0 = none).  The deadline covers the
    # node's whole launcher phase — all retry attempts included — so a hung
    # executor cannot stall the run forever.  Precedence: this component
    # override > Pipeline(node_timeout_s=...) > env TPP_NODE_TIMEOUT_S.
    # Locally a scheduler watchdog enforces it; on the cluster it maps to
    # activeDeadlineSeconds (Argo template / JobSet job).
    EXECUTION_TIMEOUT_S: float = 0.0
    # Declared side effect: the node's value is what it DOES (push a model,
    # gate a blessing, write external predictions), not the artifacts it
    # emits — so the TPP101 dead-end lint rule must not flag its unconsumed
    # outputs.  Pusher/validators/BulkInferrer/Evaluator set this.
    IS_SINK: bool = False
    # Lint rule ids suppressed for every instance of this component
    # (per-instance: .with_lint_suppressions("TPP103")).  Compiled into
    # NodeIR.lint_suppress; see docs/ANALYSIS.md.
    LINT_SUPPRESS: tuple = ()
    # Per-node retry policy (tpu_pipelines_torch.robustness.RetryPolicy or its
    # dict form; None = fall back to the pipeline default, then env
    # TPP_RETRY_*).  Covers the node's executor attempts with classified
    # (transient-only) retries, exponential backoff + full jitter, and an
    # optional total budget.  Locally the runner's launcher loop enforces
    # it; on the cluster it maps to Argo retryStrategy / JobSet restarts.
    # Like deadlines, it is operational metadata: excluded from the DAG
    # fingerprint, so tuning retries never blocks resume_from.
    RETRY_POLICY = None
    # Module-file entry points the Layer-2 analyzer walks in addition to
    # EXECUTOR: names loaded from exec_properties["module_file"] at run
    # time (Trainer: run_fn; Transform: preprocessing_fn).
    LINT_MODULE_FNS: tuple = ()

    def __init__(self, instance_name: str = "", **kwargs: Any):
        cls = type(self)
        self.id = instance_name or cls.__name__
        self.input_channels: Dict[str, List[Channel]] = {}
        self.exec_properties: Dict[str, Any] = {}
        self.execution_timeout_s = float(cls.EXECUTION_TIMEOUT_S or 0.0)
        self.lint_suppress: List[str] = [str(r) for r in cls.LINT_SUPPRESS]
        self.retry_policy = _coerce_retry_policy(cls.RETRY_POLICY, self.id)

        for key, value in kwargs.items():
            # A key may name both an input and a parameter (e.g. Trainer's
            # `hyperparameters`: Tuner artifact OR literal dict); the value
            # type disambiguates.
            looks_like_channel = isinstance(value, Channel) or (
                isinstance(value, list)
                and value
                and all(isinstance(v, Channel) for v in value)
            )
            if key in self.SPEC.inputs and (
                looks_like_channel or key not in self.SPEC.parameters
            ):
                chans = value if isinstance(value, list) else [value]
                for ch in chans:
                    if not isinstance(ch, Channel):
                        raise TypeError(
                            f"{self.id}: input {key!r} must be a Channel, got "
                            f"{type(ch).__name__}"
                        )
                    expected = self.SPEC.inputs[key]
                    if ch.type_name != expected:
                        raise TypeError(
                            f"{self.id}: input {key!r} expects artifact type "
                            f"{expected}, got {ch.type_name}"
                        )
                self.input_channels[key] = chans
            elif key in self.SPEC.parameters:
                self.exec_properties[key] = value
            else:
                raise TypeError(f"{self.id}: unknown argument {key!r}")

        for key, param in self.SPEC.parameters.items():
            if key not in self.exec_properties:
                if param.required:
                    raise TypeError(f"{self.id}: missing required parameter {key!r}")
                self.exec_properties[key] = param.default

        missing = [
            k for k in self.SPEC.inputs
            if k not in self.input_channels and k not in self.SPEC.optional_inputs
        ]
        if missing:
            raise TypeError(f"{self.id}: missing required inputs {missing}")

        self.outputs: Dict[str, Channel] = {
            key: Channel(type_name, producer=self, output_key=key)
            for key, type_name in self.SPEC.outputs.items()
        }

        # Conditions from `with Cond(...)` blocks wait (dsl/cond.py raises).
        self.conditions: List[Any] = []

    @property
    def upstream(self) -> List["Component"]:
        deps = []
        for chans in self.input_channels.values():
            for ch in chans:
                if ch.producer is not None:
                    deps.append(ch.producer)
        # Predicate channels are dependencies too: the producer must have
        # run (and published properties) before the condition is evaluated.
        for pred in self.conditions:
            ch = getattr(pred, "channel", None)
            if ch is not None and ch.producer is not None:
                deps.append(ch.producer)
        return deps

    def with_id(self, instance_name: str) -> "Component":
        self.id = instance_name
        return self

    def with_execution_timeout(self, seconds: float) -> "Component":
        """Per-instance deadline override (chainable, like ``with_id``)."""
        if seconds < 0:
            raise ValueError(
                f"{self.id}: execution timeout must be >= 0, got {seconds}"
            )
        self.execution_timeout_s = float(seconds)
        return self

    def with_retry_policy(self, policy=None, **kwargs: Any) -> "Component":
        """Per-instance retry policy override (chainable, like
        ``with_execution_timeout``).

        Pass a :class:`~tpu_pipelines_torch.robustness.RetryPolicy`, its dict
        form, or bare fields::

            trainer.with_retry_policy(max_attempts=3, base_delay_s=1.0)

        ``None`` with no fields clears the override back to the pipeline/
        env default.
        """
        if policy is not None and kwargs:
            raise ValueError(
                f"{self.id}: pass a policy object OR field overrides, "
                "not both"
            )
        self.retry_policy = _coerce_retry_policy(
            kwargs if kwargs else policy, self.id
        )
        return self

    def with_lint_suppressions(self, *rules: str) -> "Component":
        """Suppress analyzer rules for THIS node (chainable).

        ``rules`` are catalog ids ("TPP103"); unknown ids raise so a typo
        cannot silently disable nothing.  Suppressions compile into the IR
        and apply to both graph (TPP1xx) and code (TPP2xx) findings.
        """
        raise NotImplementedError(
            f"{self.id}: lint suppressions wait for the port's analyzer "
            f"(ROADMAP.md A20); asked for {rules}"
        )

    def __repr__(self) -> str:
        return f"{type(self).__name__}(id={self.id!r})"


def component(
    inputs: Optional[Dict[str, str]] = None,
    outputs: Optional[Dict[str, str]] = None,
    parameters: Optional[Dict[str, Parameter]] = None,
    name: Optional[str] = None,
    external_input_parameters: tuple = (),
    optional_inputs: tuple = (),
    resource_class: str = "host",
    execution_timeout_s: float = 0.0,
    is_sink: bool = False,
    lint_module_fns: tuple = (),
    retry_policy=None,
) -> Callable[[ExecutorFn], Type[Component]]:
    """Decorator: build a Component subclass from a bare executor function.

    ::

        @component(inputs={"examples": "Examples"},
                   outputs={"statistics": "ExampleStatistics"})
        def StatisticsGen(ctx):
            ...
    """

    def wrap(fn: ExecutorFn) -> Type[Component]:
        cls_name = name or fn.__name__
        if resource_class not in ("host", "tpu"):
            raise ValueError(
                f"{cls_name}: resource_class must be 'host' or 'tpu', "
                f"got {resource_class!r}"
            )
        spec = ComponentSpec(
            inputs=dict(inputs or {}),
            outputs=dict(outputs or {}),
            parameters=dict(parameters or {}),
            optional_inputs=tuple(optional_inputs),
        )
        return type(
            cls_name,
            (Component,),
            {
                "SPEC": spec,
                "EXECUTOR": staticmethod(fn),
                "__doc__": fn.__doc__,
                "EXTERNAL_INPUT_PARAMETERS": tuple(external_input_parameters),
                "RESOURCE_CLASS": resource_class,
                "EXECUTION_TIMEOUT_S": float(execution_timeout_s),
                "IS_SINK": bool(is_sink),
                "LINT_MODULE_FNS": tuple(lint_module_fns),
                "RETRY_POLICY": _coerce_retry_policy(retry_policy, cls_name),
            },
        )

    return wrap
