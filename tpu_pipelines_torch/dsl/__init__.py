"""Pipeline DSL: artifact types, channels, components, pipeline, compiler.

The port's copy of ``tpu_pipelines/dsl``: a ``Component`` is a typed spec
(inputs / outputs / exec-properties) plus an executor function; a
``Pipeline`` wires components through ``Channel``s; the compiler lowers the
DSL to the JSON-serializable IR that the runner executes.
"""

from tpu_pipelines_torch.dsl.artifact_types import ARTIFACT_TYPES, standard_artifacts  # noqa: F401
from tpu_pipelines_torch.dsl.component import (  # noqa: F401
    Channel,
    Component,
    ComponentSpec,
    ExecutorContext,
    Parameter,
    RuntimeParameter,
)
from tpu_pipelines_torch.dsl.pipeline import Pipeline  # noqa: F401
from tpu_pipelines_torch.dsl.compiler import Compiler, PipelineIR  # noqa: F401
from tpu_pipelines_torch.dsl.cond import Cond  # noqa: F401
