"""The port's components, each its copy of the ``tpu_pipelines/components``
counterpart: the taxi DAG's ExampleGen -> StatisticsGen -> SchemaGen ->
ExampleValidator -> Transform -> Trainer -> Evaluator -> InfraValidator ->
Pusher, the T5 DAG's BulkInferrer, the retrain DAG's ImportExampleGen,
Importer, Resolver and RollingWindowResolver (``Cond`` is in ``dsl``), and
the search and rewrite stages, Tuner and Rewriter."""

from tpu_pipelines_torch.components.example_gen import (  # noqa: F401
    CsvExampleGen,
    ImportExampleGen,
)
from tpu_pipelines_torch.components.statistics_gen import StatisticsGen  # noqa: F401
from tpu_pipelines_torch.components.schema_gen import SchemaGen  # noqa: F401
from tpu_pipelines_torch.components.example_validator import ExampleValidator  # noqa: F401
from tpu_pipelines_torch.components.transform import Transform  # noqa: F401
from tpu_pipelines_torch.components.trainer import Trainer  # noqa: F401
from tpu_pipelines_torch.components.evaluator import Evaluator  # noqa: F401
from tpu_pipelines_torch.components.infra_validator import InfraValidator  # noqa: F401
from tpu_pipelines_torch.components.pusher import Pusher  # noqa: F401
from tpu_pipelines_torch.components.bulk_inferrer import BulkInferrer  # noqa: F401
from tpu_pipelines_torch.components.importer import Importer  # noqa: F401
from tpu_pipelines_torch.components.resolver import (  # noqa: F401
    Resolver,
    RollingWindowResolver,
)
from tpu_pipelines_torch.components.tuner import Tuner  # noqa: F401
from tpu_pipelines_torch.components.rewriter import Rewriter  # noqa: F401
