"""The port's components, each its copy of the ``tpu_pipelines/components``
counterpart: the taxi DAG's ExampleGen -> StatisticsGen -> SchemaGen ->
ExampleValidator -> Transform -> Trainer -> Evaluator -> InfraValidator ->
Pusher, and the T5 DAG's BulkInferrer.  Tuner and Rewriter (``ROADMAP.md``
A9), and Resolver, Importer, ImportExampleGen and Cond (A18) are not ported
yet."""

from tpu_pipelines_torch.components.example_gen import CsvExampleGen  # noqa: F401
from tpu_pipelines_torch.components.statistics_gen import StatisticsGen  # noqa: F401
from tpu_pipelines_torch.components.schema_gen import SchemaGen  # noqa: F401
from tpu_pipelines_torch.components.example_validator import ExampleValidator  # noqa: F401
from tpu_pipelines_torch.components.transform import Transform  # noqa: F401
from tpu_pipelines_torch.components.trainer import Trainer  # noqa: F401
from tpu_pipelines_torch.components.evaluator import Evaluator  # noqa: F401
from tpu_pipelines_torch.components.infra_validator import InfraValidator  # noqa: F401
from tpu_pipelines_torch.components.pusher import Pusher  # noqa: F401
from tpu_pipelines_torch.components.bulk_inferrer import BulkInferrer  # noqa: F401
