"""The canonical components of the taxi DAG, each the port's copy of its
``tpu_pipelines/components`` counterpart: ExampleGen -> StatisticsGen ->
SchemaGen -> ExampleValidator -> Transform -> Trainer -> Evaluator ->
InfraValidator -> Pusher.  Tuner, Rewriter, BulkInferrer, Resolver and
Importer are not ported yet (``ROADMAP.md`` A9, A18)."""

from tpu_pipelines_torch.components.example_gen import CsvExampleGen  # noqa: F401
from tpu_pipelines_torch.components.statistics_gen import StatisticsGen  # noqa: F401
from tpu_pipelines_torch.components.schema_gen import SchemaGen  # noqa: F401
from tpu_pipelines_torch.components.example_validator import ExampleValidator  # noqa: F401
from tpu_pipelines_torch.components.transform import Transform  # noqa: F401
from tpu_pipelines_torch.components.trainer import Trainer  # noqa: F401
from tpu_pipelines_torch.components.evaluator import Evaluator  # noqa: F401
from tpu_pipelines_torch.components.infra_validator import InfraValidator  # noqa: F401
from tpu_pipelines_torch.components.pusher import Pusher  # noqa: F401
