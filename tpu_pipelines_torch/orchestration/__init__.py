"""Orchestration: the local DAG runner (``local_runner.py``) and the
compile-only cluster runner (``cluster_runner.py``, GPU manifests)."""

from tpu_pipelines_torch.orchestration.cluster_runner import (  # noqa: F401
    GPUJobRunner,
    GPUJobRunnerConfig,
)
from tpu_pipelines_torch.orchestration.local_runner import (  # noqa: F401
    LocalDagRunner,
    NodeResult,
    PipelineRunError,
    RunResult,
)
