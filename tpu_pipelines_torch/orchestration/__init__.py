"""Orchestration: the local DAG runner (``local_runner.py``).  The cluster
runner is not ported yet (``ROADMAP.md`` A10)."""

from tpu_pipelines_torch.orchestration.local_runner import (  # noqa: F401
    LocalDagRunner,
    NodeResult,
    PipelineRunError,
    RunResult,
)
