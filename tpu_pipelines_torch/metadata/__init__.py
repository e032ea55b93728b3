"""Metadata plane: typed artifacts, executions, lineage, execution cache.

The port's copy of ``tpu_pipelines/metadata``: the ml-metadata data model
(Artifact / Execution / Context / Event) over the stdlib ``sqlite3`` with a
content-keyed execution cache.
"""

from tpu_pipelines_torch.metadata.types import (  # noqa: F401
    Artifact,
    ArtifactState,
    Context,
    Event,
    EventType,
    Execution,
    ExecutionState,
)
from tpu_pipelines_torch.metadata.store import (  # noqa: F401
    MetadataStore,
    StoreUnavailableError,
)


def open_store(db_path: str = ":memory:", backend: str = "") -> MetadataStore:
    """Open a metadata store.  ``backend`` (or env ``TPP_METADATA_BACKEND``)
    may be "python" (the default and only port backend); "native" raises,
    naming ``ROADMAP.md`` A19."""
    import os

    choice = (backend or os.environ.get("TPP_METADATA_BACKEND", "python")).lower()
    if choice == "native":
        raise NotImplementedError(
            "the native metadata backend is not ported yet (ROADMAP.md A19)"
        )
    if choice != "python":
        raise ValueError(f"unknown metadata backend {choice!r}")
    return MetadataStore(db_path)
