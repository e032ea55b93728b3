"""Metadata plane: typed artifacts, executions, lineage, execution cache.

The port's copy of ``tpu_pipelines/metadata``: the ml-metadata data model
(Artifact / Execution / Context / Event) over SQLite with a content-keyed
execution cache, served by the stdlib ``sqlite3`` or by the C++ core
(``native_store.py``).
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
    """Open a metadata store, selecting the backend.

    ``backend`` (or env ``TPP_METADATA_BACKEND``): "python" (default) uses
    the stdlib-sqlite store; "native" uses the C++ core
    (``csrc/host/metadata_core.cc`` through ctypes, built with ``g++`` at
    first use), falling back to "python" with a warning if it cannot be
    built or loaded.  Both backends share one on-disk schema, so they are
    interchangeable per open.  A host backend, not a kernel: callers that
    must know which one served (``chip_smoke.py``) check the class.
    """
    import logging
    import os

    choice = (backend or os.environ.get("TPP_METADATA_BACKEND", "python")).lower()
    if choice == "native":
        try:
            from tpu_pipelines_torch.metadata.native_store import (
                NativeMetadataStore,
            )

            return NativeMetadataStore(db_path)
        except Exception as e:  # toolchain-free deployment images
            logging.getLogger("tpu_pipelines_torch.metadata").warning(
                "native metadata backend unavailable (%s); using python", e
            )
    elif choice != "python":
        raise ValueError(f"unknown metadata backend {choice!r}")
    return MetadataStore(db_path)
