"""Core metadata record types: Artifact, Execution, Context, Event (the
port's copy of ``tpu_pipelines/metadata/types.py``).

This is the MLMD data model (see SURVEY.md §2b "ml-metadata") re-expressed as
plain dataclasses over JSON-serializable property bags.  Records are identified
by integer ids assigned by the store; ``id == 0`` means "not yet persisted".
"""

from __future__ import annotations

import dataclasses
import enum
import json
import time
from typing import Any, Dict, Optional


class ArtifactState(str, enum.Enum):
    PENDING = "PENDING"      # allocated, producer still running
    LIVE = "LIVE"            # produced and usable
    ABANDONED = "ABANDONED"  # producer failed
    DELETED = "DELETED"      # garbage-collected


class ExecutionState(str, enum.Enum):
    RUNNING = "RUNNING"
    COMPLETE = "COMPLETE"
    FAILED = "FAILED"
    CACHED = "CACHED"        # outputs reused from a prior COMPLETE execution
    CANCELED = "CANCELED"
    # Orphaned RUNNING execution fenced by a resume's stale-execution sweep:
    # its orchestrator died before publishing, so the record can never be
    # trusted (the executor may have half-written its outputs).
    ABANDONED = "ABANDONED"


class EventType(str, enum.Enum):
    INPUT = "INPUT"
    OUTPUT = "OUTPUT"


def _now() -> float:
    return time.time()


@dataclasses.dataclass
class Artifact:
    """A typed, addressable output of a component execution.

    ``type_name`` is the artifact type (e.g. ``Examples``, ``Model``);
    ``uri`` points at the payload directory on disk; ``properties`` holds
    type-specific metadata (split names, schema hash, metrics, ...).
    """

    type_name: str
    uri: str = ""
    id: int = 0
    state: ArtifactState = ArtifactState.PENDING
    properties: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Content fingerprint of the payload, filled by the publisher; feeds the
    # execution cache key of downstream nodes.
    fingerprint: str = ""
    create_time: float = dataclasses.field(default_factory=_now)

    def to_row(self) -> tuple:
        return (
            self.type_name,
            self.uri,
            self.state.value,
            json.dumps(self.properties, sort_keys=True, default=str),
            self.fingerprint,
            self.create_time,
        )

    @classmethod
    def from_row(cls, row: tuple) -> "Artifact":
        art = cls(
            type_name=row[1],
            uri=row[2],
            state=ArtifactState(row[3]),
            properties=json.loads(row[4]),
            fingerprint=row[5],
            create_time=row[6],
        )
        art.id = row[0]
        return art


@dataclasses.dataclass
class Execution:
    """One run (or cache-hit) of a pipeline node."""

    type_name: str                     # component type, e.g. "Trainer"
    node_id: str = ""                  # unique node id within the pipeline
    id: int = 0
    state: ExecutionState = ExecutionState.RUNNING
    # Execution properties: the node's resolved exec-properties plus
    # framework-recorded facts (wall_clock_s, retries, examples_per_sec, ...).
    properties: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Content key over (component version, exec properties, input
    # fingerprints); equal keys ⇒ outputs are reusable.  Empty = uncacheable.
    cache_key: str = ""
    create_time: float = dataclasses.field(default_factory=_now)
    update_time: float = dataclasses.field(default_factory=_now)

    def to_row(self) -> tuple:
        return (
            self.type_name,
            self.node_id,
            self.state.value,
            json.dumps(self.properties, sort_keys=True, default=str),
            self.cache_key,
            self.create_time,
            self.update_time,
        )

    @classmethod
    def from_row(cls, row: tuple) -> "Execution":
        ex = cls(
            type_name=row[1],
            node_id=row[2],
            state=ExecutionState(row[3]),
            properties=json.loads(row[4]),
            cache_key=row[5],
            create_time=row[6],
            update_time=row[7],
        )
        ex.id = row[0]
        return ex


@dataclasses.dataclass
class Context:
    """A grouping record: a pipeline, a pipeline run, or a node.

    ``(type_name, name)`` is unique; executions and artifacts are associated
    with contexts for lineage queries ("all artifacts of run X").
    """

    type_name: str   # "pipeline" | "pipeline_run" | "node"
    name: str
    id: int = 0
    properties: Dict[str, Any] = dataclasses.field(default_factory=dict)
    create_time: float = dataclasses.field(default_factory=_now)


@dataclasses.dataclass
class Event:
    """Edge in the lineage graph: artifact ⇄ execution with a role.

    ``path`` is the input/output dict key on the component spec ("examples",
    "model", ...) and ``index`` the position within that key's artifact list.
    """

    artifact_id: int
    execution_id: int
    type: EventType
    path: str = ""
    index: int = 0
    ts: float = dataclasses.field(default_factory=_now)


@dataclasses.dataclass
class LineageNode:
    """One hop in a provenance chain returned by lineage queries."""

    artifact: Artifact
    producer: Optional[Execution]
    parents: list  # list[LineageNode]
