"""Importer: register external data as a typed artifact (TFX ImporterNode).

The port's copy of ``tpu_pipelines/components/importer.py``.  The node's
executor does not copy: it re-points its output artifact's uri at
``source_uri``, so downstream components consume the external payload in
place while metadata gains a first-class artifact for lineage.

``source_uri`` is an external input parameter, so its content is
fingerprinted into the execution cache key: editing the external data
re-imports; unchanged data is a cache hit.

::

    base = Importer(source_uri="/models/prod/1", artifact_type="Model")
    trainer = Trainer(..., base_model=base.outputs["result"])
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Type

from tpu_pipelines_torch.dsl.component import Component, Parameter, component

_CLASS_CACHE: Dict[str, Type[Component]] = {}


def _importer_class(artifact_type: str) -> Type[Component]:
    cls = _CLASS_CACHE.get(artifact_type)
    if cls is not None:
        return cls
    # Importing is where types outside the standard taxonomy enter a
    # pipeline; unknown names register as custom artifact types.
    from tpu_pipelines_torch.dsl.artifact_types import register_artifact_type

    register_artifact_type(
        artifact_type, f"External data imported as {artifact_type}."
    )

    @component(
        outputs={"result": artifact_type},
        parameters={
            "source_uri": Parameter(type=str, required=True),
            # Extra artifact properties to publish (e.g. split_names when
            # importing an Examples layout).
            "properties": Parameter(type=dict, default=None),
        },
        name=f"Importer[{artifact_type}]",
        external_input_parameters=("source_uri",),
    )
    def _Importer(ctx):
        src = os.path.abspath(ctx.exec_properties["source_uri"])
        if not os.path.exists(src):
            raise FileNotFoundError(
                f"Importer source_uri {src!r} does not exist"
            )
        art = ctx.output("result")
        # Point the artifact at the external payload in place (no copy);
        # the publisher fingerprints this uri, so downstream cache keys
        # track the external content.
        art.uri = src
        art.properties.update(ctx.exec_properties["properties"] or {})
        return {"imported_uri": src}

    _CLASS_CACHE[artifact_type] = _Importer
    return _Importer


def Importer(
    *,
    source_uri: str,
    artifact_type: str,
    instance_name: str = "",
    properties: Optional[Dict[str, Any]] = None,
) -> Component:
    """Build an Importer node for ``artifact_type`` (output key: "result")."""
    cls = _importer_class(artifact_type)
    return cls(
        instance_name=instance_name or f"Importer.{artifact_type}",
        source_uri=source_uri,
        properties=properties,
    )
