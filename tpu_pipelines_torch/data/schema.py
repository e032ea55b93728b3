"""Dataset schema: feature types, presence, domains, ranges.

The port's copy of ``tpu_pipelines/data/schema.py``: the TFDV/TF-Metadata
``Schema`` proto (SURVEY.md §2a
SchemaGen): a JSON-serializable dataclass consumed by ExampleValidator (drift/
anomaly checks) and Transform (feature typing).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
from typing import Dict, List, Optional


class FeatureType(str, enum.Enum):
    INT = "INT"
    FLOAT = "FLOAT"
    BYTES = "BYTES"   # strings / opaque bytes


@dataclasses.dataclass
class Feature:
    name: str
    type: FeatureType
    # Fraction of examples in which the feature must be present (non-null).
    min_presence: float = 1.0
    # Categorical domain (BYTES/INT features with bounded vocabulary).
    domain: Optional[List[str]] = None
    # Numeric range observed at inference time (None = unbounded).
    min_value: Optional[float] = None
    max_value: Optional[float] = None
    # Fraction of out-of-domain values tolerated before flagging an anomaly.
    distribution_constraint: float = 0.0
    # Schema environments (TFDV parity): a feature's presence requirements
    # apply only in environments where it is EXPECTED.  ``in_environment``
    # (exclusive allow-list) wins over ``not_in_environment`` (deny-list);
    # with neither set the feature follows Schema.default_environments.
    # Canonical use: the label feature carries
    # ``not_in_environment=["SERVING"]`` so label-less serving batches
    # validate cleanly against the training schema.
    in_environment: List[str] = dataclasses.field(default_factory=list)
    not_in_environment: List[str] = dataclasses.field(default_factory=list)

    def to_json(self) -> Dict:
        d = dataclasses.asdict(self)
        d["type"] = self.type.value
        return d

    @classmethod
    def from_json(cls, d: Dict) -> "Feature":
        d = dict(d)
        d["type"] = FeatureType(d["type"])
        return cls(**d)


@dataclasses.dataclass
class Schema:
    features: Dict[str, Feature] = dataclasses.field(default_factory=dict)
    # Environments this schema knows about (e.g. ["TRAINING", "SERVING"]).
    # Empty = environments unused: every feature expected everywhere.
    default_environments: List[str] = dataclasses.field(default_factory=list)

    def expected_in(self, feature_name: str, environment: Optional[str]) -> bool:
        """Is ``feature_name`` expected to be present in ``environment``?

        ``environment=None`` (validation without an environment) expects
        every feature — the pre-environment behavior."""
        feat = self.features.get(feature_name)
        if feat is None:
            return False
        if environment is None:
            return True
        if feat.in_environment:
            return environment in feat.in_environment
        if feat.not_in_environment:
            return environment not in feat.not_in_environment
        if self.default_environments:
            return environment in self.default_environments
        return True

    def to_json(self) -> Dict:
        return {
            "features": {n: f.to_json() for n, f in self.features.items()},
            "default_environments": list(self.default_environments),
        }

    @classmethod
    def from_json(cls, d: Dict) -> "Schema":
        schema = cls(
            features={
                n: Feature.from_json(f) for n, f in d.get("features", {}).items()
            },
            default_environments=list(d.get("default_environments", [])),
        )
        # Migrate the pre-environment wire format: ``optional_at_serving``
        # was a Schema-level list of features a serving batch may omit —
        # exactly ``not_in_environment=["SERVING"]`` in today's model.
        legacy = d.get("optional_at_serving") or []
        if legacy:
            if not schema.default_environments:
                schema.default_environments = ["TRAINING", "SERVING"]
            for name in legacy:
                feat = schema.features.get(name)
                if feat is not None and not feat.not_in_environment:
                    feat.not_in_environment = ["SERVING"]
        return schema

    FILE_NAME = "schema.json"

    def save(self, uri: str) -> str:
        os.makedirs(uri, exist_ok=True)
        path = os.path.join(uri, self.FILE_NAME)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
        return path

    @classmethod
    def load(cls, uri: str) -> "Schema":
        path = uri if uri.endswith(".json") else os.path.join(uri, cls.FILE_NAME)
        with open(path) as f:
            return cls.from_json(json.load(f))
