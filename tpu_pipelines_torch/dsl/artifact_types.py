"""Standard artifact types — the vocabulary of the canonical DAG.

Mirrors the TFX standard artifact taxonomy (Examples, ExampleStatistics,
Schema, ExampleAnomalies, TransformGraph, Model, ModelEvaluation,
ModelBlessing, InferenceResult, PushedModel, HyperParameters) so every
capability in SURVEY.md §2a has a typed artifact to flow through channels.
"""

from __future__ import annotations

from typing import Dict


class _ArtifactType:
    def __init__(self, name: str, doc: str):
        self.name = name
        self.doc = doc

    def __repr__(self) -> str:
        return f"ArtifactType({self.name})"


ARTIFACT_TYPES: Dict[str, _ArtifactType] = {}


def _register(name: str, doc: str) -> _ArtifactType:
    t = _ArtifactType(name, doc)
    ARTIFACT_TYPES[name] = t
    return t


def register_artifact_type(name: str, doc: str = "") -> _ArtifactType:
    """Register a custom artifact type (TFX custom-Artifact equivalent).

    Idempotent for a same-named existing type; used by pipeline authors
    whose components flow domain artifacts the standard taxonomy lacks
    (and by Importer when pointing at such data)."""
    existing = ARTIFACT_TYPES.get(name)
    if existing is not None:
        return existing
    return _register(name, doc or "Custom artifact type.")


class standard_artifacts:
    """Namespace of the built-in artifact types."""

    Examples = _register(
        "Examples", "Split example data (train/eval), columnar on disk."
    )
    ExampleStatistics = _register(
        "ExampleStatistics", "Per-split full-pass dataset statistics."
    )
    Schema = _register("Schema", "Inferred/curated dataset schema.")
    ExampleAnomalies = _register(
        "ExampleAnomalies", "Anomalies from validating stats against a schema."
    )
    TransformGraph = _register(
        "TransformGraph",
        "Serialized skew-free transform: analyzer state + traced apply fn.",
    )
    Model = _register("Model", "Trained model: params checkpoint + export.")
    ModelRun = _register("ModelRun", "Training logs / TensorBoard run dir.")
    ModelEvaluation = _register(
        "ModelEvaluation", "Sliced metrics from the Evaluator."
    )
    ModelBlessing = _register(
        "ModelBlessing", "Evaluator gate decision consumed by Pusher."
    )
    InfraBlessing = _register(
        "InfraBlessing", "InfraValidator smoke-serving decision."
    )
    InferenceResult = _register(
        "InferenceResult", "BulkInferrer batch predictions."
    )
    PushedModel = _register("PushedModel", "Versioned, served model payload.")
    HyperParameters = _register(
        "HyperParameters", "Best hyperparameters found by the Tuner."
    )
    TunerResults = _register("TunerResults", "Full trial table from the Tuner.")
