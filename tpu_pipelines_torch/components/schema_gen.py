"""SchemaGen: infer a Schema from computed statistics.

Capability match for TFX SchemaGen / TFDV ``infer_schema`` (SURVEY.md §2a
row 3).  Inference rules follow TFDV's spirit: feature types from observed
dtypes, presence from observed missing fraction (with slack), categorical
domains for low-cardinality string features, numeric ranges recorded but not
enforced by default.
"""

from __future__ import annotations

from tpu_pipelines_torch.data.schema import Feature, FeatureType, Schema
from tpu_pipelines_torch.data.statistics import load_statistics
from tpu_pipelines_torch.dsl.component import Parameter, component

# A string feature whose distinct-value count is at or below this becomes a
# closed categorical domain.
_DOMAIN_MAX_CARDINALITY = 100


@component(
    inputs={"statistics": "ExampleStatistics"},
    outputs={"schema": "Schema"},
    parameters={
        # Which split to infer from; TFX infers from train.
        "split": Parameter(type=str, default="train"),
        "infer_domains": Parameter(type=bool, default=True),
        "infer_ranges": Parameter(type=bool, default=False),
        # Schema environments (TFDV parity): features listed here — labels,
        # typically — get not_in_environment=["SERVING"], and the schema
        # declares TRAINING/SERVING default environments, so serving-time
        # validation (ExampleValidator(environment="SERVING"), the
        # InfraValidator canary) accepts label-less batches.
        "exclude_at_serving": Parameter(type=list, default=None),
    },
)
def SchemaGen(ctx):
    stats = load_statistics(ctx.input("statistics").uri)
    split = ctx.exec_properties["split"]
    if split not in stats:
        raise ValueError(
            f"split {split!r} not in statistics (have {sorted(stats)})"
        )
    s = stats[split]
    schema = Schema()
    exclude_at_serving = set(
        ctx.exec_properties.get("exclude_at_serving") or ()
    )
    if exclude_at_serving:
        schema.default_environments = ["TRAINING", "SERVING"]
        missing = exclude_at_serving - set(s.features)
        if missing:
            raise ValueError(
                f"exclude_at_serving names unknown features {sorted(missing)}"
            )
    for name, fs in s.features.items():
        feat = Feature(name=name, type=FeatureType(fs.type))
        # Presence with slack: a feature fully present in train is required;
        # one partially present gets its observed presence floored slightly.
        feat.min_presence = 1.0 if fs.num_missing == 0 else max(
            0.0, round(fs.presence * 0.9, 4)
        )
        if (
            ctx.exec_properties["infer_domains"]
            and fs.string is not None
            and fs.string.unique <= _DOMAIN_MAX_CARDINALITY
            # top_values must cover every distinct value for a closed domain.
            and len(fs.string.top_values) >= fs.string.unique
        ):
            feat.domain = sorted(v for v, _ in fs.string.top_values)
        if ctx.exec_properties["infer_ranges"] and fs.numeric is not None:
            feat.min_value = fs.numeric.min
            feat.max_value = fs.numeric.max
        if name in exclude_at_serving:
            feat.not_in_environment = ["SERVING"]
        schema.features[name] = feat
    out = ctx.output("schema")
    schema.save(out.uri)
    out.properties["num_features"] = len(schema.features)
    return {"num_features": len(schema.features)}
