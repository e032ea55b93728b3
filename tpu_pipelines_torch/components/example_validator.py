"""ExampleValidator: anomalies from validating statistics against a schema.

Capability match for TFX ExampleValidator / TFDV ``validate_statistics``
(SURVEY.md §2a row 4): schema-conformance checks per split, plus two
statistics-vs-statistics comparators mirroring TFDV's:

  - **drift**: this run's splits vs a *previous* statistics artifact
    (time-adjacent spans);
  - **skew**: the training split vs the other splits of the *same* artifact
    (TFDV's training/serving skew comparator — the eval/serving data a model
    will face must look like what it trained on).

Both use L-infinity distance over categorical top-value distributions and
Jensen-Shannon divergence (base 2, in [0, 1]) over numeric histograms.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, List, Optional

from tpu_pipelines_torch.data.schema import FeatureType, Schema
from tpu_pipelines_torch.data.statistics import (
    SplitStatistics,
    load_statistics,
)
from tpu_pipelines_torch.dsl.component import Parameter, component


@dataclasses.dataclass
class Anomaly:
    split: str
    feature: str
    kind: str          # MISSING_FEATURE | NEW_FEATURE | TYPE_MISMATCH |
                       # PRESENCE | OUT_OF_DOMAIN | OUT_OF_RANGE | DRIFT |
                       # SKEW | FEATURE_UNEXPECTED_IN_ENVIRONMENT
    severity: str      # ERROR | WARNING
    description: str


ANOMALIES_FILE = "anomalies.json"


def validate_split(
    split_stats: SplitStatistics,
    schema: Schema,
    environment: Optional[str] = None,
) -> List[Anomaly]:
    """Schema-conformance anomalies for one split.

    ``environment`` scopes presence expectations (TFDV schema
    environments): a feature not expected in the environment (e.g. the
    label under ``environment="SERVING"``) may be absent without anomaly —
    but one actually PRESENT is flagged FEATURE_UNEXPECTED_IN_ENVIRONMENT
    (TFDV's anomaly of the same name: the classic label-leakage-into-
    serving-data catch), and its type/domain/range constraints still
    apply."""
    anomalies: List[Anomaly] = []
    split = split_stats.split
    seen = set(split_stats.features)
    for name, feat in schema.features.items():
        expected = schema.expected_in(name, environment)
        fs = split_stats.features.get(name)
        if fs is None or fs.presence == 0.0:
            if not expected:
                continue
            anomalies.append(
                Anomaly(split, name, "MISSING_FEATURE", "ERROR",
                        f"schema feature {name!r} absent from split")
            )
            continue
        if not expected:
            anomalies.append(
                Anomaly(split, name, "FEATURE_UNEXPECTED_IN_ENVIRONMENT",
                        "ERROR",
                        f"feature {name!r} present in "
                        f"{fs.presence:.4f} of examples but not expected "
                        f"in environment {environment!r}")
            )
        if fs.type != feat.type.value:
            anomalies.append(
                Anomaly(split, name, "TYPE_MISMATCH", "ERROR",
                        f"expected {feat.type.value}, found {fs.type}")
            )
            continue
        if expected and fs.presence < feat.min_presence:
            anomalies.append(
                Anomaly(split, name, "PRESENCE", "ERROR",
                        f"present in {fs.presence:.4f} < required "
                        f"{feat.min_presence:.4f} of examples")
            )
        if feat.domain is not None and fs.string is not None:
            domain = set(feat.domain)
            total = sum(c for _, c in fs.string.top_values)
            bad = sum(c for v, c in fs.string.top_values if v not in domain)
            # top_values may truncate; unseen tail counts as out-of-domain
            # only when the domain was closed over full cardinality.
            frac = bad / max(1, total)
            if frac > feat.distribution_constraint:
                examples = [v for v, _ in fs.string.top_values if v not in domain][:5]
                anomalies.append(
                    Anomaly(split, name, "OUT_OF_DOMAIN", "ERROR",
                            f"{frac:.4f} of values outside domain "
                            f"(e.g. {examples})")
                )
        if feat.type in (FeatureType.INT, FeatureType.FLOAT) and fs.numeric:
            if feat.min_value is not None and fs.numeric.min < feat.min_value:
                anomalies.append(
                    Anomaly(split, name, "OUT_OF_RANGE", "ERROR",
                            f"min {fs.numeric.min} < schema min {feat.min_value}")
                )
            if feat.max_value is not None and fs.numeric.max > feat.max_value:
                anomalies.append(
                    Anomaly(split, name, "OUT_OF_RANGE", "ERROR",
                            f"max {fs.numeric.max} > schema max {feat.max_value}")
                )
    for name in seen - set(schema.features):
        anomalies.append(
            Anomaly(split, name, "NEW_FEATURE", "WARNING",
                    f"feature {name!r} not in schema")
        )
    return anomalies


def linf_categorical_distance(
    a: SplitStatistics, b: SplitStatistics, feature: str
) -> Optional[float]:
    """L-infinity distance between normalized top-value distributions."""
    fa, fb = a.features.get(feature), b.features.get(feature)
    if not (fa and fb and fa.string and fb.string):
        return None
    da = {v: c for v, c in fa.string.top_values}
    db = {v: c for v, c in fb.string.top_values}
    ta, tb = sum(da.values()) or 1, sum(db.values()) or 1
    keys = set(da) | set(db)
    return max(abs(da.get(k, 0) / ta - db.get(k, 0) / tb) for k in keys)


def _rebin(edges: List[float], counts: List[int], grid: List[float]) -> List[float]:
    """Histogram mass per ``grid`` interval, treating each source bin as a
    uniform density — exact for piecewise-constant distributions, which is
    all a histogram asserts."""
    total = float(sum(counts)) or 1.0
    out = []
    for g0, g1 in zip(grid, grid[1:]):
        m = 0.0
        for e0, e1, c in zip(edges, edges[1:], counts):
            if e1 <= g0 or e0 >= g1 or e1 == e0:
                continue
            m += c * (min(e1, g1) - max(e0, g0)) / (e1 - e0)
        out.append(m / total)
    return out


def js_numeric_divergence(
    a: SplitStatistics, b: SplitStatistics, feature: str
) -> Optional[float]:
    """Jensen-Shannon divergence (base 2, in [0, 1]) between the two splits'
    numeric histograms, rebinned onto the union of their edges so differing
    bucket boundaries compare exactly (TFDV's numeric skew/drift measure)."""
    fa, fb = a.features.get(feature), b.features.get(feature)
    if not (fa and fb and fa.numeric and fb.numeric):
        return None
    ha, hb = fa.numeric, fb.numeric
    if not (ha.histogram_edges and hb.histogram_edges):
        return None
    grid = sorted(set(ha.histogram_edges) | set(hb.histogram_edges))
    if len(grid) < 2:
        return None
    pa = _rebin(ha.histogram_edges, ha.histogram_counts, grid)
    pb = _rebin(hb.histogram_edges, hb.histogram_counts, grid)
    # Mass outside the other split's support lands in the union grid's outer
    # intervals automatically (the union covers both ranges).
    mid = [(x + y) / 2.0 for x, y in zip(pa, pb)]

    def kl(p, q):
        # q = mid >= p/2 > 0 wherever p > 0, so the sum is finite.
        return sum(x * math.log2(x / y) for x, y in zip(p, q) if x > 0)

    return 0.5 * kl(pa, mid) + 0.5 * kl(pb, mid)


def compare_splits(
    current: SplitStatistics,
    baseline: SplitStatistics,
    *,
    kind: str,
    linf_threshold: float,
    js_threshold: float,
    feature_thresholds: Optional[Dict[str, float]] = None,
    vs: str = "baseline",
) -> List[Anomaly]:
    """Distribution comparison between two splits: L-inf over categorical
    top values, JS divergence over numeric histograms.  A threshold of 0
    disables that family; ``feature_thresholds`` overrides per feature.
    Shared by the DRIFT (vs previous artifact) and SKEW (train vs eval/
    serving split) comparators."""
    overrides = feature_thresholds or {}
    anomalies: List[Anomaly] = []
    for name in current.features:
        linf_t = overrides.get(name, linf_threshold)
        if linf_t:
            d = linf_categorical_distance(current, baseline, name)
            if d is not None and d > linf_t:
                anomalies.append(
                    Anomaly(current.split, name, kind, "ERROR",
                            f"L-inf distance {d:.4f} > {linf_t} vs {vs}")
                )
        js_t = overrides.get(name, js_threshold)
        if js_t:
            d = js_numeric_divergence(current, baseline, name)
            if d is not None and d > js_t:
                anomalies.append(
                    Anomaly(current.split, name, kind, "ERROR",
                            f"JS divergence {d:.4f} > {js_t} vs {vs}")
                )
    return anomalies


@component(
    inputs={"statistics": "ExampleStatistics", "schema": "Schema"},
    outputs={"anomalies": "ExampleAnomalies"},
    parameters={
        # Optional uri of a previous ExampleStatistics payload for drift.
        "baseline_statistics_uri": Parameter(type=str, default=""),
        "drift_threshold": Parameter(type=float, default=0.3),
        # JS-divergence threshold for numeric drift (0 = categorical only,
        # the pre-existing behavior).
        "drift_js_threshold": Parameter(type=float, default=0.0),
        # Training/serving skew: compare skew_baseline_split's distributions
        # against every other split in THIS statistics artifact.  0 disables
        # that family; skew_feature_thresholds overrides per feature.
        "skew_baseline_split": Parameter(type=str, default="train"),
        "skew_linf_threshold": Parameter(type=float, default=0.0),
        "skew_js_threshold": Parameter(type=float, default=0.0),
        "skew_feature_thresholds": Parameter(type=dict, default=None),
        # Schema environment to validate under ("" = no environment: every
        # feature expected).  ExampleValidator(environment="SERVING")
        # validates label-less serving data against the training schema
        # without MISSING_FEATURE noise (TFDV schema environments).
        "environment": Parameter(type=str, default=""),
        # Fail the pipeline on ERROR-severity anomalies.
        "fail_on_anomalies": Parameter(type=bool, default=True),
    },
    is_sink=True,
)
def ExampleValidator(ctx):
    stats = load_statistics(ctx.input("statistics").uri)
    schema = Schema.load(ctx.input("schema").uri)
    environment = ctx.exec_properties.get("environment") or None
    anomalies: List[Anomaly] = []
    for split_stats in stats.values():
        anomalies.extend(validate_split(split_stats, schema, environment))

    baseline_uri = ctx.exec_properties["baseline_statistics_uri"]
    if baseline_uri:
        baseline = load_statistics(baseline_uri)
        for split, s in stats.items():
            prev = baseline.get(split)
            if prev is None:
                continue
            anomalies.extend(compare_splits(
                s, prev, kind="DRIFT",
                linf_threshold=ctx.exec_properties["drift_threshold"],
                js_threshold=ctx.exec_properties["drift_js_threshold"],
            ))

    skew_linf = ctx.exec_properties["skew_linf_threshold"]
    skew_js = ctx.exec_properties["skew_js_threshold"]
    skew_overrides = ctx.exec_properties["skew_feature_thresholds"]
    if skew_linf or skew_js or skew_overrides:
        train_split = ctx.exec_properties["skew_baseline_split"]
        train = stats.get(train_split)
        if train is None:
            raise ValueError(
                f"skew comparison needs split {train_split!r}; artifact has "
                f"{sorted(stats)}"
            )
        for split, s in stats.items():
            if split == train_split:
                continue
            anomalies.extend(compare_splits(
                s, train, kind="SKEW",
                linf_threshold=skew_linf,
                js_threshold=skew_js,
                feature_thresholds=skew_overrides,
                vs=f"{train_split} split",
            ))

    out = ctx.output("anomalies")
    os.makedirs(out.uri, exist_ok=True)
    with open(os.path.join(out.uri, ANOMALIES_FILE), "w") as f:
        json.dump([dataclasses.asdict(a) for a in anomalies], f, indent=2)
    n_errors = sum(1 for a in anomalies if a.severity == "ERROR")
    out.properties["anomaly_count"] = len(anomalies)
    out.properties["error_count"] = n_errors
    if n_errors and ctx.exec_properties["fail_on_anomalies"]:
        raise ValueError(
            f"{n_errors} ERROR anomalies: "
            + "; ".join(
                f"{a.split}/{a.feature}:{a.kind}" for a in anomalies
                if a.severity == "ERROR"
            )
        )
    return {"anomaly_count": len(anomalies), "error_count": n_errors}


def load_anomalies(uri: str) -> List[Anomaly]:
    with open(os.path.join(uri, ANOMALIES_FILE)) as f:
        return [Anomaly(**d) for d in json.load(f)]
