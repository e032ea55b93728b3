"""Full-pass dataset statistics: vectorized columnar computation.

The port's copy of ``tpu_pipelines/data/statistics.py`` (TFDV's
``GenerateStatistics`` as single-pass numpy reductions), over the port's
``examples_io.Table`` chunks instead of Arrow tables: the same per-feature
statistics and accumulators, feature types read from the column dtypes as
the reference reads them from Arrow types, nulls counted from the masks.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np

from tpu_pipelines_torch.data.schema import FeatureType

_TOP_K = 20
_HIST_BUCKETS = 10


@dataclasses.dataclass
class NumericStats:
    mean: float
    std_dev: float
    min: float
    max: float
    median: float
    num_zeros: int
    histogram_edges: List[float]
    histogram_counts: List[int]


@dataclasses.dataclass
class StringStats:
    unique: int
    avg_length: float
    top_values: List[List]      # [value, count] pairs, descending


@dataclasses.dataclass
class FeatureStats:
    name: str
    type: str                   # FeatureType value
    num_examples: int
    num_missing: int
    numeric: Optional[NumericStats] = None
    string: Optional[StringStats] = None

    @property
    def presence(self) -> float:
        if self.num_examples == 0:
            return 0.0
        return 1.0 - self.num_missing / self.num_examples


@dataclasses.dataclass
class SplitStatistics:
    split: str
    num_examples: int
    features: Dict[str, FeatureStats]

    def to_json(self) -> Dict:
        return {
            "split": self.split,
            "num_examples": self.num_examples,
            "features": {
                n: _feature_to_json(f) for n, f in self.features.items()
            },
        }

    @classmethod
    def from_json(cls, d: Dict) -> "SplitStatistics":
        return cls(
            split=d["split"],
            num_examples=d["num_examples"],
            features={
                n: _feature_from_json(f) for n, f in d["features"].items()
            },
        )


def _feature_to_json(f: FeatureStats) -> Dict:
    d = dataclasses.asdict(f)
    return d


def _feature_from_json(d: Dict) -> FeatureStats:
    d = dict(d)
    if d.get("numeric"):
        d["numeric"] = NumericStats(**d["numeric"])
    if d.get("string"):
        d["string"] = StringStats(**d["string"])
    return FeatureStats(**d)


STATS_FILE = "stats.json"


def save_statistics(uri: str, stats: Dict[str, SplitStatistics]) -> str:
    os.makedirs(uri, exist_ok=True)
    path = os.path.join(uri, STATS_FILE)
    with open(path, "w") as f:
        json.dump(
            {split: s.to_json() for split, s in stats.items()},
            f, indent=2, sort_keys=True,
        )
    return path


def load_statistics(uri: str) -> Dict[str, SplitStatistics]:
    with open(os.path.join(uri, STATS_FILE)) as f:
        raw = json.load(f)
    return {split: SplitStatistics.from_json(d) for split, d in raw.items()}


def infer_feature_type(col: np.ndarray) -> FeatureType:
    """INT for integer columns, FLOAT for floating ones, BYTES for the rest
    (strings, bools, vector columns), as the reference types Arrow columns."""
    if col.ndim == 1 and col.dtype.kind in ("i", "u"):
        return FeatureType.INT
    if col.ndim == 1 and col.dtype.kind == "f":
        return FeatureType.FLOAT
    return FeatureType.BYTES


class _NumericFeatureAcc:
    """Exact streaming moments/min/max/zeros + a uniform reservoir for the
    order statistics (median, histogram).  With fewer values than the
    reservoir size — every workshop-scale dataset — the reservoir holds the
    entire column and median/histogram are exact; beyond that they are the
    standard reservoir-sample approximation (TFDV's quantile sketches play
    the same role) with histogram counts scaled back up to the full count."""

    def __init__(self, reservoir_size: int, rng: np.random.Generator):
        self.count = 0
        self.total = 0.0
        self.total_sq = 0.0
        self.min = np.inf
        self.max = -np.inf
        self.zeros = 0
        self._rng = rng
        self._reservoir = np.empty(reservoir_size, np.float64)
        self._filled = 0

    def update(self, vals: np.ndarray) -> None:
        if not len(vals):
            return
        self.total += float(np.sum(vals))
        self.total_sq += float(np.sum(vals * vals))
        self.min = min(self.min, float(np.min(vals)))
        self.max = max(self.max, float(np.max(vals)))
        self.zeros += int(np.count_nonzero(vals == 0))
        cap = len(self._reservoir)
        room = cap - self._filled
        take = min(room, len(vals))
        if take:
            self._reservoir[self._filled:self._filled + take] = vals[:take]
            self._filled += take
        rest = vals[take:]
        if len(rest):
            # Vectorized algorithm-R step: value j (0-based among the rest,
            # arriving as overall item count+take+j+1) replaces a random slot
            # with probability cap / items_seen.
            seen = self.count + take + 1 + np.arange(len(rest))
            slots = (self._rng.random(len(rest)) * seen).astype(np.int64)
            mask = slots < cap
            self._reservoir[slots[mask]] = rest[mask]
        self.count += len(vals)

    def merge(self, other: "_NumericFeatureAcc") -> None:
        """Fold another accumulator in (Beam CombineFn merge_accumulators).

        Moments/min/max/zeros merge exactly.  Reservoirs concatenate while
        the union fits (both exact -> merged exact, so merged finalize ==
        single-pass finalize for any split that fits the reservoir);
        overflow falls back to the standard weighted subsample — each kept
        slot draws from this side with probability count/(count+other) —
        keeping the merged reservoir an (approximately) uniform sample of
        the union, the same approximation regime as single-pass overflow.
        """
        if not other.count:
            return
        self.total += other.total
        self.total_sq += other.total_sq
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        self.zeros += other.zeros
        cap = len(self._reservoir)
        a = self._reservoir[:self._filled]
        b = other._reservoir[:other._filled]
        if len(a) + len(b) <= cap:
            self._reservoir[len(a):len(a) + len(b)] = b
            self._filled += len(b)
        else:
            take_a = int(self._rng.binomial(
                cap, self.count / (self.count + other.count)
            ))
            take_a = min(take_a, len(a))
            take_b = min(cap - take_a, len(b))
            take_a = cap - take_b
            keep_a = self._rng.choice(len(a), take_a, replace=False)
            keep_b = self._rng.choice(len(b), take_b, replace=False)
            self._reservoir[:take_a] = a[keep_a]
            self._reservoir[take_a:cap] = b[keep_b]
            self._filled = cap
        self.count += other.count

    def finalize(self) -> Optional[NumericStats]:
        if not self.count:
            return None
        sample = self._reservoir[:self._filled]
        counts, edges = np.histogram(sample, bins=_HIST_BUCKETS)
        scale = self.count / max(1, len(sample))
        mean = self.total / self.count
        var = max(0.0, self.total_sq / self.count - mean * mean)
        return NumericStats(
            mean=float(mean),
            std_dev=float(np.sqrt(var)),
            min=float(self.min),
            max=float(self.max),
            median=float(np.median(sample)),
            num_zeros=self.zeros,
            histogram_edges=[float(e) for e in edges],
            histogram_counts=[int(round(c * scale)) for c in counts],
        )


class _StringFeatureAcc:
    """Exact value counts (the TFDV top-k/uniques equivalent; cardinality is
    bounded by the vocabulary, not the dataset)."""

    def __init__(self):
        self.counts: Dict[str, int] = {}
        self.total_len = 0
        self.n = 0

    def update(self, vals: np.ndarray) -> None:
        svals = vals.astype(str)
        uniq, counts = np.unique(svals, return_counts=True)
        for v, c in zip(uniq, counts):
            self.counts[v] = self.counts.get(v, 0) + int(c)
        self.total_len += int(sum(len(v) for v in svals))
        self.n += len(svals)

    def merge(self, other: "_StringFeatureAcc") -> None:
        """Exact merge: value counts add, so merged finalize (sorted-unique
        + stable argsort) is byte-identical to the single-pass result."""
        for v, c in other.counts.items():
            self.counts[v] = self.counts.get(v, 0) + c
        self.total_len += other.total_len
        self.n += other.n

    def finalize(self) -> Optional[StringStats]:
        if not self.n:
            return None
        # Sorted-unique then stable argsort(-counts): byte-identical ordering
        # to the previous single-pass np.unique implementation.
        uniq = np.asarray(sorted(self.counts))
        counts = np.asarray([self.counts[v] for v in uniq])
        order = np.argsort(-counts, kind="stable")
        return StringStats(
            unique=int(len(uniq)),
            avg_length=self.total_len / self.n,
            top_values=[
                [str(uniq[i]), int(counts[i])] for i in order[:_TOP_K]
            ],
        )


class SplitStatsAccumulator:
    """Single-pass streaming statistics over Arrow table chunks — the Beam
    ``CombineFn`` accumulate/merge/extract cycle (SURVEY.md §2a StatisticsGen
    row) without Beam: feed ``update(table)`` row-group-sized chunks and
    ``finalize()``; peak host memory is O(chunk + reservoir), never O(split)."""

    def __init__(self, split: str, reservoir_size: int = 1 << 17, seed: int = 0):
        self.split = split
        self.num_rows = 0
        self.reservoir_size = reservoir_size
        self._rng = np.random.default_rng(seed)
        self._numeric: Dict[str, _NumericFeatureAcc] = {}
        self._string: Dict[str, _StringFeatureAcc] = {}
        self._missing: Dict[str, int] = {}
        self._types: Dict[str, FeatureType] = {}
        self._order: List[str] = []

    def update(self, table) -> None:
        """Fold in one ``examples_io.Table`` chunk."""
        self.num_rows += table.num_rows
        for name in table.column_names:
            col = table.columns[name]
            mask = table.null_mask(name)
            if name not in self._types:
                self._types[name] = infer_feature_type(col)
                self._missing[name] = 0
                self._order.append(name)
            self._missing[name] += table.null_count(name)
            if mask is not None:
                col = col[~mask]
            ftype = self._types[name]
            if ftype in (FeatureType.INT, FeatureType.FLOAT):
                vals = col.astype(np.float64)
                acc = self._numeric.setdefault(
                    name,
                    _NumericFeatureAcc(self.reservoir_size, self._rng),
                )
                acc.update(vals)
            else:
                if col.ndim > 1:  # vector column: Python's list text per row
                    vals = np.asarray(
                        [str(row) for row in col.tolist()], dtype=object)
                elif col.dtype == bool:  # Python's bool text, as to_pylist
                    vals = np.where(col, "True", "False").astype(object)
                else:
                    vals = col.astype(object)
                self._string.setdefault(name, _StringFeatureAcc()).update(vals)

    def merge(self, other: "SplitStatsAccumulator") -> None:
        """Fold another split accumulator in — the merge_accumulators leg of
        the CombineFn cycle, for per-shard parallel stats: accumulate each
        shard independently, merge in shard order, finalize once.  Exact for
        counts/min/max/zeros/missing/top-k; mean/std differ from single-pass
        only by float summation order; reservoir order statistics are exact
        while the union fits the reservoir (_NumericFeatureAcc.merge)."""
        self.num_rows += other.num_rows
        for name in other._order:
            if name not in self._types:
                self._types[name] = other._types[name]
                self._missing[name] = 0
                self._order.append(name)
            elif self._types[name] != other._types[name]:
                raise ValueError(
                    f"column {name!r}: type {self._types[name]} vs "
                    f"{other._types[name]} across shards — shards of one "
                    "split must share a schema"
                )
            self._missing[name] += other._missing[name]
            if name in other._numeric:
                if name in self._numeric:
                    self._numeric[name].merge(other._numeric[name])
                else:
                    self._numeric[name] = other._numeric[name]
            elif name in other._string:
                if name in self._string:
                    self._string[name].merge(other._string[name])
                else:
                    self._string[name] = other._string[name]

    def finalize(self) -> SplitStatistics:
        features: Dict[str, FeatureStats] = {}
        for name in self._order:
            fs = FeatureStats(
                name=name,
                type=self._types[name].value,
                num_examples=self.num_rows,
                num_missing=self._missing[name],
            )
            if name in self._numeric:
                fs.numeric = self._numeric[name].finalize()
            elif name in self._string:
                fs.string = self._string[name].finalize()
            features[name] = fs
        return SplitStatistics(
            split=self.split, num_examples=self.num_rows, features=features
        )


ACCUMULATORS_FILE = "accumulators.pkl"


def save_split_accumulators(
    uri: str, accs: Dict[str, List["SplitStatsAccumulator"]]
) -> str:
    """Persist PRE-MERGE per-shard accumulators next to ``stats.json``.

    The mergeable half of the statistics artifact (docs/CONTINUOUS.md):
    where the finalized JSON is a dead end (median/histograms cannot be
    re-merged), the pickled accumulators let a later consumer — the
    continuous window merger — fold this split's shards with OTHER
    artifacts' shards in any global order and finalize once, reproducing
    a cold single-pass run bit for bit while every shard fits its
    reservoir.  Shard order within each list is the artifact's shard
    order; consumers must preserve it.
    """
    import pickle

    os.makedirs(uri, exist_ok=True)
    path = os.path.join(uri, ACCUMULATORS_FILE)
    with open(path, "wb") as f:
        pickle.dump(accs, f)
    return path


def load_split_accumulators(
    uri: str,
) -> Dict[str, List["SplitStatsAccumulator"]]:
    """Load the per-shard accumulators a ``save_accumulators=True``
    StatisticsGen persisted.  Raises FileNotFoundError with a pointed
    message when the artifact was produced without them."""
    import pickle

    path = os.path.join(uri, ACCUMULATORS_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no {ACCUMULATORS_FILE} under {uri!r}: the statistics "
            "artifact was produced without save_accumulators=True, so "
            "it cannot participate in an incremental window merge"
        )
    with open(path, "rb") as f:
        return pickle.load(f)


def accumulate_split_shard(task) -> SplitStatsAccumulator:
    """One shard's accumulator — the process-pool worker of the sharded
    StatisticsGen (module-level and plain-data-argumented, so it crosses the
    pickle boundary of ``shard_plan.map_shards``).

    ``task`` is ``(uri, split, shard, chunk_rows, reservoir_size)``.  The
    reservoir rng is seeded by shard index so shards sample independently;
    with the split under the reservoir size (every shard's reservoir exact)
    the seed is irrelevant and merged results match single-pass exactly.
    """
    uri, split, shard, chunk_rows, reservoir_size = task
    from tpu_pipelines_torch.data import examples_io

    acc = SplitStatsAccumulator(
        split, reservoir_size=reservoir_size, seed=shard
    )
    for table in examples_io.iter_table_chunks(
        uri, split, rows=chunk_rows, shards=[shard]
    ):
        acc.update(table)
    return acc


def merge_accumulators(
    accs: List[SplitStatsAccumulator],
) -> SplitStatsAccumulator:
    """Left-fold in shard order (deterministic merged reservoir/ordering)."""
    if not accs:
        raise ValueError("no accumulators to merge")
    first = accs[0]
    for other in accs[1:]:
        first.merge(other)
    return first
