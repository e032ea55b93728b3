"""StatisticsGen: full-pass per-split statistics over an Examples artifact.

The port's copy of ``tpu_pipelines/components/statistics_gen.py`` (TFX
StatisticsGen as numpy reductions).  Sharded splits accumulate per shard
and merge in shard order, as the reference's do; merged output equals the
single-pass result (exact for counts/min/max/top-k, float-summation-order
for mean/std, reservoir-exact while the split fits the reservoir).  The
reference runs the shards in a resilient process pool with quarantine
(``salvage_shards``); the port runs them in a thread pool and a failing
shard fails the node (the process pool waits, ``ROADMAP.md`` A21).
"""

from __future__ import annotations

from tpu_pipelines_torch.data import examples_io
from tpu_pipelines_torch.data.shard_plan import ShardPlan, thread_map
from tpu_pipelines_torch.data.statistics import (
    SplitStatsAccumulator,
    accumulate_split_shard,
    merge_accumulators,
    save_statistics,
)
from tpu_pipelines_torch.dsl.component import Parameter, component

# Single-pass default (SplitStatsAccumulator) — repeated here so the pool
# tasks and the sequential path agree without reaching into class defaults.
_RESERVOIR_SIZE = 1 << 17


@component(
    inputs={"examples": "Examples"},
    outputs={"statistics": "ExampleStatistics"},
    parameters={
        # Rows per streamed chunk; peak host memory is O(chunk + reservoir),
        # never O(split).  0 = examples_io.DEFAULT_ROW_GROUP.
        "chunk_rows": Parameter(type=int, default=0),
        # Worker cap for per-shard accumulation (ShardPlan precedence:
        # this param > TPP_DATA_SHARDS > host_cpus).  Parallelism itself
        # comes from the artifact's shard layout; a single-file split always
        # takes the sequential path regardless of this value.
        "num_shards": Parameter(type=int, default=None),
        # Partial-salvage mode (quarantine struck-out shards, merge the
        # survivors): needs the resilient process pool; True raises.
        "salvage_shards": Parameter(type=bool, default=False),
        # Persist the PRE-MERGE per-shard accumulators (accumulators.pkl)
        # alongside stats.json, making this artifact mergeable with other
        # spans' statistics (docs/CONTINUOUS.md): the continuous window
        # merger folds them in global shard order and finalizes once, so
        # incremental merged stats reproduce a cold full-window pass.
        "save_accumulators": Parameter(type=bool, default=False),
    },
)
def StatisticsGen(ctx):
    examples = ctx.input("examples")
    splits = examples_io.split_names(examples.uri)
    if not splits:
        raise ValueError(f"Examples artifact at {examples.uri} has no splits")
    chunk_rows = (
        ctx.exec_properties.get("chunk_rows") or examples_io.DEFAULT_ROW_GROUP
    )
    plan = ShardPlan.resolve(ctx.exec_properties.get("num_shards"))
    salvage = bool(ctx.exec_properties.get("salvage_shards", False))
    keep_accs = bool(ctx.exec_properties.get("save_accumulators", False))
    stats = {}
    shard_accs = {}
    shard_counts = {}
    for split in splits:
        n_shards = examples_io.num_split_shards(examples.uri, split)
        shard_counts[split] = n_shards
        if n_shards > 1:
            if salvage:
                raise NotImplementedError(
                    "salvage_shards needs the resilient process pool "
                    "(ROADMAP.md A21)"
                )
            accs = thread_map(
                accumulate_split_shard,
                [
                    (examples.uri, split, i, chunk_rows, _RESERVOIR_SIZE)
                    for i in range(n_shards)
                ],
                workers=min(plan.num_shards, n_shards),
            )
            if keep_accs:
                # merge_accumulators folds IN PLACE into accs[0]; the
                # persisted shard accumulators must stay pre-merge.
                import copy

                shard_accs[split] = accs
                acc = merge_accumulators([copy.deepcopy(a) for a in accs])
            else:
                acc = merge_accumulators(accs)
        else:
            acc = SplitStatsAccumulator(split)
            for table in examples_io.iter_table_chunks(
                examples.uri, split, rows=chunk_rows
            ):
                acc.update(table)
            if keep_accs:
                shard_accs[split] = [acc]  # finalize() does not mutate
        stats[split] = acc.finalize()
    out = ctx.output("statistics")
    save_statistics(out.uri, stats)
    if keep_accs:
        from tpu_pipelines_torch.data.statistics import save_split_accumulators

        save_split_accumulators(out.uri, shard_accs)
        out.properties["mergeable"] = True
    # Span lineage rides through (docs/CONTINUOUS.md): a per-span
    # statistics artifact must be joinable back to its span without a
    # store walk, so the rolling-window resolver can pair it with the
    # span's Examples.
    for key in ("span", "version"):
        if key in examples.properties:
            out.properties[key] = examples.properties[key]
    out.properties["split_names"] = splits
    props = {
        "data_shards": shard_counts,
        "shard_workers": plan.num_shards,
        "shard_plan_source": plan.source,
        **{f"num_examples_{s}": stats[s].num_examples for s in splits},
    }
    return props
