"""Window assembly: logically complete artifacts from per-span pieces.

The port of ``tpu_pipelines/continuous/window.py``, over the port's
``.npz`` shards.  Per-span pipelines produce per-span Examples and
mergeable per-span statistics; the two components here stitch a rolling
window of them into artifacts that downstream nodes consume as if one
cold full-window run had produced them:

  * :class:`SpanWindow`: a hard-link union of the per-span shard files
    into one Examples artifact (a copy where linking fails), span order
    times shard order, the order a cold ``StatisticsGen`` over the window
    artifact folds in.
  * :class:`WindowStatisticsMerger`: folds the per-span pre-merge
    accumulators (``StatisticsGen(save_accumulators=True)``) in that same
    order and finalizes once, so the merged ``stats.json`` equals the cold
    pass byte for byte while every shard fits its reservoir.

Both are ordinary cached components: an unchanged window is a cache hit,
which makes the controller's no-new-span iterations nearly free.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List

from tpu_pipelines_torch.data import examples_io
from tpu_pipelines_torch.dsl.component import component


def assemble_window(uris: List[str], out_uri: str) -> Dict[str, int]:
    """Union per-span Examples artifacts into one artifact.

    For each split (the union across sources), every source's shard files
    are hard-linked (copied where linking fails) into ``out_uri`` under
    fresh ``data-NNNNN-of-MMMMM.npz`` names, source order kept: span order
    times shard order.  Returns the shard count of each split.
    """
    if not uris:
        raise ValueError("assemble_window: no source artifacts")
    splits: List[str] = []
    for uri in uris:
        for s in examples_io.split_names(uri):
            if s not in splits:
                splits.append(s)
    if not splits:
        raise ValueError(f"assemble_window: no splits under {uris!r}")
    shard_counts: Dict[str, int] = {}
    for split in sorted(splits):
        sources: List[str] = []
        for uri in uris:
            if split in examples_io.split_names(uri):
                sources.extend(examples_io.split_shard_paths(uri, split))
        total = len(sources)
        d = examples_io.split_dir(out_uri, split)
        os.makedirs(d, exist_ok=True)
        for i, src in enumerate(sources):
            dst = os.path.join(d, examples_io.shard_file_name(i, total))
            try:
                os.link(src, dst)
            except OSError:
                shutil.copy2(src, dst)
        shard_counts[split] = total
    return shard_counts


@component(
    inputs={"examples": "Examples"},
    outputs={"window": "Examples"},
)
def SpanWindow(ctx):
    """Hard-link-union the resolver's span window into one Examples
    artifact (span-ascending: RollingWindowResolver's output order)."""
    arts = ctx.inputs.get("examples") or []
    if not arts:
        raise ValueError(
            "SpanWindow: empty window — the rolling resolver found no "
            "per-span Examples yet (has the span ingest pipeline run?)"
        )
    out = ctx.output("window")
    shard_counts = assemble_window([a.uri for a in arts], out.uri)
    spans = [a.properties.get("span") for a in arts]
    counts = {
        split: examples_io.num_rows(out.uri, split)
        for split in sorted(shard_counts)
    }
    out.properties["split_names"] = sorted(shard_counts)
    out.properties["split_counts"] = counts
    out.properties["window_spans"] = spans
    return {
        "window_spans": spans,
        "num_examples": sum(counts.values()),
        "data_shards": shard_counts,
    }


@component(
    inputs={"statistics": "ExampleStatistics"},
    outputs={"statistics": "ExampleStatistics"},
)
def WindowStatisticsMerger(ctx):
    """Merge per-span statistics into full-window statistics without
    touching the data: fold each split's pre-merge shard accumulators in
    global (span, shard) order, finalize once, save.  Byte-identical to a
    cold StatisticsGen over the SpanWindow artifact while the shards fit
    their reservoirs."""
    from tpu_pipelines_torch.data.statistics import (
        load_split_accumulators,
        merge_accumulators,
        save_statistics,
    )

    arts = ctx.inputs.get("statistics") or []
    if not arts:
        raise ValueError(
            "WindowStatisticsMerger: empty window — no per-span "
            "statistics artifacts resolved (were they produced with "
            "save_accumulators=True?)"
        )
    per_split: Dict[str, list] = {}
    split_order: List[str] = []
    for art in arts:  # span-ascending (resolver output order)
        for split, shard_accs in load_split_accumulators(art.uri).items():
            if split not in per_split:
                per_split[split] = []
                split_order.append(split)
            per_split[split].extend(shard_accs)
    stats = {
        split: merge_accumulators(per_split[split]).finalize()
        for split in split_order
    }
    out = ctx.output("statistics")
    save_statistics(out.uri, stats)
    spans = [a.properties.get("span") for a in arts]
    out.properties["split_names"] = sorted(stats)
    out.properties["window_spans"] = spans
    return {
        "window_spans": spans,
        "merged_shards": {s: len(per_split[s]) for s in split_order},
        **{f"num_examples_{s}": stats[s].num_examples for s in split_order},
    }
