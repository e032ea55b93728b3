"""The port's ``ImportExampleGen`` against the reference's, each through
its own ``LocalDagRunner`` on the same seeded files: split per record file,
one record file hash-split, one ``.npz`` hash-split, and ``{SPAN}``
selection.  The reference writes Parquet and the port ``.npz``, so the
comparison is on split counts and every column value, exactly, in row
order within each split (split membership included: the port's hash prints
each value as the reference's Arrow column does).
"""

import os

import numpy as np
import pytest

from tpu_pipelines_torch.data import record_io

from torch_records import encode_example, example_rows, write_tfrecord


def _write(path, n, seed, start=0):
    rows = example_rows(np.random.default_rng(seed), n, start)
    write_tfrecord(path, [encode_example(r) for r in rows],
                   record_io._masked_crc32c)


def _run(pkg, tmp_path, tag, **params):
    """ImportExampleGen of ``pkg`` through its runner; (artifact, execution
    properties, the split columns as Python values)."""
    if pkg == "port":
        from tpu_pipelines_torch.components import ImportExampleGen
        from tpu_pipelines_torch.data import examples_io
        from tpu_pipelines_torch.dsl.pipeline import Pipeline
        from tpu_pipelines_torch.metadata import open_store
        from tpu_pipelines_torch.orchestration import LocalDagRunner

        runner = LocalDagRunner(device="cpu")
    else:
        from tpu_pipelines.components import ImportExampleGen
        from tpu_pipelines.data import examples_io
        from tpu_pipelines.dsl.pipeline import Pipeline
        from tpu_pipelines.metadata import open_store
        from tpu_pipelines.orchestration import LocalDagRunner

        runner = LocalDagRunner()
    base = tmp_path / f"{pkg}-{tag}"
    pipe = Pipeline(
        "record-import", [ImportExampleGen(**params)],
        pipeline_root=str(base / "root"),
        metadata_path=str(base / "md.sqlite"),
    )
    result = runner.run(pipe)
    assert result.succeeded, result.nodes
    (art,) = result.outputs_of("ImportExampleGen", "examples")
    columns = {}
    for split in art.properties["split_names"]:
        table = examples_io.read_split_table(art.uri, split)
        if pkg == "port":
            columns[split] = {n: table.columns[n].tolist()
                              for n in table.column_names}
        else:
            columns[split] = {n: table.column(n).to_pylist()
                              for n in table.column_names}
    store = open_store(str(base / "md.sqlite"))
    try:
        props = store.get_executions(node_id="ImportExampleGen")[-1].properties
    finally:
        store.close()
    return art, props, columns


def _both(tmp_path, tag, **params):
    port = _run("port", tmp_path, tag, **params)
    ref = _run("ref", tmp_path, tag, **params)
    for (art, props, cols), (rart, rprops, rcols) in [(port, ref)]:
        assert art.properties["split_counts"] == rart.properties["split_counts"]
        assert art.properties["split_names"] == rart.properties["split_names"]
        assert cols == rcols
        assert {k: v for k, v in props.items() if k != "ingest_rows_per_sec"
                and k != "wall_clock_s"} == {
            k: v for k, v in rprops.items() if k != "ingest_rows_per_sec"
            and k != "wall_clock_s"}
        assert props["ingest_rows_per_sec"] > 0
    return port, ref


def test_a_record_file_per_split(tmp_path):
    d = tmp_path / "data"
    d.mkdir()
    _write(str(d / "train.tfrecord"), 90, seed=1)
    _write(str(d / "eval.tfrecord"), 30, seed=2, start=90)
    (art, _, cols), _ = _both(tmp_path, "dir", input_path=str(d))
    assert art.properties["split_counts"] == {"eval": 30, "train": 90}
    assert cols["train"]["pair"][3] == [3, -4]


def test_one_record_file_hash_splits(tmp_path):
    path = str(tmp_path / "all.tfrecord")
    _write(path, 300, seed=3)
    (art, _, _), _ = _both(tmp_path, "file", input_path=path,
                           splits={"train": 3, "eval": 1})
    counts = art.properties["split_counts"]
    assert counts["train"] + counts["eval"] == 300
    assert counts["train"] > counts["eval"] > 0


def test_an_npz_hash_splits(tmp_path):
    rng = np.random.default_rng(4)
    path = str(tmp_path / "cols.npz")
    np.savez(path, x=rng.normal(size=200), y=rng.integers(0, 9, 200),
             f=rng.normal(size=200).astype(np.float32),
             img=rng.integers(0, 255, (200, 2, 3)),
             tag=np.asarray([f"t{i % 7}" for i in range(200)]))
    (art, _, cols), _ = _both(tmp_path, "npz", input_path=path)
    assert sum(art.properties["split_counts"].values()) == 200
    assert len(cols["train"]["img"][0]) == 6


def test_span_pattern_takes_the_newest_span_or_a_pinned_one(tmp_path):
    """``{SPAN}`` resolves to the newest span (or the pinned one); the
    reference's ImportExampleGen reads no pattern, so it is held to the
    port on the directory the pattern resolved to."""
    for span, n in ((1, 40), (2, 60)):
        d = tmp_path / "in" / f"span-{span}"
        d.mkdir(parents=True)
        _write(str(d / "train.tfrecord"), n, seed=span)
        _write(str(d / "eval.tfrecord"), n // 2, seed=10 + span)
    pattern = str(tmp_path / "in" / "span-{SPAN}")
    for pin, span in ((None, 2), (1, 1)):
        extra = {} if pin is None else {"span": pin}
        art, props, cols = _run("port", tmp_path, f"span{pin}",
                                input_path=pattern, **extra)
        rart, _, rcols = _run("ref", tmp_path, f"span{pin}",
                              input_path=pattern.replace("{SPAN}", str(span)))
        assert art.properties["span"] == span and props["span"] == span
        assert art.properties["split_counts"] == rart.properties["split_counts"]
        assert cols == rcols


def test_a_new_span_re_ingests_and_the_same_span_is_cached(tmp_path):
    from tpu_pipelines_torch.components import ImportExampleGen
    from tpu_pipelines_torch.dsl.pipeline import Pipeline
    from tpu_pipelines_torch.orchestration import LocalDagRunner

    d1 = tmp_path / "in" / "span-1"
    d1.mkdir(parents=True)
    _write(str(d1 / "train.tfrecord"), 20, seed=1)

    def run():
        return LocalDagRunner(device="cpu").run(Pipeline(
            "spans", [ImportExampleGen(
                input_path=str(tmp_path / "in" / "span-{SPAN}"))],
            pipeline_root=str(tmp_path / "root"),
            metadata_path=str(tmp_path / "md.sqlite")))

    assert run().nodes["ImportExampleGen"].status == "COMPLETE"
    assert run().nodes["ImportExampleGen"].status == "CACHED"
    d2 = tmp_path / "in" / "span-2"
    d2.mkdir()
    _write(str(d2 / "train.tfrecord"), 30, seed=2)
    r = run()
    assert r.nodes["ImportExampleGen"].status == "COMPLETE"
    (art,) = r.outputs_of("ImportExampleGen", "examples")
    assert art.properties["span"] == 2
    assert art.properties["split_counts"] == {"train": 30}


def test_a_parquet_directory_raises_naming_the_npz_format(tmp_path):
    from tpu_pipelines_torch.components import ImportExampleGen
    from tpu_pipelines_torch.dsl.pipeline import Pipeline
    from tpu_pipelines_torch.orchestration import LocalDagRunner

    d = tmp_path / "pq"
    d.mkdir()
    (d / "train.parquet").write_bytes(b"PAR1")
    r = LocalDagRunner(device="cpu").run(Pipeline(
        "pq", [ImportExampleGen(input_path=str(d))],
        pipeline_root=str(tmp_path / "root"),
        metadata_path=str(tmp_path / "md.sqlite")), raise_on_failure=False)
    nr = r.nodes["ImportExampleGen"]
    assert nr.status == "FAILED"
    assert "NotImplementedError" in nr.error and ".npz" in nr.error


def test_a_corrupt_record_fails_the_node_unless_crc_is_off(tmp_path):
    from tpu_pipelines_torch.components import ImportExampleGen
    from tpu_pipelines_torch.dsl.pipeline import Pipeline
    from tpu_pipelines_torch.orchestration import LocalDagRunner

    d = tmp_path / "bad"
    d.mkdir()
    path = str(d / "train.tfrecord")
    _write(path, 5, seed=1)
    raw = bytearray(open(path, "rb").read())
    raw[-1] ^= 0x01                      # the last record's payload crc
    open(path, "wb").write(bytes(raw))
    for verify, want in ((True, "FAILED"), (False, "COMPLETE")):
        r = LocalDagRunner(device="cpu").run(Pipeline(
            f"crc{verify}", [ImportExampleGen(input_path=str(d),
                                              verify_record_crc=verify)],
            pipeline_root=str(tmp_path / f"root{verify}"),
            metadata_path=str(tmp_path / f"md{verify}.sqlite")),
            raise_on_failure=False)
        assert r.nodes["ImportExampleGen"].status == want
        if want == "FAILED":
            assert "payload-crc mismatch" in r.nodes["ImportExampleGen"].error


@pytest.mark.parametrize("num_shards", [1, 3])
def test_hash_split_membership_is_independent_of_shards(tmp_path, num_shards):
    path = str(tmp_path / "all.tfrecord")
    _write(path, 120, seed=6)
    art, _, cols = _run("port", tmp_path, f"shards{num_shards}",
                        input_path=path, num_shards=num_shards)
    rart, _, rcols = _run("ref", tmp_path, "shards1", input_path=path)
    assert art.properties["split_counts"] == rart.properties["split_counts"]
    for split in cols:
        assert sorted(cols[split]["name"]) == sorted(rcols[split]["name"])
    assert os.path.isdir(art.uri)
