"""The port's ``Importer`` against the reference's (``tests/test_importer.py``):
the same flows through each package's runner on the same files give the
same node statuses run after run, the imported artifact points at the
source in place (no copy) with its content in the cache key, and the
failure paths never touch the source.
"""

import importlib
import os
import types

import pytest

HERE = os.path.dirname(__file__)
TAXI_CSV = os.path.join(HERE, "testdata", "taxi_sample.csv")


def _pkg(name):
    root = "tpu_pipelines_torch" if name == "port" else "tpu_pipelines"
    ns = types.SimpleNamespace()
    comps = importlib.import_module(f"{root}.components")
    for c in ("CsvExampleGen", "ExampleValidator", "Importer", "SchemaGen",
              "StatisticsGen"):
        setattr(ns, c, getattr(comps, c))
    ns.Pipeline = importlib.import_module(f"{root}.dsl.pipeline").Pipeline
    ns.component = importlib.import_module(f"{root}.dsl.component").component
    ns.Parameter = importlib.import_module(f"{root}.dsl.component").Parameter
    ns.Schema = importlib.import_module(f"{root}.data.schema").Schema
    ns.MetadataStore = importlib.import_module(f"{root}.metadata").MetadataStore
    ns.ArtifactState = importlib.import_module(
        f"{root}.metadata.types").ArtifactState
    ns.PipelineRunError = importlib.import_module(
        f"{root}.orchestration.local_runner").PipelineRunError
    importlib.import_module(f"{root}.dsl.artifact_types").register_artifact_type(
        "ExternalData", "External payload (importer tests).")
    runner_cls = importlib.import_module(f"{root}.orchestration").LocalDagRunner
    ns.runner = (
        (lambda **kw: runner_cls(device="cpu", **kw)) if name == "port"
        else runner_cls
    )
    return ns


def _curated_schema(ns, tmp_path):
    """A hand-curated schema dir, the canonical Importer payload."""
    gen = ns.CsvExampleGen(input_path=TAXI_CSV)
    stats = ns.StatisticsGen(examples=gen.outputs["examples"])
    schema_node = ns.SchemaGen(statistics=stats.outputs["statistics"])
    result = ns.runner().run(ns.Pipeline(
        "schema-once", [schema_node],
        pipeline_root=str(tmp_path / "inferroot"),
        metadata_path=str(tmp_path / "infer.sqlite"),
    ))
    schema = ns.Schema.load(result.outputs_of("SchemaGen", "schema")[0].uri)
    curated = str(tmp_path / "curated_schema")
    schema.save(curated)
    return curated


def _pipeline(ns, tmp_path, curated):
    raw = ns.Importer(source_uri=TAXI_CSV, artifact_type="ExternalData",
                      instance_name="RawData")
    examples = ns.CsvExampleGen(input_path=TAXI_CSV)
    stats = ns.StatisticsGen(examples=examples.outputs["examples"])
    schema = ns.Importer(source_uri=curated, artifact_type="Schema")
    validator = ns.ExampleValidator(
        statistics=stats.outputs["statistics"],
        schema=schema.outputs["result"],
    )
    return ns.Pipeline(
        "importer-flow", [raw, validator],
        pipeline_root=str(tmp_path / "root"),
        metadata_path=str(tmp_path / "md.sqlite"),
    )


def _flow(name, tmp_path):
    """Run 1 cold, run 2 warm, run 3 after saving the same schema again,
    run 4 after editing the file: each run's node statuses, and the
    imported artifacts of run 1."""
    ns = _pkg(name)
    tmp_path = tmp_path / name
    tmp_path.mkdir()
    curated = _curated_schema(ns, tmp_path)
    runs = [ns.runner().run(_pipeline(ns, tmp_path, curated))]
    runs.append(ns.runner().run(_pipeline(ns, tmp_path, curated)))
    ns.Schema.load(curated).save(curated)     # same content
    runs.append(ns.runner().run(_pipeline(ns, tmp_path, curated)))
    with open(os.path.join(curated, os.listdir(curated)[0]), "a") as f:
        f.write("\n")
    runs.append(ns.runner().run(_pipeline(ns, tmp_path, curated)))
    statuses = [{k: v.status for k, v in r.nodes.items()} for r in runs]
    imported = {
        "schema": runs[0].outputs_of("Importer.Schema", "result")[0],
        "raw": runs[0].outputs_of("RawData", "result")[0],
    }
    return statuses, imported, curated


def test_importer_flow_matches_the_reference(tmp_path):
    port, port_arts, curated = _flow("port", tmp_path)
    ref, _, _ = _flow("ref", tmp_path)
    assert port == ref
    assert set(port[0].values()) == {"COMPLETE"}
    assert set(port[1].values()) == {"CACHED"}
    assert port[2]["Importer.Schema"] == "CACHED"      # same content
    assert port[3]["Importer.Schema"] == "COMPLETE"    # re-imported
    assert port[3]["ExampleValidator"] == "COMPLETE"
    # In place: the artifact is the source directory, fingerprinted.
    assert port_arts["schema"].uri == os.path.abspath(curated)
    assert port_arts["raw"].uri == os.path.abspath(TAXI_CSV)
    assert port_arts["schema"].fingerprint


@pytest.mark.parametrize("name", ["port", "ref"])
def test_importer_missing_source_fails(tmp_path, name):
    ns = _pkg(name)
    bad = ns.Importer(source_uri=str(tmp_path / "nope"), artifact_type="Schema")
    with pytest.raises(ns.PipelineRunError):
        ns.runner().run(ns.Pipeline(
            "importer-bad", [bad],
            pipeline_root=str(tmp_path / "root2"),
            metadata_path=str(tmp_path / "md2.sqlite"),
        ))


@pytest.mark.parametrize("name", ["port", "ref"])
def test_importer_retry_never_deletes_source(tmp_path, name):
    """The retry clean slate resets to the allocated uri, never removes
    the executor-assigned external path."""
    ns = _pkg(name)
    src = tmp_path / "precious"
    src.mkdir()
    (src / "data.txt").write_text("do not delete")
    calls = {"n": 0}

    @ns.component(
        outputs={"result": "ExternalData"},
        parameters={"source_uri": ns.Parameter(type=str, required=True)},
        external_input_parameters=("source_uri",),
    )
    def FlakyImporter(ctx):
        art = ctx.output("result")
        art.uri = os.path.abspath(ctx.exec_properties["source_uri"])
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient failure AFTER uri reassignment")
        return {}

    result = ns.runner(max_retries=1).run(ns.Pipeline(
        "importer-retry", [FlakyImporter(source_uri=str(src))],
        pipeline_root=str(tmp_path / "root3"),
        metadata_path=str(tmp_path / "md3.sqlite"),
    ))
    assert result.succeeded
    assert result.nodes["FlakyImporter"].retries == 1
    assert (src / "data.txt").read_text() == "do not delete"
    assert result.outputs_of("FlakyImporter", "result")[0].uri == str(src)


@pytest.mark.parametrize("name", ["port", "ref"])
def test_failed_import_abandons_allocated_uri_not_source(tmp_path, name):
    ns = _pkg(name)
    src = tmp_path / "precious2"
    src.mkdir()
    (src / "data.txt").write_text("keep")

    @ns.component(
        outputs={"result": "ExternalData"},
        parameters={"source_uri": ns.Parameter(type=str, required=True)},
    )
    def DoomedImporter(ctx):
        ctx.output("result").uri = os.path.abspath(
            ctx.exec_properties["source_uri"])
        raise RuntimeError("always fails")

    result = ns.runner(max_retries=0).run(
        ns.Pipeline("importer-doomed", [DoomedImporter(source_uri=str(src))],
                    pipeline_root=str(tmp_path / "root4"),
                    metadata_path=str(tmp_path / "md4.sqlite")),
        raise_on_failure=False,
    )
    assert not result.succeeded
    store = ns.MetadataStore(str(tmp_path / "md4.sqlite"))
    abandoned = store.get_artifacts(state=ns.ArtifactState.ABANDONED)
    store.close()
    assert abandoned
    for art in abandoned:
        assert str(src) not in art.uri
        assert art.uri.startswith(str(tmp_path / "root4"))
    assert (src / "data.txt").read_text() == "keep"


@pytest.mark.parametrize("name", ["port", "ref"])
def test_importer_default_id_collision_names_the_fix(tmp_path, name):
    ns = _pkg(name)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    imp_a = ns.Importer(source_uri=str(tmp_path / "a"), artifact_type="Schema")
    imp_b = ns.Importer(source_uri=str(tmp_path / "b"), artifact_type="Schema")
    with pytest.raises(ValueError, match="instance_name"):
        ns.Pipeline("dup-importers", [imp_a, imp_b],
                    pipeline_root=str(tmp_path / "root"))
    imp_c = ns.Importer(source_uri=str(tmp_path / "b"), artifact_type="Schema",
                        instance_name="SchemaB")
    ns.Pipeline("ok-importers", [imp_a, imp_c],
                pipeline_root=str(tmp_path / "root"))


def test_a_model_importer_feeds_a_warm_start_base_model(tmp_path):
    """The retrain DAG's wiring: an imported Model reaches the Trainer's
    ``base_model`` as the payload directory itself."""
    ns = _pkg("port")
    from tpu_pipelines_torch.dsl.component import component

    payload = tmp_path / "prod" / "1"
    payload.mkdir(parents=True)
    (payload / "model_spec.json").write_text("{}")
    seen = {}

    @component(inputs={"base_model": "Model"}, outputs={"out": "Examples"},
               optional_inputs=("base_model",))
    def Consumer(ctx):
        seen["uri"] = ctx.input("base_model").uri
        return {}

    imp = ns.Importer(source_uri=str(payload), artifact_type="Model")
    r = ns.runner().run(ns.Pipeline(
        "model-import", [Consumer(base_model=imp.outputs["result"])],
        pipeline_root=str(tmp_path / "root"),
        metadata_path=str(tmp_path / "md.sqlite")))
    assert r.succeeded and seen["uri"] == str(payload)
