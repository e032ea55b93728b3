"""Port parity: the native (C++) metadata backend, against the JAX
package's stores (``tests/test_native_store.py``).

The port's core (``tpu_pipelines_torch/csrc/host/metadata_core.cc``) is
built here with the host's ``g++`` and linked against its runtime
``libsqlite3`` (``ops/_build.py``), into the port's ``_build/``.  All
checks are exact:

  - a store written by the port's native core opens in the JAX package's
    ``MetadataStore`` with the same rows, and a store the JAX package
    wrote opens in the port's native core with the same rows;
  - id 0 (the unpersisted sentinel) matches nothing;
  - a failing publish leaves no partial row (the atomic rollback);
  - ``open_store``'s selection rules are the reference's: "native" gives
    the native class (a build that fails falls back to the Python store
    with a warning), "python" the Python store, anything else ValueError;
  - a pipeline on the native backend runs cold (every node COMPLETE, the
    same statuses as the reference's run) and then all cached.
"""

import logging
import os

import pytest

from tpu_pipelines.metadata import MetadataStore as RefStore
from tpu_pipelines.metadata.types import (
    Artifact as RefArtifact,
    ArtifactState as RefArtifactState,
    Context as RefContext,
    Execution as RefExecution,
    ExecutionState as RefExecutionState,
)
from tpu_pipelines_torch.metadata import MetadataStore, open_store
from tpu_pipelines_torch.metadata.native_store import (
    NativeMetadataStore,
    library_path,
)
from tpu_pipelines_torch.metadata.types import (
    Artifact,
    ArtifactState,
    Context,
    Execution,
    ExecutionState,
)

PROPS = {"note": 'quotes "and" \\slashes\n', "n": 3, "f": 1.5,
         "nested": {"list": [1, "two", None]}, "unicode": "héllo ✓"}


def _rows(store, times=True):
    """Every row a store holds, as plain values (ids included; the write
    times unless ``times`` is False)."""
    t = (lambda x: x.create_time) if times else (lambda x: None)
    arts = [(a.id, a.type_name, a.uri, a.state.value, a.properties,
             a.fingerprint, t(a)) for a in store.get_artifacts()]
    execs = [(e.id, e.type_name, e.node_id, e.state.value, e.properties,
              e.cache_key, t(e)) for e in store.get_executions()]
    ctxs = [(c.id, c.type_name, c.name, c.properties, t(c))
            for c in store.get_contexts()]
    events = sorted(
        (ev.artifact_id, ev.execution_id, ev.type.value, ev.path, ev.index)
        for e in store.get_executions()
        for ev in store.get_events_by_execution(e.id))
    links = [(c.id, [e.id for e in store.get_executions_by_context(c.id)],
              [a.id for a in store.get_artifacts_by_context(c.id)])
             for c in store.get_contexts()]
    return arts, execs, ctxs, events, links


def _write(store, A, AS, C, E, ES):
    """One artifact in, one out, an execution published in two contexts."""
    src = A(type_name="Examples", uri="/x", state=AS.LIVE, properties=PROPS)
    store.put_artifact(src)
    ctxs = [C("pipeline", "p", properties={"k": 1}),
            C("pipeline_run", "p.r1", properties={"run_id": "r1"})]
    out = A(type_name="Model", uri="/m", properties={"acc": 0.75})
    ex = E(type_name="Trainer", node_id="Trainer", state=ES.COMPLETE,
           properties=PROPS, cache_key="key-1")
    store.publish_execution(ex, {"examples": [src]}, {"model": [out]}, ctxs)
    return ex


def test_cross_backend_file_compatibility(tmp_path):
    """The port's native core writes; the JAX package's Python store reads
    the same rows; the JAX package writes, the port's native core reads."""
    path = str(tmp_path / "native.sqlite")
    native = NativeMetadataStore(path)
    _write(native, Artifact, ArtifactState, Context, Execution, ExecutionState)
    written = _rows(native)
    native.close()
    ref = RefStore(path)
    assert _rows(ref) == written
    art = ref.get_artifact(1)
    art.state = RefArtifactState.DELETED
    ref.put_artifact(art)
    ref.close()
    again = NativeMetadataStore(path)
    assert again.get_artifact(1).state == ArtifactState.DELETED
    again.close()

    path = str(tmp_path / "ref.sqlite")
    ref = RefStore(path)
    _write(ref, RefArtifact, RefArtifactState, RefContext, RefExecution,
           RefExecutionState)
    want = _rows(ref)
    ref.close()
    native = NativeMetadataStore(path)
    assert _rows(native) == want
    assert native.get_cached_outputs("key-1")["model"][0].uri == "/m"
    native.close()


def test_both_port_backends_hold_the_same_rows(tmp_path):
    """The same writes through the port's two backends give the same rows
    (times aside, which each write stamps)."""
    got = []
    for cls in (MetadataStore, NativeMetadataStore):
        store = cls(str(tmp_path / f"{cls.__name__}.sqlite"))
        _write(store, Artifact, ArtifactState, Context, Execution,
               ExecutionState)
        got.append(_rows(store, times=False))
        store.close()
    assert got[0] == got[1]


def test_unpersisted_id_zero_matches_nothing(tmp_path):
    s = NativeMetadataStore(str(tmp_path / "md.sqlite"))
    s.put_artifact(Artifact(type_name="Examples", uri="/x"))
    assert s.get_artifact(0) is None
    assert s.get_execution(0) is None
    assert s.get_events_by_artifact(0) == []
    assert s.get_events_by_execution(0) == []
    s.close()


def test_publish_rollback_is_atomic(tmp_path):
    """A failing publish in the native backend leaves no partial rows."""
    s = NativeMetadataStore(str(tmp_path / "md.sqlite"))
    out_art = Artifact(type_name="Model", uri="/m")
    bad_input = Artifact(type_name="Examples", uri="/e")  # no id -> assert
    ex = Execution(type_name="Trainer", node_id="Trainer",
                   state=ExecutionState.COMPLETE)
    with pytest.raises(AssertionError):
        s.publish_execution(ex, {"examples": [bad_input]}, {"model": [out_art]})
    assert s.get_executions() == []
    assert s.get_artifacts() == []
    s.close()


def test_open_store_backend_selection(tmp_path, monkeypatch):
    """The reference's rules: the env (or argument) picks the backend;
    here the toolchain is present, so "native" serves the native class,
    built under the port's ``_build/``."""
    monkeypatch.setenv("TPP_METADATA_BACKEND", "native")
    s = open_store(str(tmp_path / "a.sqlite"))
    assert type(s) is NativeMetadataStore
    s.close()
    build_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tpu_pipelines_torch", "_build")
    assert library_path().startswith(build_dir + os.sep)
    assert type(open_store(str(tmp_path / "a2.sqlite"), backend="python")) \
        is MetadataStore
    monkeypatch.setenv("TPP_METADATA_BACKEND", "python")
    s2 = open_store(str(tmp_path / "b.sqlite"))
    assert type(s2) is MetadataStore
    s2.close()
    s3 = open_store(str(tmp_path / "b2.sqlite"), backend="native")
    assert type(s3) is NativeMetadataStore
    s3.close()
    monkeypatch.setenv("TPP_METADATA_BACKEND", "bogus")
    with pytest.raises(ValueError, match="unknown metadata backend 'bogus'"):
        open_store(str(tmp_path / "c.sqlite"))


def test_a_native_build_failure_falls_back_to_python_with_a_warning(
        tmp_path, monkeypatch, caplog):
    """A host that cannot build the core (no compiler, no libsqlite3) gets
    the Python store and a warning naming why, as the reference's
    ``open_store`` does."""
    from tpu_pipelines_torch.metadata import native_store
    from tpu_pipelines_torch.ops import _build

    def no_compiler(*args, **kwargs):
        raise RuntimeError("g++ failed for metadata_core.cc: not found")

    monkeypatch.setattr(native_store, "_lib", None)
    monkeypatch.setattr(_build, "load_host", no_compiler)
    with caplog.at_level(logging.WARNING, "tpu_pipelines_torch.metadata"):
        s = open_store(str(tmp_path / "d.sqlite"), backend="native")
    assert type(s) is MetadataStore
    s.close()
    assert "native metadata backend unavailable" in caplog.text
    assert "g++ failed" in caplog.text


def test_sqlite_library_is_found(monkeypatch):
    """The library the core links: a system ``libsqlite3.so*``, else the
    one the interpreter's ``_sqlite3`` links (read with ``ldd``)."""
    from tpu_pipelines_torch.ops import _build

    path = _build.sqlite_library()
    assert os.path.basename(path).startswith("libsqlite3.so")
    monkeypatch.setattr(_build, "_SQLITE_CANDIDATES", ())
    linked = _build.sqlite_library()
    assert os.path.realpath(linked) == os.path.realpath(path)


def _stats_pipeline(pkg, tmp_path, tag):
    import importlib

    comps = importlib.import_module(f"{pkg}.components")
    Pipeline = importlib.import_module(f"{pkg}.dsl.pipeline").Pipeline
    csv = tmp_path / "d.csv"
    if not csv.exists():
        csv.write_text("a,b\n" + "\n".join(f"{i},{i * 2}" for i in range(20))
                       + "\n")
    gen = comps.CsvExampleGen(input_path=str(csv))
    stats = comps.StatisticsGen(examples=gen.outputs["examples"])
    return Pipeline("native-md", [gen, stats],
                    pipeline_root=str(tmp_path / tag / "root"),
                    metadata_path=str(tmp_path / tag / "md.sqlite"))


def test_pipeline_runs_on_native_backend(tmp_path, monkeypatch):
    """CsvExampleGen -> StatisticsGen with TPP_METADATA_BACKEND=native:
    cold every node COMPLETE (the reference's run on its Python store
    gives the same statuses and execution ids), then all CACHED; the
    store the runner opened is the native class."""
    from tpu_pipelines.orchestration import LocalDagRunner as RefRunner
    from tpu_pipelines_torch.orchestration import LocalDagRunner, local_runner

    monkeypatch.setenv("TPP_DATA_POOL", "thread")  # no fork under JAX's threads
    ref = RefRunner().run(_stats_pipeline("tpu_pipelines", tmp_path, "ref"))
    monkeypatch.setenv("TPP_METADATA_BACKEND", "native")
    opened = []
    real = local_runner.open_store
    monkeypatch.setattr(local_runner, "open_store",
                        lambda *a, **k: opened.append(real(*a, **k)) or opened[-1])
    runs = [LocalDagRunner(device="cpu").run(
        _stats_pipeline("tpu_pipelines_torch", tmp_path, "port"))
        for _ in range(2)]
    assert [type(s) for s in opened] == [NativeMetadataStore] * 2
    cold, warm = ({k: (v.status, v.execution_id) for k, v in r.nodes.items()}
                  for r in runs)
    assert cold == {k: (v.status, v.execution_id)
                    for k, v in ref.nodes.items()}
    assert {s for s, _ in cold.values()} == {"COMPLETE"}
    assert {s for s, _ in warm.values()} == {"CACHED"}
    # The Python backend (and the reference's store) read the same runs.
    port_md = str(tmp_path / "port" / "md.sqlite")
    for cls in (MetadataStore, RefStore):
        store = cls(port_md)
        assert [c.name.split(".")[0] for c in
                store.get_contexts("pipeline_run")] == ["native-md"] * 2
        store.close()
