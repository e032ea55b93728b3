"""Port parity: the measured crossovers "auto" attention reads
(``tpu_pipelines_torch/ops/autotune.py``) against the reference's
``tpu_pipelines/ops/autotune.py``, and the two "auto" rules of
``models/transformer.py`` against the reference's.

Exact comparisons throughout (table bytes, looked-up values, decisions):
there is no arithmetic to round.  Every test points both packages' user
cache at one temporary directory (``TPP_AUTOTUNE_CACHE``) and drops both
memos.
"""

import json
import os

import pytest

from tpu_pipelines.models import transformer as ref_tfm
from tpu_pipelines.ops import autotune as ref_at
from tpu_pipelines_torch.models import transformer as port_tfm
from tpu_pipelines_torch.ops import autotune as port_at

KIND = "NVIDIA H100 80GB HBM3"
COMMITTED = os.path.join(os.path.dirname(port_at.__file__), "autotune_table.json")


@pytest.fixture()
def iso_cache(tmp_path, monkeypatch):
    cache = tmp_path / "autotune"
    monkeypatch.setenv("TPP_AUTOTUNE_CACHE", str(cache))
    ref_at.clear_memo()
    port_at.clear_memo()
    yield str(cache)
    ref_at.clear_memo()
    port_at.clear_memo()


def _committed(monkeypatch, tmp_path, table):
    """Point both packages' committed table at one file holding ``table``."""
    path = tmp_path / "committed.json"
    path.write_text(json.dumps(table))
    monkeypatch.setattr(ref_at, "_COMMITTED_TABLE", str(path))
    monkeypatch.setattr(port_at, "_COMMITTED_TABLE", str(path))
    return path


def _record(module, kind):
    module.record_crossover(kind, 512, geometry={"batch": 8, "per_len": {
        "64": {"flash_ms": 0.05, "dense_ms": 0.04}}}, source="test")
    module.record_decode_crossover(kind, 128, geometry={"batch": 32},
                                   source="test")


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_table_either_package_writes_the_other_reads_alike(iso_cache, writer):
    write, read = (ref_at, port_at) if writer == "reference" else (port_at, ref_at)
    _record(write, KIND)
    read.clear_memo()
    assert read.lookup_crossover(KIND) == 512
    assert read.lookup_decode_crossover(KIND) == 128
    assert write.cache_path(KIND) == read.cache_path(KIND)


def test_the_two_packages_write_the_same_bytes(iso_cache, tmp_path, monkeypatch):
    _record(ref_at, KIND)
    with open(ref_at.cache_path(KIND), "rb") as f:
        ref_bytes = f.read()
    monkeypatch.setenv("TPP_AUTOTUNE_CACHE", str(tmp_path / "port"))
    _record(port_at, KIND)
    with open(port_at.cache_path(KIND), "rb") as f:
        assert f.read() == ref_bytes


def test_measured_none_is_recorded_distinctly_and_shadows_the_committed_table(
        iso_cache, tmp_path, monkeypatch):
    _committed(monkeypatch, tmp_path, {"crossover": {KIND: {
        "crossover_seq_len": 1024}}, "decode_crossover": {KIND: {
            "crossover_kv_len": 256}}})
    # Never measured here: the committed records answer.
    for at in (ref_at, port_at):
        at.clear_memo()
        assert (at.lookup_crossover(KIND), at.lookup_decode_crossover(KIND)) == (
            1024, 256)
    # Measured none: an explicit null in the user cache, which shadows them.
    port_at.record_crossover(KIND, None, source="test")
    port_at.record_decode_crossover(KIND, None, source="test")
    table = json.load(open(port_at.cache_path(KIND)))
    assert table["crossover"][KIND]["crossover_seq_len"] is None
    assert table["decode_crossover"][KIND]["crossover_kv_len"] is None
    for at in (ref_at, port_at):
        at.clear_memo()
        assert at.lookup_crossover(KIND) is None
        assert at.lookup_decode_crossover(KIND) is None
    assert port_at.committed_crossovers() == ref_at.committed_crossovers() == {
        KIND: 1024}


@pytest.mark.parametrize("content", [
    '{"crossover": {"NVIDIA H100 80GB HBM3": {"crossover_seq_len": 6',
    "not json at all",
    "",
    "[1, 2, 3]",
])
def test_a_torn_or_corrupt_table_reads_as_empty(iso_cache, content, tmp_path,
                                                monkeypatch):
    _committed(monkeypatch, tmp_path, {})   # nothing to fall back to
    path = port_at.cache_path(KIND)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(content)
    for at in (ref_at, port_at):
        at.clear_memo()
        assert at._load_table(path) == {}
        assert at.lookup_crossover(KIND) is None
        assert at.lookup_decode_crossover(KIND) is None
    port_at.record_crossover(KIND, 64, source="test")  # overwrites cleanly
    ref_at.clear_memo()
    assert ref_at.lookup_crossover(KIND) == port_at.lookup_crossover(KIND) == 64


def test_the_committed_table_is_the_fallback_and_holds_only_card_measurements(
        iso_cache):
    """The port's committed table: every record measured on the card by
    chip_smoke.py, with its per-length times and the card's nvidia-smi
    line; read when the user cache has nothing for the kind."""
    with open(COMMITTED) as f:
        table = json.load(f)
    assert table["entries"] == {}
    for section, field, lengths in (("crossover", "crossover_seq_len", "per_len"),
                                    ("decode_crossover", "crossover_kv_len",
                                     "per_kv_len")):
        for kind, rec in table.get(section, {}).items():
            assert kind.startswith("NVIDIA"), kind
            assert rec["source"] == "chip_smoke.py crossover phase"
            assert rec["geometry"]["card"].startswith(kind)
            assert rec["geometry"][lengths]
            lookup = (port_at.lookup_crossover if section == "crossover"
                      else port_at.lookup_decode_crossover)
            assert lookup(kind) == rec[field]
    assert port_at.committed_crossovers() == {
        kind: rec["crossover_seq_len"]
        for kind, rec in table.get("crossover", {}).items()
        if rec["crossover_seq_len"] is not None}
    assert port_at.current_device_kind("cpu") == "cpu"
    assert port_at.lookup_crossover("cpu") is None
    assert port_at.lookup_decode_crossover("cpu") is None


GRID_LENGTHS = (32, 63, 64, 128, 1023, 1024, 8192)
GRID_CROSSOVERS = (None, 64, 1024)


@pytest.mark.parametrize("fits", [True, False])
@pytest.mark.parametrize("crossover", GRID_CROSSOVERS)
@pytest.mark.parametrize("length", GRID_LENGTHS)
def test_choose_attn_impl_decides_as_the_reference(monkeypatch, length,
                                                   crossover, fits):
    for tfm, at in ((ref_tfm, ref_at), (port_tfm, port_at)):
        monkeypatch.setattr(tfm, "dense_attn_fits", lambda *a, **k: fits)
        monkeypatch.setattr(at, "lookup_crossover", lambda *a, **k: crossover)
    for seq_q, seq_kv in ((length, length), (1, length), (length, 1)):
        want = ref_tfm.choose_attn_impl(8, 12, seq_q, seq_kv, 2)
        assert port_tfm.choose_attn_impl(8, 12, seq_q, seq_kv, 2,
                                         device="cpu") == want


@pytest.mark.parametrize("crossover", GRID_CROSSOVERS)
@pytest.mark.parametrize("length", GRID_LENGTHS)
def test_choose_decode_impl_decides_as_the_reference(monkeypatch, length,
                                                     crossover):
    monkeypatch.setattr(ref_at, "lookup_decode_crossover",
                        lambda *a, **k: crossover)
    monkeypatch.setattr(port_at, "lookup_decode_crossover",
                        lambda *a, **k: crossover)
    want = ref_tfm.choose_decode_impl(32, 8, length, 64)
    assert port_tfm.choose_decode_impl(32, 8, length, 64, device="cpu") == want


def test_both_rules_key_by_the_devices_kind(iso_cache):
    """A crossover recorded for one kind moves no other kind's choice."""
    port_at.record_crossover(KIND, 64, source="test")
    port_at.record_decode_crossover(KIND, 32, source="test")
    assert port_tfm.choose_attn_impl(8, 12, 128, 128, 2, device="cpu") == "dense"
    assert port_tfm.choose_decode_impl(32, 8, 128, 64, device="cpu") == "dense"
    port_at.record_crossover("cpu", 64, source="test")
    port_at.record_decode_crossover("cpu", 32, source="test")
    assert port_tfm.choose_attn_impl(8, 12, 128, 128, 2, device="cpu") == "flash"
    assert port_tfm.choose_decode_impl(32, 8, 128, 64, device="cpu") == "flash"


@pytest.mark.parametrize("shape", [(8, 12, 128, 128), (8, 12, 2048, 2048),
                                   (256, 12, 64, 64)])
def test_on_the_cpu_with_no_entry_both_rules_stay_dense(iso_cache, shape):
    assert ref_at.current_device_kind() == port_at.current_device_kind("cpu")
    want = ref_tfm.choose_attn_impl(*shape, 2)
    assert want == "dense"
    assert port_tfm.choose_attn_impl(*shape, 2, device="cpu") == want
    assert ref_tfm.choose_decode_impl(shape[0], shape[1], shape[2], 64) == \
        port_tfm.choose_decode_impl(shape[0], shape[1], shape[2], 64,
                                    device="cpu") == "dense"
