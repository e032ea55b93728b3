"""Port parity: the autotuner (``tpu_pipelines_torch/ops/autotune.py``)
against the reference's ``tpu_pipelines/ops/autotune.py`` (the reference's
``tests/test_autotune.py`` held on the port), and the two "auto" rules of
``models/transformer.py`` against the reference's.

The block half: ``key_id`` byte for byte the reference's for the same
shapes, dtypes and kinds; entries written by either package read alike by
the other, in the same bytes, and across processes; ``cache-only`` never
sweeps, ``off`` bypasses the table, no sweep while the stream captures, a
sweep of a CPU tensor raises; a corrupt cache reads as empty; explicit
blocks bypass the table and the table's blocks reach the kernels' C calls
(stubbed to record their arguments); the card's clamping and candidate
rules, with ``TPP_AUTOTUNE_BLOCKS`` and the shared-memory filter.  The
sweep's bookkeeping runs under a stand-in timer (the CPU has no kernel to
time).

Exact comparisons throughout (table bytes, looked-up values, decisions):
there is no arithmetic to round.  Every test points both packages' user
cache at one temporary directory (``TPP_AUTOTUNE_CACHE``) and drops both
memos.
"""

import contextlib
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pipelines.models import transformer as ref_tfm
from tpu_pipelines.ops import autotune as ref_at
from tpu_pipelines_torch.models import transformer as port_tfm
from tpu_pipelines_torch.ops import _build
from tpu_pipelines_torch.ops import autotune as port_at
from tpu_pipelines_torch.ops import flash_attention as fa

KIND = "NVIDIA H100 80GB HBM3"
COMMITTED = os.path.join(os.path.dirname(port_at.__file__), "autotune_table.json")


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def iso_cache(tmp_path, monkeypatch):
    cache = tmp_path / "autotune"
    monkeypatch.setenv("TPP_AUTOTUNE_CACHE", str(cache))
    for name in ("TPP_AUTOTUNE", "TPP_AUTOTUNE_BLOCKS", "TPP_AUTOTUNE_ITERS"):
        monkeypatch.delenv(name, raising=False)
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
    chip_smoke.py, with its per-length times (each block entry with its
    swept grid and the repeats that promoted it, with and without the
    paths' masks) and the card's nvidia-smi
    line; read when the user cache has nothing for the kind."""
    with open(COMMITTED) as f:
        table = json.load(f)
    for kid, entry in table["entries"].items():
        key = entry["key"]
        assert key["device_kind"].startswith("NVIDIA"), key
        assert port_at.key_id(key) == ref_at.key_id(key) == kid
        assert entry["source"].startswith(
            f"chip_smoke.py autotune phase, {key['device_kind']}")
        pair = (entry["block_q"], entry["block_k"])
        assert pair in port_at.valid_pairs(key["op"], getattr(
            torch, key["dtype"]), key["head_dim"])
        assert pair in [(r["block_q"], r["block_k"]) for r in entry["swept"]]
        # Promoted only where the winner beat 64 x 64 by more than its own
        # spread on the swept inputs and on the path's masks alike.
        repeats = entry["repeats"]
        for prefix in ("", "masked_"):
            win = sorted(repeats[f"{prefix}winner_ms"])
            base = sorted(repeats[f"{prefix}default_ms"])
            assert base[len(base) // 2] - win[len(win) // 2] > win[-1] - win[0]
        assert port_at._lookup_entry(kid, key["device_kind"]) == entry
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


# ------------------------------------------------------------ block half

SHAPES = [("flash_fwd", 256, 12, 128, 64, False), ("flash_bwd", 32, 12, 128, 64, False),
          ("flash_fwd", 8, 12, 2048, 64, True), ("flash_decode", 4, 8, 4096, 64, False),
          ("flash_decode", 256, 8, 32, 128, False)]
DTYPES = [(torch.bfloat16, jnp.bfloat16), (torch.float16, jnp.float16),
          (torch.float32, jnp.float32)]


def _counter(name, op):
    from tpu_pipelines_torch.observability.metrics import default_registry

    metric = default_registry().get(name)
    if metric is None:
        return 0.0
    return sum(float(v) for labels, v in metric._snapshot_series().items()
               if op in labels)


@pytest.mark.parametrize("kind", [KIND, "TPU v5 lite", "cpu"])
@pytest.mark.parametrize("dtypes", DTYPES, ids=lambda d: str(d[0]))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}-{s[1]}-{s[3]}")
def test_key_id_is_the_references_byte_for_byte(shape, dtypes, kind):
    op, b, h, l, d, causal = shape
    torch_dtype, jax_dtype = dtypes
    want = ref_at.make_key(op, b, h, l, d, str(jnp.dtype(jax_dtype)), causal, kind)
    got = port_at.make_key(op, b, h, l, d, torch_dtype, causal, kind)
    assert got == want and got["dtype"] == str(torch_dtype).replace("torch.", "")
    assert port_at.key_id(got) == ref_at.key_id(want)
    assert port_at._shape_key_id(op, b, h, l, d, port_at.dtype_name(torch_dtype),
                                 causal, kind) == ref_at.key_id(want)


def _entries(module, kind=KIND):
    for op, b, h, l, d, causal in SHAPES:
        module.record_entry(module.make_key(op, b, h, l, d, "bfloat16", causal,
                                            kind), 128, 64, 0.1063,
                            swept=[{"block_q": 128, "block_k": 64, "ms": 0.1063}],
                            source="test")


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_block_entries_either_package_writes_the_other_reads_alike(
        iso_cache, writer, monkeypatch):
    write = ref_at if writer == "reference" else port_at
    _entries(write)
    monkeypatch.setattr(port_at, "current_device_kind", lambda device=None: KIND)
    for op, b, h, l, d, causal in SHAPES:
        for at in (ref_at, port_at):
            at.clear_memo()
        ref = ref_at._lookup_entry(ref_at.key_id(ref_at.make_key(
            op, b, h, l, d, "bfloat16", causal, KIND)), KIND)
        assert (ref["block_q"], ref["block_k"]) == (128, 64)
        assert port_at.get_block_config(op, b, h, l, d, torch.bfloat16, causal,
                                        device="cpu") == (128, 64)


def test_block_entries_are_written_in_the_same_bytes(iso_cache, tmp_path,
                                                     monkeypatch):
    _entries(ref_at)
    with open(ref_at.cache_path(KIND), "rb") as f:
        ref_bytes = f.read()
    monkeypatch.setenv("TPP_AUTOTUNE_CACHE", str(tmp_path / "port"))
    _entries(port_at)
    with open(port_at.cache_path(KIND), "rb") as f:
        assert f.read() == ref_bytes


def test_an_entry_round_trips_across_processes(iso_cache):
    prog = (
        "import torch\n"
        "from tpu_pipelines_torch.ops import autotune as at\n"
        "key = at.make_key('flash_fwd', 1, 2, 64, 64, torch.bfloat16, True, 'cpu')\n"
        "print(at.record_entry(key, 128, 32, 1.25, source='test'))\n"
    )
    env = {**os.environ, "TPP_AUTOTUNE_CACHE": iso_cache, "PYTHONHASHSEED": "7"}
    res = subprocess.run([sys.executable, "-c", prog], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True, timeout=120)
    kid = res.stdout.strip()
    assert kid == port_at.key_id(port_at.make_key(
        "flash_fwd", 1, 2, 64, 64, torch.bfloat16, True, "cpu"))
    assert port_at.get_block_config("flash_fwd", 1, 2, 64, 64, torch.bfloat16,
                                    True, device="cpu") == (128, 32)
    assert ref_at.get_block_config("flash_fwd", 1, 2, 64, 64, "bfloat16",
                                   True) == (128, 32)


def test_cache_only_never_sweeps_and_off_bypasses_the_table(iso_cache,
                                                            monkeypatch):
    def boom(*a, **k):
        raise AssertionError("cache-only mode must not sweep")

    monkeypatch.setattr(port_at, "sweep_flash", boom)
    monkeypatch.setattr(port_at, "sweep_decode", boom)
    for op in ("flash_fwd", "flash_decode"):
        misses = _counter("autotune_cache_misses_total", op)
        assert port_at.get_block_config(op, 1, 2, 64, 64, torch.bfloat16, False,
                                        device="cpu") is None
        assert _counter("autotune_cache_misses_total", op) == misses + 1
    port_at.record_entry(port_at.make_key("flash_fwd", 1, 2, 64, 64,
                                          torch.bfloat16, False, "cpu"), 64, 128, 1.0)
    hits = _counter("autotune_cache_hits_total", "flash_fwd")
    for mode, want in (("0", None), ("off", None), ("cache-only", (64, 128)),
                       ("anything", (64, 128))):
        monkeypatch.setenv("TPP_AUTOTUNE", mode)
        assert port_at.autotune_mode() == ref_at.autotune_mode()
        assert port_at.get_block_config("flash_fwd", 1, 2, 64, 64, torch.bfloat16,
                                        False, device="cpu") == want
    # "anything" reads as cache-only: the shape is already resolved for this
    # state of the tables, so only the first of the two lookups counts.
    assert _counter("autotune_cache_hits_total", "flash_fwd") == hits + 1


def test_a_shape_resolves_once_per_state_of_the_tables(iso_cache, monkeypatch):
    """Eager callers ask for every launch; each counter moves once per shape
    (the reference resolves once per trace) until a table changes."""
    args = ("flash_fwd", 2, 2, 64, 64, torch.bfloat16, False)
    misses = _counter("autotune_cache_misses_total", "flash_fwd")
    for _ in range(3):
        assert port_at.get_block_config(*args, device="cpu") is None
    assert _counter("autotune_cache_misses_total", "flash_fwd") == misses + 1
    port_at.record_entry(port_at.make_key(*args, "cpu"), 128, 64, 1.0)
    hits = _counter("autotune_cache_hits_total", "flash_fwd")
    for _ in range(3):
        assert port_at.get_block_config(*args, device="cpu") == (128, 64)
    assert _counter("autotune_cache_hits_total", "flash_fwd") == hits + 1
    # Another process's record changes the table's stamp: resolved anew
    # once the stamp is read again (at most _RESTAT_S later; 0 here).
    monkeypatch.setattr(port_at, "_RESTAT_S", 0.0)
    subprocess.run([sys.executable, "-c", (
        "from tpu_pipelines_torch.ops import autotune as at; import torch; "
        "at.record_entry(at.make_key('flash_fwd', 2, 2, 64, 64, torch.bfloat16, "
        "False, 'cpu'), 64, 32, 0.5)")], check=True, cwd=REPO, timeout=120)
    assert port_at.get_block_config(*args, device="cpu") == (64, 32)
    assert _counter("autotune_cache_hits_total", "flash_fwd") == hits + 2
    # A miss while the stream captures is not kept: the next lookup outside
    # the capture sweeps.
    monkeypatch.setenv("TPP_AUTOTUNE", "sweep")
    monkeypatch.setattr(port_at, "current_device_kind", lambda device=None: KIND)
    swept = []

    def sweep(*a, **k):
        swept.append(a)
        return {"flash_fwd": {"best": {"block_q": 64, "block_k": 128, "ms": 1.0},
                              "swept": []}}

    monkeypatch.setattr(port_at, "sweep_flash", sweep)
    capturing = [True]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    assert port_at.get_block_config(*args, device="cuda") is None
    assert not swept
    capturing[0] = False
    assert port_at.get_block_config(*args, device="cuda") == (64, 128)
    assert port_at.get_block_config(*args, device="cuda") == (64, 128)
    assert len(swept) == 1


def test_no_sweep_while_the_stream_captures_and_none_on_the_cpu(iso_cache,
                                                                monkeypatch):
    def boom(*a, **k):
        raise AssertionError("no sweep while capturing")

    monkeypatch.setenv("TPP_AUTOTUNE", "sweep")
    monkeypatch.setattr(port_at, "sweep_flash", boom)
    monkeypatch.setattr(port_at, "current_device_kind", lambda device=None: KIND)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    sweeps = _counter("autotune_sweeps_total", "flash_fwd")
    misses = _counter("autotune_cache_misses_total", "flash_fwd")
    assert port_at.get_block_config("flash_fwd", 2, 2, 64, 64, torch.bfloat16,
                                    False, device="cuda") is None
    assert _counter("autotune_cache_misses_total", "flash_fwd") == misses + 1
    assert _counter("autotune_sweeps_total", "flash_fwd") == sweeps
    monkeypatch.undo()
    # A sweep of CPU tensors raises, naming the device: the plain versions
    # are never timed.
    with pytest.raises(ValueError, match="device cpu"):
        port_at.sweep_flash(1, 2, 64, 64, torch.bfloat16, False, device="cpu")
    with pytest.raises(ValueError, match="device cpu"):
        port_at.sweep_decode(1, 2, 64, 64, torch.bfloat16, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPP_AUTOTUNE", "sweep")
        q = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="device cpu"):
            fa.flash_attention(q, q, q)


def _stand_in_timer(times):
    """A timer that never runs the launch: the next of ``times`` each call."""
    seq = iter(times)
    return lambda fn, iters: next(seq)


def test_a_sweep_records_each_ops_winner_and_then_hits(iso_cache, monkeypatch):
    monkeypatch.setenv("TPP_AUTOTUNE", "sweep")
    monkeypatch.setattr(port_at, "_sweep_device", lambda device, op: torch.device("cpu"))
    pairs = port_at.candidate_pairs("flash_fwd", torch.bfloat16, 64)
    assert pairs == list(fa.FLASH_BLOCKS)
    # The forward's times, then the backward's: each leg has its own winner.
    fwd = [0.2, 0.15, 0.3, 0.1, 0.12, 0.4]
    bwd = [0.5, 0.35, 0.6, 0.45, 0.4, 0.7]
    real = port_at.sweep_flash
    monkeypatch.setattr(port_at, "sweep_flash", lambda *a, **k: real(
        *a, **k, timer=_stand_in_timer(fwd + bwd)))
    before = {op: (_counter("autotune_sweeps_total", op),
                   _counter("autotune_cache_misses_total", op))
              for op in ("flash_fwd", "flash_bwd")}
    got = port_at.get_block_config("flash_fwd", 2, 2, 64, 64, torch.bfloat16,
                                   False, device="cpu")
    assert got == (128, 32)
    for op, best, times in (("flash_fwd", (128, 32), fwd),
                            ("flash_bwd", (64, 64), bwd)):
        entry = port_at._lookup_entry(port_at.key_id(port_at.make_key(
            op, 2, 2, 64, 64, torch.bfloat16, False, "cpu")), "cpu")
        assert (entry["block_q"], entry["block_k"]) == best
        assert [(r["block_q"], r["block_k"], r["ms"]) for r in entry["swept"]] == [
            (*p, t) for p, t in zip(pairs, times)]
        assert _counter("autotune_sweeps_total", op) == before[op][0] + 1
    assert _counter("autotune_cache_misses_total", "flash_fwd") == \
        before["flash_fwd"][1] + 1
    # The backward's lookup, and every later one, a hit: no second sweep.
    port_at.clear_memo()
    monkeypatch.setattr(port_at, "sweep_flash", None)
    assert port_at.get_block_config("flash_bwd", 2, 2, 64, 64, torch.bfloat16,
                                    False, device="cpu") == (64, 64)
    assert _counter("autotune_cache_misses_total", "flash_bwd") == before["flash_bwd"][1]


def test_a_decode_sweep_tunes_block_k(iso_cache, monkeypatch):
    monkeypatch.setattr(port_at, "_sweep_device", lambda device, op: torch.device("cpu"))
    out = port_at.sweep_decode(4, 2, 300, 64, torch.float16, device="cpu",
                               timer=_stand_in_timer([0.03, 0.02, 0.025]))
    best = out["flash_decode"]["best"]
    assert (best["block_q"], best["block_k"], best["ms"]) == (1, 64, 0.02)
    assert [r["block_k"] for r in out["flash_decode"]["swept"]] == list(fa.DECODE_BLOCKS)
    # An override naming an unbuilt block gets an error row, never a time.
    monkeypatch.setenv("TPP_AUTOTUNE_BLOCKS", "1x32,1x256")
    out = port_at.sweep_decode(4, 2, 300, 64, torch.float16, device="cpu",
                               timer=_stand_in_timer([0.03]))
    assert out["flash_decode"]["best"]["block_k"] == 32
    assert "error" in out["flash_decode"]["swept"][1]


def test_clamping_follows_the_cards_rule():
    # bf16 and fp16 at D = 64 and 128: block_q in {64, 128}, block_k in
    # {32, 64, 128}; every other dtype and head dim 64 x 64 alone.
    for dtype in (torch.bfloat16, torch.float16):
        for d in (64, 128):
            assert port_at.valid_blocks("flash_fwd", dtype, d, "block_q") == [64, 128]
            assert port_at.valid_blocks("flash_bwd", dtype, d, "bwd_block_k") == [
                32, 64, 128]
            assert port_at.valid_blocks("flash_decode", dtype, d) == [32, 64, 128]
            assert port_at.clamp_block("flash_fwd", dtype, d, 100, "block_q") == 64
            assert port_at.clamp_block("flash_fwd", dtype, d, 1000, "block_k") == 128
            assert port_at.clamp_block("flash_fwd", dtype, d, 40, "block_k") == 32
    for dtype, d in ((torch.float32, 64), (torch.bfloat16, 32), (torch.float16, 16)):
        assert port_at.valid_pairs("flash_fwd", dtype, d) == [(64, 64)]
        assert port_at.valid_pairs("flash_decode", dtype, d) == [(1, 64)]
        assert port_at.clamp_block("flash_bwd", dtype, d, 128, "bwd_block_q") == 64
    # No L-divisibility rule: the kernels mask ragged keys.
    with pytest.raises(ValueError, match=r"no valid block_q <= 32 .*valid: \[64, 128\]"):
        port_at.clamp_block("flash_fwd", torch.bfloat16, 64, 32, "block_q")
    with pytest.raises(ValueError, match=r"valid: \[64\]"):
        port_at.clamp_block("flash_decode", torch.float32, 64, 32, "block_k")


def test_candidates_take_the_override_and_the_shared_memory_filter(monkeypatch):
    monkeypatch.delenv("TPP_AUTOTUNE_BLOCKS", raising=False)
    assert port_at.candidate_pairs("flash_bwd", torch.float16, 128) == list(
        fa.FLASH_BLOCKS)
    monkeypatch.setenv("TPP_AUTOTUNE_BLOCKS", "128x128, 64x32,")
    assert port_at.candidate_pairs("flash_fwd", torch.bfloat16, 64) == [
        (128, 128), (64, 32)]
    assert port_at.candidate_pairs("flash_decode", torch.bfloat16, 64) == [
        (1, 128), (1, 32)]
    monkeypatch.delenv("TPP_AUTOTUNE_BLOCKS")
    # The filter: a pair whose fixed tiles exceed what a block may opt into
    # is not valid at that head dim.  Every pair fits the card's 227 KB (dq
    # at 128 x 128, D = 128: 192 KB; dk/dv 194 KB); under a 160 KB limit
    # the backward loses the pairs whose dk/dv tiles exceed it at D = 128.
    assert fa.smem_bytes("dq", 128, 128, 128) == 196608
    assert fa.smem_bytes("dkv", 128, 128, 128) == 198656
    assert fa.smem_bytes("dkv", 128, 64, 128) == 165888
    assert fa.smem_bytes("fwd", 128, 128, 128) == 163840
    monkeypatch.setattr(fa, "MAX_SMEM_BYTES", 160 * 1024)
    assert port_at.valid_pairs("flash_fwd", torch.bfloat16, 128) == list(
        fa.FLASH_BLOCKS)    # 128 x 128: exactly 160 KB
    assert port_at.candidate_pairs("flash_bwd", torch.bfloat16, 128) == [
        (64, 32), (64, 64), (64, 128), (128, 32)]
    assert port_at.valid_pairs("flash_bwd", torch.bfloat16, 64) == list(
        fa.FLASH_BLOCKS)


def _qkv(b=2, l=64, h=2, d=64, dtype=torch.bfloat16):
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.normal(size=(b, l, h, d)).astype(np.float32))
            .to(dtype) for _ in range(3)]


def test_explicit_blocks_bypass_the_table(iso_cache, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("explicit blocks must bypass the table")

    monkeypatch.setattr(port_at, "get_block_config", boom)
    q, k, v = _qkv()
    assert fa.resolve_blocks(q, False, 128, 32) == (128, 32, 128, 32)
    assert fa.resolve_blocks(q, False, None, 128, 64, 32) == (64, 128, 64, 32)
    assert fa.resolve_decode_block(2, 2, 64, 64, q.dtype, "cpu", 128) == 128
    out = fa.flash_attention(q, k, v, block_q=128, block_k=128)
    assert out.shape == q.shape
    with pytest.raises(AssertionError, match="bypass"):
        fa.flash_attention(q, k, v)


def test_table_blocks_reach_the_function_and_its_kernels(iso_cache, monkeypatch):
    """Seeded entries flow through ``flash_attention`` into the forward's
    and the backward's wrappers (the reference's precedence: the backward
    its own entry), and the plain versions ignore them."""
    for op, blocks in (("flash_fwd", (128, 32)), ("flash_bwd", (64, 128)),
                       ("flash_decode", (1, 32))):
        port_at.record_entry(port_at.make_key(op, 2, 2, 64, 64, torch.bfloat16,
                                              False, "cpu"), *blocks, ms=1.0)
    seen = {}
    for name in ("flash_attention_forward", "flash_bwd_dq", "flash_bwd_dkv"):
        real = getattr(fa, name)

        def spy(*a, _real=real, _name=name, **kw):
            seen[_name] = (kw["block_q"], kw["block_k"])
            return _real(*a, **kw)

        monkeypatch.setattr(fa, name, spy)
    q, k, v = (t.requires_grad_() for t in _qkv())
    out = fa.flash_attention(q, k, v)
    out.float().sum().backward()
    assert seen == {"flash_attention_forward": (128, 32),
                    "flash_bwd_dq": (64, 128), "flash_bwd_dkv": (64, 128)}
    want = fa.flash_attention_reference(q.detach(), k.detach(), v.detach())[0]
    assert torch.equal(out.detach(), want)
    assert fa.resolve_decode_block(2, 2, 64, 64, torch.bfloat16, "cpu") == 32


class _Recorder:
    """A stand-in library: every ``tpp_*`` call records its arguments and
    returns cudaSuccess."""

    def __init__(self, calls, defines):
        self.calls, self.defines = calls, defines

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, dict(self.defines), args)) or 0


@pytest.fixture()
def stub_launch(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "load", lambda name, protos, defines=(): _Recorder(
        calls, defines))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: type(
        "S", (), {"cuda_stream": 7})())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(fa, "sm_count", lambda device: 132)
    return calls


def test_the_blocks_reach_the_c_calls(iso_cache, stub_launch):
    q, k, v = _qkv(b=4, l=300)
    mask = torch.ones(4, 300, dtype=torch.int32)
    bq, bk, bbq, bbk = fa.resolve_blocks(q, False, 128, 32, 64, 128)
    fa._launch(q, k, v, mask, False, bq, bk)
    lse = torch.zeros(8, 300)
    fa._launch_bwd("dq", q, k, v, q, lse, lse, mask, False, 1, bbq, bbk)
    fa._launch_bwd("dkv", q, k, v, q, lse, lse, mask, False, 2, bbq, bbk)
    cache = torch.zeros(4, 4096, 8, 64, dtype=torch.bfloat16)
    qd = torch.zeros(4, 1, 8, 64, dtype=torch.bfloat16)
    fa._launch_decode(qd, cache, cache, None, None, 128)
    (fwd, fwd_defines, fwd_args), (dq, dq_defines, dq_args), \
        (dkv, dkv_defines, dkv_args), (dec, dec_defines, dec_args) = stub_launch
    assert (fwd, fwd_defines, fwd_args[-3:-1]) == (
        "tpp_flash_fwd", {"TPP_BQ": 128, "TPP_BK": 32}, (128, 32))
    assert (dq, dq_defines, dq_args[-3:-1]) == (
        "tpp_flash_bwd_dq", {"TPP_BQ": 64, "TPP_BK": 128}, (64, 128))
    assert (dkv, dkv_defines, dkv_args[-3:-1]) == (
        "tpp_flash_bwd_dkv", {"TPP_BQ": 64, "TPP_BK": 128}, (64, 128))
    # The decode call: splits counted in the chosen blocks, then block_k.
    assert (dec, dec_defines) == ("tpp_flash_decode", {"TPP_BLOCK_K": 128})
    assert dec_args[12:14] == (fa.decode_splits(4, 8, 4096, 132, 128), 128)
    assert fa.decode_splits(4, 8, 4096, 132, 128) == 8
    assert fa.decode_splits(1, 1, 512, 132, 128) == 1    # 4 blocks of 128: unsplit
    assert fa.decode_splits(1, 1, 512, 132, 32) == 8
    assert fa.decode_split_ranges(300, 2, 128) == [(0, 128), (128, 300)]
