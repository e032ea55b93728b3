"""Port parity: ``python -m tpu_pipelines_torch`` against the reference's
``python -m tpu_pipelines`` on a host-only DAG (CsvExampleGen ->
StatisticsGen -> SchemaGen over tests/testdata/taxi_sample.csv), in
process.  Mirrors tests/test_cli.py.

``run``, ``trace latest``, ``trace <id>``, ``trace diff``, ``inspect
runs|lineage|artifacts`` print the reference CLI's lines, with the same
exit codes, once what differs between two runs is masked: run ids, the
directories the two sides write under, every decimal number (wall
times) and the width of the padding beside them.  ``--json`` outputs carry the same keys and the same non-time
values.  ``run`` defaults to the card and raises without CUDA, naming the
device; ``run --resume-from latest`` after a run killed at a node prints
the reference's lines (adopted nodes marked); ``lint``, ``run --lint``,
``run --from-node/--to-node`` and ``continuous --lint`` print the
reference's lines with its exit codes; ``trace serve``, not ported yet,
exits 2 naming its ROADMAP.md item.
"""

import contextlib
import importlib
import io
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from test_torch_trace import _fixed_log
from tpu_pipelines.__main__ import main as ref_main
from tpu_pipelines_torch.__main__ import main as port_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSV = os.path.join(REPO, "tests", "testdata", "taxi_sample.csv")
PIPELINE = '''
import os


def create_pipeline():
    from {pkg}.components import CsvExampleGen, SchemaGen, StatisticsGen
    from {pkg}.dsl.pipeline import Pipeline

    base = os.environ["HOSTDAG_BASE"]
    gen = CsvExampleGen(input_path={csv!r})
    stats = StatisticsGen(examples=gen.outputs["examples"])
    schema = SchemaGen(statistics=stats.outputs["statistics"])
    return Pipeline("hostdag", [gen, stats, schema],
                    pipeline_root=os.path.join(base, "root"),
                    metadata_path=os.path.join(base, "md.sqlite"))
'''
SIDES = {"ref": ("tpu_pipelines", ref_main, []),
         "port": ("tpu_pipelines_torch", port_main, ["--device", "cpu"])}


def _call(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = main(argv)
    return code, out.getvalue(), err.getvalue()


def _masked(text, base):
    text = text.replace(base, "<BASE>")
    text = re.sub(r"hostdag-\d+", "<RUN>", text)
    text = re.sub(r"\d+\.\d+(e-?\d+)?", "<N>", text)
    return re.sub(r" +", " ", text)  # the padding follows the numbers' widths


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each side's CLI run twice (cold, then all cached) and its outputs:
    {side: {"base", "runs": [run ids], "run_out": [(code, stdout)]}}."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("TPP_TRACE", raising=False)
        mp.delenv("TPP_METRICS_PORT", raising=False)
        mp.setenv("TPP_DATA_POOL", "thread")  # no fork under JAX's threads
        for side, (pkg, main, extra) in SIDES.items():
            base = str(tmp_path_factory.mktemp(side))
            module = os.path.join(base, "pipe.py")
            with open(module, "w") as f:
                f.write(PIPELINE.format(pkg=pkg, csv=CSV))
            mp.setenv("HOSTDAG_BASE", base)
            run_out, run_ids = [], []
            for _ in range(2):
                code, stdout, _ = _call(
                    main, ["run", "--pipeline-module", module, *extra])
                run_out.append((code, stdout))
                run_ids.append(re.search(r"run (hostdag-\d+)", stdout).group(1))
            out[side] = {"base": base, "runs": run_ids, "run_out": run_out}
    return out


def _both(runs, argv_of):
    """(code, masked stdout) of each side for ``argv_of(side_info)``."""
    got = {}
    for side, (_, main, _) in SIDES.items():
        info = runs[side]
        code, stdout, _ = _call(main, argv_of(info))
        got[side] = (code, _masked(stdout, info["base"]))
    return got


def test_run_prints_the_reference_lines(runs):
    for i in range(2):
        ref_code, ref_out = runs["ref"]["run_out"][i]
        port_code, port_out = runs["port"]["run_out"][i]
        assert port_code == ref_code == 0
        assert _masked(port_out, runs["port"]["base"]) == \
            _masked(ref_out, runs["ref"]["base"])
    assert "cached" in runs["port"]["run_out"][1][1]


def _summary_lines(text):
    """The summary's lines in a fixed order (its node table is sorted by
    measured wall time), the shard-pool line included: both StatisticsGens
    map their shards through the resilient pool (threads here)."""
    return sorted(re.sub(r"\(\d+ events\)", "(<K> events)", line)
                  for line in text.splitlines())


@pytest.mark.parametrize("which", ["latest", "first"])
def test_trace_prints_the_reference_summary(runs, which, tmp_path):
    def argv(info):
        run = "latest" if which == "latest" else info["runs"][0]
        return ["trace", run, "--pipeline-root",
                os.path.join(info["base"], "root")]

    got = {side: (code, _summary_lines(text))
           for side, (code, text) in _both(runs, argv).items()}
    assert got["port"] == got["ref"]
    assert got["port"][0] == 0
    _, stdout, _ = _call(port_main, argv(runs["port"]))
    ratio = "1.0" if which == "latest" else "0.0"
    assert f"cache hit ratio {ratio}" in stdout


def test_trace_json_and_the_exported_files_match_the_reference(runs, tmp_path):
    docs = {}
    for side, (_, main, _) in SIDES.items():
        info = runs[side]
        perfetto = tmp_path / f"{side}_trace.json"
        metrics = tmp_path / f"{side}_metrics.json"
        code, stdout, _ = _call(main, [
            "trace", info["runs"][0], "--pipeline-root",
            os.path.join(info["base"], "root"), "--json", "--perfetto",
            str(perfetto), "--metrics", str(metrics)])
        assert code == 0
        doc = json.loads(stdout)
        assert json.load(open(metrics))["per_node"] == doc["per_node"]
        timeline = json.load(open(perfetto))["traceEvents"]
        docs[side] = (doc, {(e["name"], e.get("cat")) for e in timeline})
    (port, port_tl), (ref, ref_tl) = docs["port"], docs["ref"]
    assert sorted(port) == sorted(ref)
    for key in ("node_count", "critical_path_nodes", "cache_hits",
                "cache_misses", "cache_hit_ratio", "run_succeeded",
                "deadline_expiries", "adopted_nodes", "goodput",
                "train_telemetry"):
        assert port[key] == ref[key], key
    assert {n: (i["status"], i["upstream"]) for n, i in port["per_node"].items()} \
        == {n: (i["status"], i["upstream"]) for n, i in ref["per_node"].items()}
    assert port_tl == ref_tl


def _fake_runs(info):
    """Two traced runs written from one fixed log, the second 1.5x slower."""
    root = os.path.join(info["base"], "root")
    for run_id, scale in (("fixed-a", 1.0), ("fixed-b", 1.5)):
        path = os.path.join(root, ".runs", run_id, "trace", "events.jsonl")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            for event in _fixed_log(scale):
                f.write(json.dumps(event) + "\n")
    return root


@pytest.mark.parametrize("pair,threshold,want_code", [
    (("fixed-a", "fixed-b"), "0.2", 3),
    (("fixed-a", "fixed-b"), "0.9", 0),
    (("fixed-a", "fixed-a"), "0.2", 0),
])
def test_trace_diff_prints_the_reference_diff_and_exit_code(
        runs, pair, threshold, want_code):
    def argv(info):
        return ["trace", "diff", *pair, "--pipeline-root", _fake_runs(info),
                "--threshold", threshold]

    got = _both(runs, argv)
    assert got["port"] == got["ref"]
    assert got["port"][0] == want_code


def test_trace_diff_of_the_two_dag_runs_has_the_reference_shape(runs):
    docs = {}
    for side, (_, main, _) in SIDES.items():
        info = runs[side]
        code, stdout, _ = _call(main, [
            "trace", "diff", *info["runs"], "--pipeline-root",
            os.path.join(info["base"], "root"), "--json"])
        docs[side] = (code in (0, 3), json.loads(stdout))
    assert docs["port"][0] and docs["ref"][0]
    assert sorted(docs["port"][1]) == sorted(docs["ref"][1])
    assert sorted(docs["port"][1]["per_node"]) == \
        sorted(docs["ref"][1]["per_node"])


def test_inspect_runs_lineage_and_artifacts_print_the_reference_lines(runs):
    def md(info):
        return os.path.join(info["base"], "md.sqlite")

    for argv_of in (
        lambda i: ["inspect", "runs", "hostdag", "--metadata", md(i)],
        lambda i: ["inspect", "runs", "hostdag", "--metadata", md(i),
                   "--pipeline-root", os.path.join(i["base"], "root")],
        lambda i: ["inspect", "--metadata", md(i), "lineage", "3"],
        lambda i: ["inspect", "lineage", "99", "--metadata", md(i)],
        lambda i: ["inspect", "artifacts", "--metadata", md(i)],
        lambda i: ["inspect", "artifacts", "--type", "Schema",
                   "--metadata", md(i)],
        lambda i: ["inspect", "runs", "nope", "--metadata", md(i)],
    ):
        got = _both(runs, argv_of)
        assert got["port"] == got["ref"], argv_of(runs["port"])
    code, out = got["port"]
    assert code == 1 and out == ""


def test_inspect_runs_json_lists_both_runs_as_the_reference(runs):
    docs = {}
    for side, (_, main, _) in SIDES.items():
        info = runs[side]
        code, stdout, _ = _call(main, [
            "inspect", "runs", "hostdag", "--json", "--metadata",
            os.path.join(info["base"], "md.sqlite"), "--pipeline-root",
            os.path.join(info["base"], "root")])
        doc = json.loads(stdout)
        assert code == 0
        assert [r["run_id"] for r in doc["runs"]] == info["runs"]
        docs[side] = [[(n["node"], n["state"], n["execution_id"], "trace" in n)
                       for n in r["nodes"]] for r in doc["runs"]]
    assert docs["port"] == docs["ref"]


def test_run_defaults_to_the_card_and_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = tmp_path / "pipe.py"
    module.write_text(PIPELINE.format(pkg="tpu_pipelines_torch", csv=CSV))
    monkeypatch.setenv("HOSTDAG_BASE", str(tmp_path))
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        port_main(["run", "--pipeline-module", str(module)])
    assert not (tmp_path / "md.sqlite").exists()


def _module(tmp_path, side, text=None):
    """(main, extra argv, base, module path) of a fresh hostdag for one
    side; the HOSTDAG_BASE env must be set by the caller."""
    pkg, main, extra = SIDES[side]
    base = str(tmp_path / side)
    os.makedirs(base, exist_ok=True)
    module = os.path.join(base, "pipe.py")
    with open(module, "w") as f:
        f.write(text.format(pkg=pkg, td=base) if text
                else PIPELINE.format(pkg=pkg, csv=CSV))
    return main, extra, base, module


@pytest.mark.parametrize("argv,item", [
    (["lint", "--pipeline-module", "p.py"], "lint"),
    (["continuous", "--pipeline-module", "p.py", "--lint", "error"],
     "continuous"),
    (["trace", "serve", "/tmp/requests"], "A8b"),
    (["run", "--pipeline-module", "p.py", "--from-node", "StatisticsGen"],
     "partial"),
    (["run", "--pipeline-module", "p.py", "--to-node", "StatisticsGen"],
     "partial"),
    (["run", "--pipeline-module", "p.py", "--from-node", "StatisticsGen",
      "--resume-from", "latest"], "refused"),
    (["run", "--pipeline-module", "p.py", "--lint", "error"], "run-lint"),
])
def test_each_deferred_subcommand_or_flag_names_its_item(
        argv, item, tmp_path, monkeypatch, capsys):
    """Each subcommand and flag that once exited 2 naming its ROADMAP.md
    item: ``trace serve`` still does (A8b); the rest print the reference
    CLI's lines, with its exit codes, on the same host DAG.  ``run
    --from-node`` with ``--resume-from`` is refused on both sides (the
    reference raises its runner's ValueError, the port exits 2 with it)."""
    if item == "A8b":
        code, out, err = _call(port_main, argv)
        assert code == 2
        assert f"ROADMAP.md {item}" in err and "not ported yet" in err
        return
    monkeypatch.delenv("TPP_TRACE", raising=False)
    monkeypatch.setenv("TPP_DATA_POOL", "thread")  # no fork under JAX's threads
    got = {}
    for side in SIDES:
        if item == "continuous":
            from test_torch_continuous import CONT_MODULE, _write_span

            main, extra, base, module = _module(
                tmp_path, side, CONT_MODULE)
            _write_span(os.path.join(base, "data"), 1, 8)
            code = main([*argv[:2], module, *argv[3:], "--once", *extra])
            got[side] = (code, capsys.readouterr().out.splitlines()[-1])
            continue
        main, extra, base, module = _module(tmp_path, side)
        monkeypatch.setenv("HOSTDAG_BASE", base)
        args = [*argv[:2], module, *argv[3:]]
        if item == "lint":
            got[side] = [_call(main, args), _call(main, [*args, "--json"]),
                         _call(main, [*args, "--fail-on", "warn"])]
            continue
        if item == "refused":
            if side == "ref":
                with pytest.raises(ValueError) as e:
                    _call(main, [*args, *extra])
                got[side] = (2, str(e.value))
            else:
                code, _, err = _call(main, [*args, *extra])
                got[side] = (code, err.strip().removeprefix("run: "))
            continue
        if item == "partial" and "--from-node" in args:
            _call(main, ["run", "--pipeline-module", module, *extra])
        code, out, err = _call(main, [*args, *extra])
        runs = [(code, _masked(out, base))]
        if item == "run-lint":
            args[-1] = "warn"
            code, out, err = _call(main, [*args, *extra])
            runs.append((code, _masked(out, base), _masked(err, base)))
        got[side] = runs
    assert got["port"] == got["ref"]
    port = got["port"]
    if item == "lint":
        (code, out, _), (jcode, jout, _), (wcode, wout, _) = port
        assert (code, jcode, wcode) == (0, 0, 3)
        assert "TPP101" in out and json.loads(jout)["errors"] == 0
    elif item == "continuous":
        assert port == (0, "continuous: stopped after 1 iteration(s); "
                           "spans seen: [1]")
    elif item == "refused":
        assert port[0] == 2 and "incompatible" in port[1]
    elif item == "partial":
        out = port[0][1]
        assert port[0][0] == 0 and "SKIPPED" in out
        if "--from-node" in argv:
            assert "CsvExampleGen: SKIPPED" in out
        else:
            assert "SchemaGen: SKIPPED" in out
    else:
        assert port[0][0] == 0 and port[1][0] == 3
        assert "TPP101" in port[1][2]


def test_the_module_entry_point_runs_in_a_subprocess(runs):
    info = runs["port"]
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_pipelines_torch", "inspect", "--metadata",
         os.path.join(info["base"], "md.sqlite"), "runs", "hostdag"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr
    assert "SchemaGen" in proc.stdout and "CACHED" in proc.stdout


def test_run_resume_from_latest_adopts_as_the_reference(tmp_path, monkeypatch):
    """A run killed at SchemaGen's dispatch, then ``run --resume-from
    latest``: both CLIs print the same lines, the two published nodes
    adopted and SchemaGen run, exit 0."""
    monkeypatch.delenv("TPP_TRACE", raising=False)
    monkeypatch.setenv("TPP_DATA_POOL", "thread")  # no fork under JAX's threads
    got = {}
    for side, (pkg, main, extra) in SIDES.items():
        base = str(tmp_path / side)
        os.makedirs(base)
        module = os.path.join(base, "pipe.py")
        with open(module, "w") as f:
            f.write(PIPELINE.format(pkg=pkg, csv=CSV))
        monkeypatch.setenv("HOSTDAG_BASE", base)
        faults = importlib.import_module(f"{pkg}.testing.faults")
        plan = faults.FaultPlan({"SchemaGen": faults.NodeFault(
            faults.KILL_ORCHESTRATOR)})
        with plan.activate(), pytest.raises(faults.SimulatedCrash):
            _call(main, ["run", "--pipeline-module", module, *extra])
        code, out, _ = _call(main, ["run", "--pipeline-module", module,
                                    "--resume-from", "latest", *extra])
        got[side] = (code, _masked(out, base))
    assert got["port"] == got["ref"]
    code, out = got["port"]
    assert code == 0
    assert "CsvExampleGen: adopted (done)" in out
    assert "StatisticsGen: adopted (done)" in out
    assert "SchemaGen: done" in out
