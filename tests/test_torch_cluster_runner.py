"""The port's compile-only cluster runner (``GPUJobRunner``) against the
reference's (``TPUJobRunner``), the twin of ``tests/test_cluster_runner.py``'s
manifest tests.

One DAG is built in each package's DSL and emitted by each runner; the
manifests, read back with ``yaml.safe_load`` (the port writes JSON text,
which YAML reads), are the same parsed objects once the reference's
accelerator fields are mapped to the port's: the TPU node selector to
``nvidia.com/gpu.product``, ``google.com/tpu`` to ``nvidia.com/gpu``, the
reference's ``tpu_pipelines`` entry points to the port's, and a JobSet's
``TPP_*`` bootstrap env to torchrun's launch (one process per GPU).
"""

import ast
import copy
import glob
import json
import os
import textwrap

import pytest
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE = "registry.example/tpp:1"


def _module(tmp_path, pkg, tag, *, shards=0, algorithm="grid",
            retry=False, deadline=0.0, pipeline_timeout=0.0):
    """A create_pipeline() module in ``pkg``'s DSL: CsvExampleGen ->
    StatisticsGen -> SchemaGen -> Trainer (and a Tuner with ``shards``)."""
    d = tmp_path / tag
    d.mkdir(exist_ok=True)
    csv = d / "data.csv"
    csv.write_text("a,b\n" + "\n".join(f"{i},{i * 2}" for i in range(30)) + "\n")
    trainer = d / "toy_trainer.py"
    trainer.write_text("def run_fn(fn_args):\n    return None\n")
    extra = ""
    if retry:
        extra += "    trainer.with_retry_policy(max_attempts=4, base_delay_s=2.0)\n"
    if deadline:
        extra += f"    trainer.with_execution_timeout({deadline!r})\n"
    tuner = ""
    if shards:
        tuner = f"""
    tuner = Tuner(examples=gen.outputs["examples"],
                  module_file={str(trainer)!r},
                  search_space={{"x": [1, 2, 3, 4, 5, 6]}},
                  train_steps=1, trial_shards={shards},
                  algorithm={algorithm!r})
    comps.append(tuner)
"""
    mod = d / "pipeline_def.py"
    mod.write_text(textwrap.dedent(f"""
from {pkg}.components import (
    CsvExampleGen, SchemaGen, StatisticsGen, Trainer, Tuner,
)
from {pkg}.dsl.pipeline import Pipeline


def create_pipeline():
    gen = CsvExampleGen(input_path={str(csv)!r})
    stats = StatisticsGen(examples=gen.outputs["examples"])
    schema = SchemaGen(statistics=stats.outputs["statistics"])
    trainer = Trainer(examples=gen.outputs["examples"],
                      schema=schema.outputs["schema"],
                      module_file={str(trainer)!r}, train_steps=1)
{extra}    comps = [trainer]
{tuner}    return Pipeline("cluster-demo", comps,
                    pipeline_root="/pipeline/root",
                    metadata_path="/pipeline/md.sqlite",
                    node_timeout_s={pipeline_timeout!r})
"""))
    return str(mod)


def _emit(tmp_path, tag, *, num_hosts=1, per_host=8, module_kw=None,
          **cfg_kw):
    """Both runners on the same DAG: (reference outputs, port outputs)."""
    from tpu_pipelines.orchestration import TPUJobRunner, TPUJobRunnerConfig
    from tpu_pipelines.utils.module_loader import load_fn as ref_load
    from tpu_pipelines_torch.orchestration import (
        GPUJobRunner,
        GPUJobRunnerConfig,
    )
    from tpu_pipelines_torch.utils.module_loader import load_fn

    module_kw = module_kw or {}
    ref_p = ref_load(_module(tmp_path, "tpu_pipelines", f"{tag}_ref",
                             **module_kw), "create_pipeline")()
    port_p = load_fn(_module(tmp_path, "tpu_pipelines_torch", f"{tag}_port",
                             **module_kw), "create_pipeline")()
    ref = TPUJobRunner(TPUJobRunnerConfig(
        image=IMAGE, pipeline_module="/app/pipeline_def.py",
        output_dir=str(tmp_path / f"{tag}_ref_out"), num_hosts=num_hosts,
        chips_per_host=per_host, **cfg_kw)).run(ref_p)
    runner = GPUJobRunner(GPUJobRunnerConfig(
        image=IMAGE, pipeline_module="/app/pipeline_def.py",
        output_dir=str(tmp_path / f"{tag}_port_out"), num_hosts=num_hosts,
        gpus_per_host=per_host,
        **{("gpu_mutex" if k == "tpu_mutex" else k): v
           for k, v in cfg_kw.items()}))
    return ref, runner.run(port_p), runner, port_p


def _load(path):
    with open(path) as f:
        return yaml.safe_load(f)


def _map_ref(obj, runner):
    """The reference's manifest with its accelerator fields mapped to the
    port's (the table of the module docstring)."""
    obj = copy.deepcopy(obj)
    per_host = runner.config.gpus_per_host

    def walk(o):
        if isinstance(o, dict):
            if "cloud.google.com/gke-tpu-accelerator" in o:
                return {"nvidia.com/gpu.product": runner.config.gpu_product}
            if "google.com/tpu" in o:
                return {"nvidia.com/gpu": per_host}
            if "manifest" in o and "action" in o:
                o = dict(o, manifest=yaml.safe_load(o["manifest"]))
            out = {k: walk(v) for k, v in o.items()}
            if out.get("kind") == "JobSet":
                out = _map_jobset(out, runner)
            return out
        if isinstance(o, list):
            return [walk(v) for v in o]
        if isinstance(o, str):
            return (o.replace("tpu_pipelines.", "tpu_pipelines_torch.", 1)
                    if o.startswith("tpu_pipelines.") else o)
        return o

    return walk(obj)


def _map_jobset(js, runner):
    js = copy.deepcopy(js)
    node = js["metadata"]["labels"]["tpu-pipelines/node"]
    job = js["spec"]["replicatedJobs"][0]["template"]["spec"]
    container = job["template"]["spec"]["containers"][0]
    env = [e for e in container["env"] if e["name"] not in (
        "TPP_COORDINATOR_ADDRESS", "TPP_NUM_PROCESSES")]
    container["env"] = [{
        "name": "TPP_NODE_RANK",
        "valueFrom": {"fieldRef": {"fieldPath": (
            "metadata.annotations"
            "['batch.kubernetes.io/job-completion-index']")}},
    }] + env
    cmd = container["command"]
    assert cmd[:3] == ["python", "-m", "tpu_pipelines_torch.run_node"]
    node_id = cmd[cmd.index("--node-id") + 1]
    assert node_id.lower() == node
    name = js["metadata"]["name"]
    container["command"] = [
        "torchrun", "--nnodes", str(runner.config.num_hosts),
        "--nproc-per-node", str(runner.config.gpus_per_host),
        "--node-rank", "$(TPP_NODE_RANK)",
        "--master-addr", f"{name}-workers-0-0.{name}",
        "--master-port", "8476", "-m", "tpu_pipelines_torch.run_node",
        *cmd[3:]]
    return js


def _port_workflow(path):
    wf = _load(path)
    for tpl in wf["spec"]["templates"]:
        if "resource" in tpl:
            tpl["resource"]["manifest"] = yaml.safe_load(
                tpl["resource"]["manifest"])
    return wf


def _assert_parity(ref, port, runner):
    assert set(ref) == set(port)
    want = _map_ref(_load(ref["workflow"]), runner)
    assert _port_workflow(port["workflow"]) == want
    for key in ref:
        if key.startswith("jobset_"):
            assert _load(port[key]) == _map_ref(_load(ref[key]), runner)
    ref_ir, port_ir = (json.load(open(p["pipeline_ir"])) for p in (ref, port))
    assert [n["id"] for n in ref_ir["nodes"]] == [
        n["id"] for n in port_ir["nodes"]]


@pytest.mark.parametrize("num_hosts,per_host", [(4, 8), (1, 1)],
                         ids=["jobset", "one-process"])
def test_manifests_equal_the_references(tmp_path, num_hosts, per_host):
    ref, port, runner, pipeline = _emit(
        tmp_path, "m", num_hosts=num_hosts, per_host=per_host,
        shared_volume_claim="shared-pvc")
    _assert_parity(ref, port, runner)
    wf = _port_workflow(port["workflow"])
    templates = {t["name"]: t for t in wf["spec"]["templates"]}
    tasks = {t["name"]: t for t in templates["pipeline-dag"]["dag"]["tasks"]}
    assert tasks["trainer"]["dependencies"] == ["csvexamplegen", "schemagen"]
    gen = templates["csvexamplegen"]["container"]["command"]
    assert gen[:3] == ["python", "-m", "tpu_pipelines_torch.run_node"]
    if num_hosts == 1:
        assert "container" in templates["trainer"]
        assert "jobset_Trainer" not in port
        assert templates["trainer"]["container"]["resources"]["limits"] == {
            "nvidia.com/gpu": 1}
        return
    assert templates["trainer"]["resource"]["action"] == "create"
    js = _load(port["jobset_Trainer"])
    job = js["spec"]["replicatedJobs"][0]["template"]["spec"]
    assert job["parallelism"] == job["completions"] == 4
    pod = job["template"]["spec"]
    assert pod["nodeSelector"] == {"nvidia.com/gpu.product":
                                   "NVIDIA-H100-80GB-HBM3"}
    cmd = pod["containers"][0]["command"]
    assert cmd[:7] == ["torchrun", "--nnodes", "4", "--nproc-per-node", "8",
                       "--node-rank", "$(TPP_NODE_RANK)"]


def _torchrun_env(cmd, node_rank, local_rank):
    """The env torchrun gives one of a pod's processes."""
    arg = dict(zip(cmd[1:13:2], cmd[2:14:2]))
    nnodes, nproc = int(arg["--nnodes"]), int(arg["--nproc-per-node"])
    return {"RANK": str(node_rank * nproc + local_rank),
            "LOCAL_RANK": str(local_rank),
            "WORLD_SIZE": str(nnodes * nproc),
            "MASTER_ADDR": arg["--master-addr"],
            "MASTER_PORT": arg["--master-port"]}


def test_every_process_of_a_jobset_gets_a_distinct_rank(tmp_path):
    """One process per GPU: the env each pod's torchrun gives its
    processes makes DistributedConfig.from_env name ranks 0..W-1 once
    each, all at worker 0's address."""
    from tpu_pipelines_torch.parallel.distributed import DistributedConfig

    _, port, runner, _ = _emit(tmp_path, "r", num_hosts=3, per_host=4)
    js = _load(port["jobset_Trainer"])
    job = js["spec"]["replicatedJobs"][0]["template"]["spec"]
    container = job["template"]["spec"]["containers"][0]
    env_names = {e["name"] for e in container["env"]}
    assert not env_names & {"TPP_NUM_PROCESSES", "TPP_COORDINATOR_ADDRESS"}
    ranks, addresses = [], set()
    for index in range(job["completions"]):
        for local in range(4):
            cfg = DistributedConfig.from_env(
                _torchrun_env(container["command"], index, local))
            ranks.append(cfg.process_id)
            addresses.add(cfg.coordinator_address)
            assert cfg.num_processes == 12 and cfg.local_rank == local
    assert sorted(ranks) == list(range(12))
    assert addresses == {"cluster-demo-trainer-workers-0-0."
                         "cluster-demo-trainer:8476"}


def test_retries_deadlines_parallelism_and_mutex_equal_the_references(tmp_path):
    ref, port, runner, pipeline = _emit(
        tmp_path, "d", num_hosts=2, per_host=8, max_parallel_nodes=3,
        module_kw={"retry": True, "deadline": 90.5, "pipeline_timeout": 600.0})
    _assert_parity(ref, port, runner)
    wf = _port_workflow(port["workflow"])
    groups = json.loads(wf["metadata"]["annotations"][
        "tpu-pipelines/stage-groups"])
    assert groups == [["CsvExampleGen"], ["StatisticsGen"], ["SchemaGen"],
                      ["Trainer"]]
    assert wf["spec"]["parallelism"] == 3
    templates = {t["name"]: t for t in wf["spec"]["templates"]}
    trainer = templates["trainer"]
    assert trainer["retryStrategy"] == {
        "limit": 3, "backoff": {"duration": "2s", "factor": 2,
                                "maxDuration": "10s"}}
    assert trainer["activeDeadlineSeconds"] == 91
    assert templates["schemagen"]["activeDeadlineSeconds"] == 600
    assert trainer["synchronization"]["mutex"]["name"] == "cluster-demo-tpu"
    assert "synchronization" not in templates["csvexamplegen"]
    js = trainer["resource"]["manifest"]
    assert js["spec"]["failurePolicy"] == {"maxRestarts": 3}


def test_metrics_federation_and_trace_annotations_equal_the_references(tmp_path):
    metrics = tmp_path / "metrics.json"
    metrics.write_text(json.dumps({
        "per_node": {"Trainer": {"wall_s": 12.5, "queue_wait_s": 0.25}},
        "critical_path_nodes": ["CsvExampleGen", "Trainer"],
        "critical_path_measured_s": 20.0}))
    ref, port, runner, pipeline = _emit(
        tmp_path, "t", num_hosts=2, per_host=2, metrics_port=9100,
        federation_spool="/pipeline/spool", tenant="team-a",
        metrics_history=True, trace_metrics_path=str(metrics),
        tpu_mutex=False)
    _assert_parity(ref, port, runner)
    wf = _port_workflow(port["workflow"])
    assert "tpu-pipelines/trace-critical-path" in wf["metadata"]["annotations"]
    templates = {t["name"]: t for t in wf["spec"]["templates"]}
    ann = templates["trainer"]["metadata"]["annotations"]
    assert ann["tpu-pipelines/measured-duration-s"] == "12.5"
    assert ann["prometheus.io/port"] == "9100"
    env = {e["name"] for e in templates["schemagen"]["container"]["env"]}
    assert env == {"TPP_METRICS_PORT", "TPP_FEDERATION_DIR", "TPP_TENANT",
                   "TPP_METRICS_HISTORY"}
    assert not any("synchronization" in t for t in templates.values())


def test_tuner_trial_shard_pods_equal_the_references(tmp_path):
    ref, port, runner, pipeline = _emit(
        tmp_path, "s", num_hosts=1, per_host=1,
        shared_volume_claim="shared-pvc", module_kw={"shards": 3})
    _assert_parity(ref, port, runner)
    wf = _port_workflow(port["workflow"])
    templates = {t["name"]: t for t in wf["spec"]["templates"]}
    tasks = {t["name"]: t for t in templates["pipeline-dag"]["dag"]["tasks"]}
    assert not any("dependencies" in t for t in tasks.values())
    for i in range(3):
        tn = f"tuner-trial-{i}"
        assert tasks[tn]["depends"] == "csvexamplegen.Succeeded"
        cmd = templates[tn]["container"]["command"]
        assert cmd[:4] == ["python", "-m",
                           "tpu_pipelines_torch.components.tuner_trial",
                           "shard"]
        assert f"{i}/3" in cmd and "/pipeline/root/.tuner_shards/Tuner" in cmd
        assert templates[tn]["nodeSelector"]
        assert "synchronization" not in templates[tn]
        assert f"({tn}.Succeeded || {tn}.Failed || {tn}.Errored)" in \
            tasks["tuner"]["depends"]
    env = {e["name"]: e["value"]
           for e in templates["tuner"]["container"]["env"]}
    assert env["TPP_TUNER_SHARD_DIR"] == "/pipeline/root/.tuner_shards/Tuner"


def test_an_adaptive_tuner_with_shards_is_refused_at_compile(tmp_path):
    with pytest.raises(ValueError, match="enumerable algorithm"):
        _emit(tmp_path, "a", module_kw={"shards": 2, "algorithm": "tpe"})
    from tpu_pipelines_torch.orchestration import (
        GPUJobRunner,
        GPUJobRunnerConfig,
    )
    from tpu_pipelines_torch.utils.module_loader import load_fn

    pipeline = load_fn(_module(tmp_path, "tpu_pipelines_torch", "a2",
                               shards=2, algorithm="tpe"), "create_pipeline")()
    out = tmp_path / "refused"
    with pytest.raises(ValueError, match="enumerable algorithm"):
        GPUJobRunner(GPUJobRunnerConfig(
            image=IMAGE, pipeline_module="/app/p.py",
            output_dir=str(out))).run(pipeline)
    assert not glob.glob(str(out / "*.yaml"))


def test_the_lint_gate_refuses_as_the_references(tmp_path):
    """A pipeline with a graph finding: "warn" refuses in both runners and
    emits nothing; "off" emits."""
    from tpu_pipelines.analysis import LintGateError as RefGateError
    from tpu_pipelines_torch.analysis import LintGateError

    with pytest.raises((RefGateError, LintGateError)):
        _emit(tmp_path, "l", lint="warn")
    from tpu_pipelines_torch.orchestration import (
        GPUJobRunner,
        GPUJobRunnerConfig,
    )
    from tpu_pipelines_torch.utils.module_loader import load_fn

    pipeline = load_fn(_module(tmp_path, "tpu_pipelines_torch", "l2"),
                       "create_pipeline")()
    for level, refused in (("warn", True), ("off", False)):
        out = tmp_path / f"lint_{level}"
        cfg = GPUJobRunnerConfig(image=IMAGE, pipeline_module="/app/p.py",
                                 output_dir=str(out), lint=level)
        if refused:
            with pytest.raises(LintGateError):
                GPUJobRunner(cfg).run(pipeline)
            assert not out.exists()
        else:
            assert set(GPUJobRunner(cfg).run(pipeline)) == {
                "pipeline_ir", "workflow", "jobset_Trainer"}


def test_manifests_are_deterministic(tmp_path):
    from tpu_pipelines_torch.orchestration import (
        GPUJobRunner,
        GPUJobRunnerConfig,
    )
    from tpu_pipelines_torch.utils.module_loader import load_fn

    pipeline = load_fn(_module(tmp_path, "tpu_pipelines_torch", "det",
                               shards=2), "create_pipeline")()

    def emit(d):
        return GPUJobRunner(GPUJobRunnerConfig(
            image="img", pipeline_module="/app/p.py", output_dir=str(d),
            num_hosts=2)).run(pipeline)

    out1, out2 = emit(tmp_path / "a"), emit(tmp_path / "b")
    assert set(out1) == {"pipeline_ir", "workflow", "jobset_Trainer",
                         "jobset_Tuner"}
    for key in out1:
        with open(out1[key]) as f1, open(out2[key]) as f2:
            text = f1.read()
            assert text == f2.read(), f"{key} not deterministic"
        if key != "pipeline_ir":
            assert json.loads(text) == yaml.safe_load(text)


@pytest.mark.parametrize("on_accel", [False, True])
def test_serving_manifests_equal_the_references(tmp_path, on_accel):
    from tpu_pipelines.orchestration import TPUJobRunner, TPUJobRunnerConfig
    from tpu_pipelines_torch.orchestration import (
        GPUJobRunner,
        GPUJobRunnerConfig,
    )

    ref = TPUJobRunner(TPUJobRunnerConfig(
        image=IMAGE, pipeline_module="/app/p.py",
        output_dir=str(tmp_path / "ref"), chips_per_host=1,
        shared_volume_claim="pvc")).emit_serving_manifests(
            "bert", "/pipeline/serving/bert", replicas=2, on_tpu=on_accel)
    runner = GPUJobRunner(GPUJobRunnerConfig(
        image=IMAGE, pipeline_module="/app/p.py",
        output_dir=str(tmp_path / "port"), gpus_per_host=1,
        shared_volume_claim="pvc"))
    port = runner.emit_serving_manifests(
        "bert", "/pipeline/serving/bert", replicas=2, on_gpu=on_accel)
    with open(ref) as f:
        want = [_map_ref(d, runner) for d in yaml.safe_load_all(f)]
    if not on_accel:
        # The port's server runs on the card unless told otherwise.
        want[0]["spec"]["template"]["spec"]["containers"][0][
            "command"] += ["--device", "cpu"]
    with open(port) as f:
        assert list(yaml.safe_load_all(f)) == want


def test_no_module_of_the_runner_imports_yaml():
    """The card's machine has no pyyaml: neither the cluster runner nor
    run_node may import it (also checked at import by
    tests/test_torch_jax_free.py)."""
    for rel in ("tpu_pipelines_torch/orchestration/cluster_runner.py",
                "tpu_pipelines_torch/run_node.py",
                "tpu_pipelines_torch/orchestration/__init__.py"):
        with open(os.path.join(REPO, rel)) as f:
            tree = ast.parse(f.read())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                names.add(node.module.split(".")[0])
        assert "yaml" not in names, rel
