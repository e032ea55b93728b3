"""GPUJobRunner: compile a pipeline to GPU cluster manifests (no execution).

The port of ``tpu_pipelines/orchestration/cluster_runner.py`` (the
``KubeflowDagRunner().run(pipeline)`` equivalent: it only compiles; the
operator substrate runs what it emits).  Emitted per run directory:

  - ``pipeline_ir.json``: the compiled IR;
  - ``workflow.yaml``: the Argo Workflow, one DAG task per node.  A node
    of one process is a container template running ``python -m
    tpu_pipelines_torch.run_node``; a Trainer or Tuner of more than one
    process is a resource template that creates the node's JobSet and
    awaits it, so distributed training runs inside the DAG;
  - ``jobset_<node>.yaml``: the same JobSet standalone;
  - ``serving_<model>.yaml`` from :meth:`GPUJobRunner.emit_serving_manifests`.

It keeps the reference's retry strategies, deadlines, ``spec.parallelism``,
the device mutex, the Tuner's trial-shard pods, the metrics and federation
env and annotations, the trace-metric annotations and the lint gate.  What
differs (``ROADMAP.md`` C):

  - the accelerator fields: the node selector is
    ``nvidia.com/gpu.product``, the requests and limits are
    ``nvidia.com/gpu: gpus_per_host``; the mutex serializes the port's
    ``"tpu"`` resource class (the nodes that hold the card);
  - one process per GPU: a JobSet of ``num_hosts`` pods makes a world of
    ``num_hosts * gpus_per_host`` processes.  Each pod runs ``torchrun
    --nnodes num_hosts --nproc-per-node gpus_per_host --node-rank <its
    completion index> --master-addr <worker 0's headless-service name>``
    over ``-m tpu_pipelines_torch.run_node``, and torchrun's ``RANK`` /
    ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` give every process a
    distinct global rank (``DistributedConfig.from_env``).  A node is
    distributed when that world is larger than one;
  - the manifests are JSON text with sorted keys (JSON is YAML 1.2, so
    ``kubectl`` and ``yaml.safe_load`` read them): the card's machine has
    no ``pyyaml``, and nothing here imports it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, List

from tpu_pipelines_torch.dsl.compiler import (
    Compiler,
    PipelineIR,
    is_runtime_param,
)
from tpu_pipelines_torch.dsl.pipeline import Pipeline
from tpu_pipelines_torch.parallel.distributed import DEFAULT_PORT

# Components that train and so get a JobSet when they span processes.
DISTRIBUTED_COMPONENT_TYPES = ("Trainer", "Tuner")
# The env var the JobSet's pods read their completion index from (the Job
# controller's annotation, through the downward API) for torchrun's
# --node-rank.
NODE_RANK_ENV = "TPP_NODE_RANK"
_COMPLETION_INDEX = ("metadata.annotations"
                     "['batch.kubernetes.io/job-completion-index']")


def k8s_name(s: str) -> str:
    """DNS-1123 subdomain: lowercase alphanumerics and '-', edge-trimmed."""
    out = re.sub(r"[^a-z0-9-]+", "-", s.lower()).strip("-")
    if not out:
        raise ValueError(f"cannot derive a k8s name from {s!r}")
    return out[:253]


def dumps(obj: Any) -> str:
    """A manifest as text: JSON with sorted keys, which YAML 1.2 reads."""
    return json.dumps(obj, sort_keys=True, indent=2) + "\n"


@dataclasses.dataclass
class GPUJobRunnerConfig:
    image: str                  # container image with the user's code
    pipeline_module: str        # path inside the image: create_pipeline()
    output_dir: str
    # The GPU the device nodes schedule onto (the node label NVIDIA's GPU
    # feature discovery sets) and the cluster's geometry.
    gpu_product: str = "NVIDIA-H100-80GB-HBM3"
    num_hosts: int = 1
    gpus_per_host: int = 8
    namespace: str = "default"
    service_account: str = ""
    workflow_name: str = ""     # defaults to the pipeline's name
    # Argo spec.parallelism: the cluster mirror of the local runner's
    # max_parallel_nodes.  0 = unlimited.
    max_parallel_nodes: int = 0
    # Serialize the "tpu" resource-class nodes (those that hold the card)
    # behind one Argo mutex, the local scheduler's device gate.  Trial-shard
    # pods are exempt: their fan-out exists to use many cards at once.
    gpu_mutex: bool = True
    # A ReadWriteMany PVC mounted at shared_mount_path in every container:
    # pipeline_root and the metadata sqlite must be one filesystem for
    # every pod.  Empty when the image provides the shared storage.
    shared_volume_claim: str = ""
    shared_mount_path: str = "/pipeline"
    # A prior run's trace metrics.json (``python -m tpu_pipelines_torch
    # trace latest --metrics``): each template carries the measured
    # duration and queue wait, the Workflow the measured critical path.
    trace_metrics_path: str = ""
    # Each pod serves /metrics and /healthz on this port (TPP_METRICS_PORT)
    # with the prometheus.io annotations; 0 = no server, no annotations.
    metrics_port: int = 0
    # TPP_FEDERATION_DIR (on the shared volume), TPP_TENANT, and
    # TPP_METRICS_HISTORY=1 in every pod; empty or False = off.
    federation_spool: str = ""
    tenant: str = ""
    metrics_history: bool = False
    # Lint gate on the compiled IR before anything is emitted: "error"
    # refuses on ERROR findings, "warn" on any finding, "off" disables.
    lint: str = "error"


class GPUJobRunner:
    """Compile-only runner; returns the paths of the emitted manifests."""

    def __init__(self, config: GPUJobRunnerConfig):
        self.config = config

    @property
    def world_size(self) -> int:
        """Processes of a distributed node: one per GPU of every host."""
        return self.config.num_hosts * self.config.gpus_per_host

    def run(self, pipeline: Pipeline) -> Dict[str, str]:
        ir = Compiler().compile(pipeline)
        cfg = self.config
        if (cfg.lint or "").lower() in ("error", "warn"):
            # A workflow that cannot succeed must not reach the cluster.
            from tpu_pipelines_torch.analysis import analyze_ir, gate_or_raise

            gate_or_raise(analyze_ir(ir), cfg.lint.lower(),
                          f"cluster compile ({pipeline.name})")
        # Every manifest is made before the first is written: a refusal
        # (an adaptive Tuner with shards) leaves no file behind.
        texts = {"pipeline_ir": ("pipeline_ir.json", ir.to_json_str()),
                 "workflow": ("workflow.yaml", dumps(self._workflow(ir)))}
        for node in ir.nodes:
            if self._is_distributed(node):
                texts[f"jobset_{node.id}"] = (
                    f"jobset_{k8s_name(node.id)}.yaml",
                    dumps(self._jobset(ir, node.id)))
        os.makedirs(cfg.output_dir, exist_ok=True)
        out: Dict[str, str] = {}
        for key, (name, text) in texts.items():
            out[key] = os.path.join(cfg.output_dir, name)
            with open(out[key], "w") as f:
                f.write(text)
        return out

    # ------------------------------------------------------------ manifests

    def _node_args(self, node_id: str) -> List[str]:
        return ["-m", "tpu_pipelines_torch.run_node",
                "--pipeline-module", self.config.pipeline_module,
                "--node-id", node_id]

    def _node_command(self, node_id: str) -> List[str]:
        return ["python", *self._node_args(node_id)]

    def _is_distributed(self, node) -> bool:
        return (node.component_type in DISTRIBUTED_COMPONENT_TYPES
                and self.world_size > 1)

    @staticmethod
    def _node_retry_strategy(ir: PipelineIR, node) -> Dict[str, Any]:
        """Argo ``retryStrategy``: component policy > pipeline default (the
        env rung is not read at compile time); ``limit: 2`` without one."""
        from tpu_pipelines_torch.robustness import RetryPolicy

        policy = RetryPolicy.from_json(
            getattr(node, "retry_policy", None)
        ) or RetryPolicy.from_json(getattr(ir, "default_retry_policy", None))
        if policy is None:
            return {"limit": 2}
        strategy: Dict[str, Any] = {"limit": policy.retries}
        if policy.base_delay_s > 0:
            strategy["backoff"] = {
                "duration": f"{policy.base_delay_s:g}s",
                "factor": 2,
                "maxDuration": f"{policy.max_delay_s:g}s",
            }
        return strategy

    @staticmethod
    def _node_deadline_s(ir: PipelineIR, node) -> int:
        """Whole seconds of the node's deadline (0 = none): component
        override > pipeline default (the env rung is not read here)."""
        t = float(getattr(node, "execution_timeout_s", 0.0) or 0.0)
        if t <= 0:
            t = float(getattr(ir, "default_node_timeout_s", 0.0) or 0.0)
        return int(-(-t // 1)) if t > 0 else 0

    # ------------------------------------------------- tuner trial fan-out

    @staticmethod
    def _tuner_shards(node) -> int:
        """The Tuner's trial-shard fan-out (0 = none).  A literal adaptive
        algorithm with shards is refused here, at compile time."""
        if node.component_type != "Tuner":
            return 0
        v = node.exec_properties.get("trial_shards", 0)
        if is_runtime_param(v):
            v = v.get("default") or 0
        try:
            v = int(v)
        except (TypeError, ValueError):
            return 0
        if v > 1:
            algo = node.exec_properties.get("algorithm", "grid")
            if not is_runtime_param(algo) and algo not in ("grid", "random"):
                raise ValueError(
                    f"Tuner node {node.id!r}: trial_shards={v} requires an "
                    f"enumerable algorithm (grid/random), got {algo!r}"
                )
        return v if v > 1 else 0

    @staticmethod
    def _tuner_shard_dir(ir: PipelineIR, node_id: str) -> str:
        # Under pipeline_root: the one filesystem every pod shares.
        return "/".join((ir.pipeline_root.rstrip("/"), ".tuner_shards",
                         node_id))

    def _tuner_trial_command(
        self, ir: PipelineIR, node_id: str, shard: int, num_shards: int
    ) -> List[str]:
        return [
            "python", "-m", "tpu_pipelines_torch.components.tuner_trial",
            "shard",
            "--pipeline-module", self.config.pipeline_module,
            "--node-id", node_id,
            "--shard", f"{shard}/{num_shards}",
            "--shard-dir", self._tuner_shard_dir(ir, node_id),
        ]

    def _metrics_annotations(self) -> Dict[str, str]:
        port = self.config.metrics_port
        if port <= 0:
            return {}
        return {
            "prometheus.io/scrape": "true",
            "prometheus.io/port": str(port),
            "prometheus.io/path": "/metrics",
        }

    def _metrics_env(self) -> List[Dict[str, str]]:
        cfg = self.config
        env: List[Dict[str, str]] = []
        if cfg.metrics_port > 0:
            env.append({"name": "TPP_METRICS_PORT",
                        "value": str(cfg.metrics_port)})
        if cfg.federation_spool:
            env.append({"name": "TPP_FEDERATION_DIR",
                        "value": cfg.federation_spool})
        if cfg.tenant:
            env.append({"name": "TPP_TENANT", "value": cfg.tenant})
        if cfg.metrics_history:
            env.append({"name": "TPP_METRICS_HISTORY", "value": "1"})
        return env

    def _load_trace_metrics(self) -> Dict[str, Any]:
        """A prior run's trace metrics, {} when none is configured; a
        configured path that cannot be read raises."""
        path = self.config.trace_metrics_path
        if not path:
            return {}
        with open(path, "r", encoding="utf-8") as f:
            metrics = json.load(f)
        if not isinstance(metrics, dict):
            raise ValueError(
                f"trace_metrics_path {path!r} is not a metrics.json object")
        return metrics

    def _workflow(self, ir: PipelineIR) -> Dict[str, Any]:
        cfg = self.config
        name = k8s_name(cfg.workflow_name or ir.name)
        trace_metrics = self._load_trace_metrics()
        trace_per_node = trace_metrics.get("per_node", {})
        tasks = []
        for node in ir.nodes:
            task: Dict[str, Any] = {"name": k8s_name(node.id),
                                    "template": k8s_name(node.id)}
            deps = sorted(k8s_name(u) for u in node.upstream)
            shards = self._tuner_shards(node)
            if shards:
                # One pod per trial shard between the Tuner's upstreams and
                # the merging Tuner, which needs them only to FINISH: it
                # re-runs a failed shard's trials itself.
                trial_names = [k8s_name(f"{node.id}-trial-{i}")
                               for i in range(shards)]
                for tn in trial_names:
                    t: Dict[str, Any] = {"name": tn, "template": tn}
                    if deps:
                        t["dependencies"] = deps
                    tasks.append(t)
                task["depends"] = " && ".join(
                    [f"{d}.Succeeded" for d in deps]
                    + [f"({t}.Succeeded || {t}.Failed || {t}.Errored)"
                       for t in trial_names])
            elif deps:
                task["dependencies"] = deps
            tasks.append(task)
        if any("depends" in t for t in tasks):
            # Argo refuses a DAG that mixes `depends` and `dependencies`.
            for t in tasks:
                deps = t.pop("dependencies", None)
                if deps:
                    t["depends"] = " && ".join(f"{d}.Succeeded" for d in deps)
        templates: List[Dict[str, Any]] = [
            {"name": "pipeline-dag", "dag": {"tasks": tasks}}
        ]
        for node in ir.nodes:
            shards = self._tuner_shards(node)
            # The local watchdog's deadline as activeDeadlineSeconds: a
            # timeout uses up the retry budget, as it does locally.
            deadline_s = self._node_deadline_s(ir, node)
            retry_strategy = self._node_retry_strategy(ir, node)
            for i in range(shards):
                trial_tpl: Dict[str, Any] = {
                    "name": k8s_name(f"{node.id}-trial-{i}"),
                    "retryStrategy": dict(retry_strategy),
                    "container": {
                        "image": cfg.image,
                        "command": self._tuner_trial_command(
                            ir, node.id, i, shards),
                        "resources": self._node_resources(node),
                    },
                    "nodeSelector": self._gpu_node_selector(),
                }
                if deadline_s:
                    trial_tpl["activeDeadlineSeconds"] = deadline_s
                if cfg.shared_volume_claim:
                    trial_tpl["container"]["volumeMounts"] = (
                        self._volume_mounts())
                templates.append(trial_tpl)
            tpl: Dict[str, Any] = {"name": k8s_name(node.id),
                                   "retryStrategy": dict(retry_strategy)}
            if deadline_s:
                tpl["activeDeadlineSeconds"] = deadline_s
            if self._is_distributed(node):
                # Create the node's JobSet and await it.
                tpl["resource"] = {
                    "action": "create",
                    "setOwnerReference": True,
                    "successCondition": "status.terminalState == Completed",
                    "failureCondition": "status.terminalState == Failed",
                    "manifest": dumps(self._jobset(ir, node.id)),
                }
            else:
                tpl["container"] = {
                    "image": cfg.image,
                    "command": self._node_command(node.id),
                    "resources": self._node_resources(node),
                }
                if shards:
                    # The Tuner merges the shard pods' scores.
                    tpl["container"]["env"] = [{
                        "name": "TPP_TUNER_SHARD_DIR",
                        "value": self._tuner_shard_dir(ir, node.id),
                    }]
                if cfg.shared_volume_claim:
                    tpl["container"]["volumeMounts"] = self._volume_mounts()
                if self._is_gpu_node(node):
                    tpl["nodeSelector"] = self._gpu_node_selector()
            if cfg.gpu_mutex and self._is_gpu_node(node):
                # One card-holding node at a time, as the local gate.
                tpl["synchronization"] = {"mutex": {"name": f"{name}-tpu"}}
            info = trace_per_node.get(node.id)
            if info:
                tpl.setdefault("metadata", {}).setdefault(
                    "annotations", {}).update({
                        "tpu-pipelines/measured-duration-s":
                            str(info.get("wall_s", "")),
                        "tpu-pipelines/measured-queue-wait-s":
                            str(info.get("queue_wait_s", "")),
                    })
            if cfg.metrics_port > 0:
                tpl.setdefault("metadata", {}).setdefault(
                    "annotations", {}).update(self._metrics_annotations())
            metrics_env = self._metrics_env()
            if metrics_env and "container" in tpl:
                tpl["container"].setdefault("env", []).extend(metrics_env)
            templates.append(tpl)
        spec: Dict[str, Any] = {"entrypoint": "pipeline-dag",
                                "templates": templates}
        if cfg.max_parallel_nodes > 0:
            spec["parallelism"] = cfg.max_parallel_nodes
        if cfg.shared_volume_claim:
            spec["volumes"] = self._volumes()
        if cfg.service_account:
            spec["serviceAccountName"] = cfg.service_account
        annotations = {
            # The compiler's topo stage groups: nodes of one group share no
            # data dependency, so Argo runs them concurrently.
            "tpu-pipelines/stage-groups": json.dumps(ir.topo_levels()),
        }
        if trace_metrics:
            annotations["tpu-pipelines/trace-critical-path"] = json.dumps({
                "nodes": trace_metrics.get("critical_path_nodes", []),
                "seconds": trace_metrics.get("critical_path_measured_s", 0.0),
            })
        return {
            "apiVersion": "argoproj.io/v1alpha1",
            "kind": "Workflow",
            "metadata": {
                "generateName": f"{name}-",
                "namespace": cfg.namespace,
                "labels": {"tpu-pipelines/pipeline": name},
                "annotations": annotations,
            },
            "spec": spec,
        }

    def _launcher_command(self, ir: PipelineIR, node_id: str) -> List[str]:
        """Each pod's command: torchrun starts one process per GPU of the
        host, ranked by the pod's completion index, with worker 0's
        headless-service name as the rendezvous."""
        cfg = self.config
        name = k8s_name(f"{ir.name}-{node_id}")
        return [
            "torchrun",
            "--nnodes", str(cfg.num_hosts),
            "--nproc-per-node", str(cfg.gpus_per_host),
            "--node-rank", f"$({NODE_RANK_ENV})",
            "--master-addr", f"{name}-workers-0-0.{name}",
            "--master-port", str(DEFAULT_PORT),
            *self._node_args(node_id),
        ]

    def _jobset(self, ir: PipelineIR, node_id: str) -> Dict[str, Any]:
        """The JobSet of one distributed training node (replaces TFJob)."""
        cfg = self.config
        name = k8s_name(f"{ir.name}-{node_id}")
        env: List[Dict[str, Any]] = [{
            "name": NODE_RANK_ENV,
            "valueFrom": {"fieldRef": {"fieldPath": _COMPLETION_INDEX}},
        }]
        if self._tuner_shards(ir.node(node_id)):
            env.append({"name": "TPP_TUNER_SHARD_DIR",
                        "value": self._tuner_shard_dir(ir, node_id)})
        env.extend(self._metrics_env())
        if cfg.federation_spool:
            # Each pod publishes under its own replica label.
            env.append({
                "name": "TPP_FED_REPLICA",
                "valueFrom": {"fieldRef": {"fieldPath": "metadata.name"}},
            })
        container = {
            "name": "worker",
            "image": cfg.image,
            "command": self._launcher_command(ir, node_id),
            "env": env,
            "resources": self._gpu_resources(),
            "ports": [{"containerPort": DEFAULT_PORT}],
        }
        if cfg.shared_volume_claim:
            container["volumeMounts"] = self._volume_mounts()
        pod_spec: Dict[str, Any] = {
            "subdomain": name,
            "restartPolicy": "Never",
            "nodeSelector": self._gpu_node_selector(),
            "containers": [container],
        }
        if cfg.shared_volume_claim:
            pod_spec["volumes"] = self._volumes()
        pod_template: Dict[str, Any] = {"spec": pod_spec}
        metrics_ann = self._metrics_annotations()
        if metrics_ann:
            pod_template["metadata"] = {"annotations": metrics_ann}
        job_spec: Dict[str, Any] = {
            "parallelism": cfg.num_hosts,
            "completions": cfg.num_hosts,
            "completionMode": "Indexed",
            "backoffLimit": 0,
            "template": pod_template,
        }
        deadline_s = self._node_deadline_s(ir, ir.node(node_id))
        if deadline_s:
            job_spec["activeDeadlineSeconds"] = deadline_s
        spec: Dict[str, Any] = {
            "replicatedJobs": [{
                "name": "workers",
                "replicas": 1,
                "template": {"spec": job_spec},
            }],
        }
        from tpu_pipelines_torch.robustness import RetryPolicy

        policy = RetryPolicy.from_json(
            getattr(ir.node(node_id), "retry_policy", None)
        ) or RetryPolicy.from_json(getattr(ir, "default_retry_policy", None))
        if policy is not None and policy.retries > 0:
            # The JobSet restart (every worker together) is the one retry
            # unit for a collective step; the runner refuses in-runner
            # retries under spmd_sync.
            spec["failurePolicy"] = {"maxRestarts": policy.retries}
        return {
            "apiVersion": "jobset.x-k8s.io/v1alpha2",
            "kind": "JobSet",
            "metadata": {
                "name": name,
                "namespace": cfg.namespace,
                "labels": {
                    "tpu-pipelines/pipeline": k8s_name(ir.name),
                    "tpu-pipelines/node": k8s_name(node_id),
                },
            },
            "spec": spec,
        }

    # -------------------------------------------------------- serving

    def emit_serving_manifests(
        self,
        model_name: str,
        model_base_dir: str,
        *,
        replicas: int = 1,
        port: int = 8501,
        grpc_port: int = 8500,
        batching: bool = True,
        on_gpu: bool = False,
    ) -> str:
        """A Deployment and a Service for the model server (one JSON
        document each, ``---`` between them).  ``model_base_dir`` is the
        Pusher's destination on the shared volume; the server's poll
        hot-swaps each pushed version.  ``grpc_port`` -1 serves REST only.
        ``on_gpu`` schedules the pods onto GPU nodes; by default they serve
        on the CPU (``--device cpu``)."""
        cfg = self.config
        name = k8s_name(f"{model_name}-serving")
        labels = {"tpu-pipelines/serving": k8s_name(model_name)}
        command = [
            "python", "-m", "tpu_pipelines_torch.serving",
            "--model-name", model_name,
            "--base-dir", model_base_dir,
            "--port", str(port),
        ]
        if grpc_port >= 0:
            command += ["--grpc-port", str(grpc_port)]
        if batching:
            command.append("--batching")
        if not on_gpu:
            command += ["--device", "cpu"]
        ports = [{"containerPort": port, "name": "http"}]
        if grpc_port >= 0:
            ports.append({"containerPort": grpc_port, "name": "grpc"})
        container: Dict[str, Any] = {
            "name": "model-server",
            "image": cfg.image,
            "command": command,
            "ports": ports,
            "readinessProbe": {
                "httpGet": {"path": f"/v1/models/{model_name}", "port": port},
                "initialDelaySeconds": 5,
                "periodSeconds": 10,
            },
            "resources": (
                self._gpu_resources() if on_gpu
                else {"requests": {"cpu": "2", "memory": "4Gi"}}
            ),
        }
        if cfg.shared_volume_claim:
            container["volumeMounts"] = self._volume_mounts()
        pod_spec: Dict[str, Any] = {"containers": [container]}
        if cfg.shared_volume_claim:
            pod_spec["volumes"] = self._volumes()
        if on_gpu:
            pod_spec["nodeSelector"] = self._gpu_node_selector()
        deployment = {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {"name": name, "namespace": cfg.namespace,
                         "labels": labels},
            "spec": {
                "replicas": replicas,
                "selector": {"matchLabels": labels},
                "template": {"metadata": {"labels": labels},
                             "spec": pod_spec},
            },
        }
        service = {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": name, "namespace": cfg.namespace,
                         "labels": labels},
            "spec": {
                "selector": labels,
                "ports": (
                    [{"name": "http", "port": port, "targetPort": port}]
                    + ([{"name": "grpc", "port": grpc_port,
                         "targetPort": grpc_port}] if grpc_port >= 0 else [])
                ),
            },
        }
        os.makedirs(cfg.output_dir, exist_ok=True)
        path = os.path.join(cfg.output_dir,
                            f"serving_{k8s_name(model_name)}.yaml")
        with open(path, "w") as f:
            f.write(dumps(deployment) + "---\n" + dumps(service))
        return path

    def _volumes(self) -> List[Dict[str, Any]]:
        return [{
            "name": "pipeline-shared",
            "persistentVolumeClaim": {
                "claimName": self.config.shared_volume_claim,
            },
        }]

    def _volume_mounts(self) -> List[Dict[str, str]]:
        return [{"name": "pipeline-shared",
                 "mountPath": self.config.shared_mount_path}]

    def _gpu_node_selector(self) -> Dict[str, str]:
        return {"nvidia.com/gpu.product": self.config.gpu_product}

    @staticmethod
    def _is_gpu_node(node) -> bool:
        # The IR's resource class (Transform, Trainer, Tuner, Evaluator,
        # BulkInferrer, ... are "tpu": the nodes that hold the card).
        return getattr(node, "resource_class", "") == "tpu"

    def _gpu_resources(self) -> Dict[str, Any]:
        n = self.config.gpus_per_host
        return {"requests": {"nvidia.com/gpu": n},
                "limits": {"nvidia.com/gpu": n}}

    def _node_resources(self, node) -> Dict[str, Any]:
        if self._is_gpu_node(node):
            return self._gpu_resources()
        return {"requests": {"cpu": "2", "memory": "4Gi"}}
