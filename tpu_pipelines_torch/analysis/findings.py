"""Finding model + rule catalog for the port's static pipeline analyzer.

The port's copy of ``tpu_pipelines/analysis/findings.py``: the same rule
ids, severities and finding fields, so a suppression or a CI gate written
against one package reads the same against the other.  The titles of the
code rules that look inside a jitted region in the JAX package name the
port's counterpart, a *captured region* (a CUDA-graph capture or a
``torch.compile``), and its idioms.

`lint` is the compile-time contract check a DSL→IR compiler gives: a
pipeline is *validated* before anything executes.  Every check in `graph_rules` (TPP1xx, IR-level)
and `code_rules` (TPP2xx, executor-AST-level) emits `Finding`s — structured,
stable-id, attributable to a node and usually a file:line — so runners, the
CLI, and CI can gate on them uniformly.

Severity semantics:
  * ERROR — the run (or its execution cache) WILL misbehave: nondeterministic
    cache keys, unpicklable fork payloads, host sync inside a captured
    region, wiring that
    cannot resolve.  Gates refuse to run by default (`--fail-on error`).
  * WARN — correct but wasteful or fragile: dead-end nodes, chip-mutex
    serialization, redundant deadlines.  Opt into gating with
    `--fail-on warn`.

Suppression is per node per rule: `comp.with_lint_suppressions("TPP103")`
(compiled into `NodeIR.lint_suppress`), or — for code rules — a trailing
`# tpp: disable=TPP203` comment on the offending source line.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, List, Sequence

ERROR = "error"
WARN = "warn"

_SEVERITY_RANK = {WARN: 1, ERROR: 2}

# Stable rule catalog.  Ids are append-only: a released TPPnnn never changes
# meaning (suppressions and CI configs reference them by id).
RULES: Dict[str, Dict[str, str]] = {
    # ---- TPP1xx: IR graph rules (analyze_ir / graph_rules.py) ----
    "TPP101": {
        "severity": WARN,
        "title": "dead-end node: no output is consumed and the component "
                 "has no declared side effect",
    },
    "TPP102": {
        "severity": ERROR,
        "title": "deadline sanity: execution_timeout_s inconsistent with "
                 "the docs/RECOVERY.md precedence/retry contract",
    },
    "TPP103": {
        "severity": WARN,
        # "tpu" is the resource class's spelling in both packages: the
        # node holds the accelerator (here the GPU).
        "title": "tpu-class nodes share a topo level: with "
                 "max_parallel_nodes>1 they serialize on the chip mutex",
    },
    "TPP104": {
        "severity": ERROR,
        "title": "cache-unsafe exec property: value's encoding embeds a "
                 "memory address, poisoning the execution cache key",
    },
    "TPP105": {
        "severity": WARN,
        "title": "unresolved runtime parameter: no default and no value "
                 "until run start",
    },
    "TPP106": {
        "severity": ERROR,
        "title": "input references a producer that is not in the pipeline",
    },
    "TPP107": {
        "severity": ERROR,
        "title": "duplicate node id",
    },
    "TPP108": {
        "severity": ERROR,
        "title": "in-runner retry policy on an spmd_sync pipeline: the "
                 "runner refuses it at runtime (substrate owns multi-host "
                 "retries)",
    },
    "TPP109": {
        "severity": WARN,
        "title": "Pusher without an InfraValidator upstream: models reach "
                 "the live serving tier with no canary smoke check before "
                 "the push",
    },
    "TPP110": {
        "severity": WARN,
        "title": "serving SLO declared (slo_p99_ms) with no metrics "
                 "registry / SLO monitor wired in the same config: the "
                 "target shapes batching but nothing watches burn rates "
                 "or triggers the post-swap auto-rollback",
    },
    "TPP111": {
        "severity": WARN,
        "title": "continuous-controller pipeline node with no "
                 "execution_timeout_s and no retry policy: an unbounded "
                 "incremental run wedges the always-on loop",
    },
    "TPP112": {
        "severity": WARN,
        "title": "Pusher consumes a Model directly while a Rewriter node "
                 "exists in the same pipeline: the optimized (quantized/"
                 "AOT-warmed) variant is bypassed and the float payload "
                 "ships",
    },
    # ---- TPP2xx: executor/AST code rules (code_rules.py) ----
    "TPP201": {
        "severity": WARN,
        "title": "executor closure captures an un-fingerprintable value: "
                 "editing it cannot invalidate cached executions",
    },
    "TPP202": {
        "severity": ERROR,
        "title": "fork-unsafe map_shards payload: lambda/nested function "
                 "or captured lock/handle/device tensor cannot cross the "
                 "fork boundary",
    },
    "TPP203": {
        "severity": ERROR,
        "title": "host sync inside a captured region (.item()/.cpu()/"
                 ".numpy()/.tolist() or float()/int()/bool() on a tensor "
                 "in a CUDA-graph capture or torch.compile)",
    },
    "TPP204": {
        "severity": WARN,
        "title": "impure call inside a captured region (time/random "
                 "baked in at capture time)",
    },
    "TPP205": {
        "severity": WARN,
        "title": "Python branch on a tensor inside a captured region",
    },
    "TPP206": {
        "severity": ERROR,
        "title": "module-file entry point cannot be loaded",
    },
    "TPP207": {
        "severity": WARN,
        "title": "per-step host traffic (.to(device) / torch.tensor(..., "
                 "device=) / .cpu() / synchronize) inside a training loop "
                 "body while TrainLoopConfig(window_steps>1) is configured "
                 "— the captured window's host-tax win is forfeited",
    },
    "TPP208": {
        "severity": WARN,
        "title": 'attn_impl="flash" hard-coded at a statically-known '
                 "sequence length below every committed autotune-table "
                 "crossover — dense attention measured faster there on "
                 "every tuned device",
    },
    "TPP209": {
        "severity": WARN,
        "title": "autoregressive model configured on a whole-request-"
                 "batching serving endpoint — one long generation pins "
                 "its replica for the full decode; continuous batching "
                 '(model_type="generative") serves at the decode-step '
                 "level",
    },
    "TPP210": {
        "severity": WARN,
        "title": "mesh configured but input iteration has no per-host "
                 "shard (no per_host_input_config / assigned_shard_files "
                 "/ shard kwargs) — every host decodes the full dataset "
                 "and drops the rows it doesn't feed, the silent "
                 "multi-chip input tax",
    },
    "TPP211": {
        "severity": WARN,
        "title": "serving_decode_* metric emitted in serving/ but not "
                 "listed in docs/SERVING.md — the decode metric catalog "
                 "is the operator contract (dashboards and the SLO "
                 "monitor are built from it); an undocumented series is "
                 "invisible to both",
    },
    "TPP212": {
        "severity": WARN,
        "title": "multi-replica serving fleet with no slo_p99_ms and no "
                 "supervisor knobs — nothing detects a wedged or dead "
                 "replica, so the router keeps offering it traffic and "
                 "the redundancy buys nothing",
    },
    "TPP213": {
        "severity": WARN,
        "title": "param_partition/partition_rules configured but "
                 "dp_collective is statically pinned to a non-fsdp "
                 "explicit mode — psum/ordered keep params replicated, "
                 "the partition is never applied, and the train loop "
                 "rejects the pair at startup",
    },
    "TPP214": {
        "severity": WARN,
        "title": "metric-shaped name (*_total/*_seconds/*_bytes) emitted "
                 "under tpu_pipelines_torch/ but listed in none of docs/"
                 "OBSERVABILITY.md, docs/SERVING.md and the port's own "
                 "METRICS.md — the metric "
                 "catalogs are the operator contract; an undocumented "
                 "series is invisible to dashboards and alerts",
    },
    "TPP215": {
        "severity": WARN,
        "title": "pipeline deploys to a live fleet (serving_push_url) "
                 "with neither ExampleValidator drift/skew thresholds "
                 "nor a monitor_sample_rate knob — a deployed model "
                 "nobody is watching can rot for a full retrain cadence "
                 "before anything notices",
    },
}

GRAPH_RULE_PREFIX = "TPP1"
CODE_RULE_PREFIX = "TPP2"

# Trailing-comment suppression for code rules:  `x.item()  # tpp: disable=TPP203`
# (comma-separates multiple ids; bare `# tpp: disable` silences every rule on
# that line).
_DISABLE_RE = re.compile(
    r"#\s*tpp:\s*disable(?:=(?P<ids>[A-Z0-9, ]+))?", re.IGNORECASE
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer result, stable and machine-consumable.

    ``file``/``line`` point at the offending source for code rules and at
    nothing for pure graph rules (the node id is the address there).
    ``fix`` is the one-line remediation hint printed next to the finding.
    """

    rule: str
    severity: str           # "error" | "warn"
    message: str
    node_id: str = ""
    file: str = ""
    line: int = 0
    fix: str = ""

    def location(self) -> str:
        if self.file:
            return f"{self.file}:{self.line}" if self.line else self.file
        return ""

    def to_json(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    def format(self) -> str:
        loc = self.location()
        parts = [
            f"{self.node_id or '<pipeline>'}:",
            self.severity.upper(),
            self.rule,
            self.message,
        ]
        line = " ".join(parts)
        if loc:
            line += f"  ({loc})"
        if self.fix:
            line += f"\n    fix: {self.fix}"
        return line


def severity_rank(severity: str) -> int:
    return _SEVERITY_RANK.get(severity, 0)


def max_severity(findings: Iterable[Finding]) -> str:
    """Highest severity present, '' when there are no findings."""
    best = ""
    for f in findings:
        if severity_rank(f.severity) > severity_rank(best):
            best = f.severity
    return best


def count_by_severity(findings: Iterable[Finding]) -> Dict[str, int]:
    counts = {ERROR: 0, WARN: 0}
    for f in findings:
        counts[f.severity] = counts.get(f.severity, 0) + 1
    return counts


def gated(findings: Sequence[Finding], fail_on: str) -> List[Finding]:
    """The findings that trip a gate configured at ``fail_on`` level.

    ``fail_on`` is "error" (default: only ERRORs gate) or "warn" (any
    finding gates).  Unknown levels gate nothing — the runner treats a
    typo'd TPP_LINT as advisory rather than bricking the run.
    """
    floor = severity_rank(fail_on)
    if floor == 0:
        return []
    return [f for f in findings if severity_rank(f.severity) >= floor]


def suppressed_in_source(line_text: str, rule: str) -> bool:
    """True when the source line carries a `# tpp: disable` for ``rule``."""
    m = _DISABLE_RE.search(line_text)
    if not m:
        return False
    ids = m.group("ids")
    if not ids:
        return True  # bare disable: everything on this line
    return rule.upper() in {s.strip().upper() for s in ids.split(",")}


def apply_node_suppressions(
    findings: Sequence[Finding], suppress_by_node: Dict[str, Sequence[str]]
) -> List[Finding]:
    """Drop findings whose node suppressed that rule (NodeIR.lint_suppress)."""
    out = []
    for f in findings:
        rules = {r.upper() for r in suppress_by_node.get(f.node_id, ())}
        if f.rule.upper() in rules:
            continue
        out.append(f)
    return out


def sort_findings(findings: Iterable[Finding]) -> List[Finding]:
    """Stable display order: errors first, then rule id, then node."""
    return sorted(
        findings,
        key=lambda f: (
            -severity_rank(f.severity), f.rule, f.node_id, f.file, f.line,
        ),
    )
