"""`lint`: two-layer static analysis that gates runs and CI.

The port's copy of ``tpu_pipelines/analysis`` (the rule catalog, the
graph rules on the compiled IR, the code rules on executors and module
entry points), reading the port's own tree: its committed autotune
crossovers (TPP208), its shard pool's fork contract (TPP202), its
package's metric names against the catalogs (TPP211/TPP214).  The code
rules that look inside a ``jax.jit`` region in the JAX package look
inside a *captured region* here (``code_rules.py``).

  * ``analyze_ir(ir)`` — Layer 1, TPP1xx graph rules on the compiled
    ``PipelineIR`` (what every runner consumes).  Pure, millisecond-fast,
    needs no user code.
  * ``analyze_pipeline(pipeline)`` — Layer 1 + Layer 2: additionally walks
    each component executor's source and its declared module-file entry
    points (TPP2xx code rules).

Gates built on it:

  * CLI:        ``python -m tpu_pipelines_torch lint --pipeline-module M``
                (exit 0 clean / 3 gated findings, like ``trace diff``)
  * local:      ``LocalDagRunner.run(..., lint="error")`` or env
                ``TPP_LINT=error|warn`` — pre-flight, before the store is
                touched; unset means zero behavior change.
  * continuous: the controller lints each handed pipeline once
                (``ContinuousConfig.lint`` / ``TPP_LINT``; TPP111 armed).

Per-node suppression: ``comp.with_lint_suppressions("TPP103")``; per-line
(code rules): trailing ``# tpp: disable=TPP203``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from tpu_pipelines_torch.analysis.code_rules import (
    check_callable,
    check_component_code,
    check_metric_docs,
    check_serving_metric_docs,
)
from tpu_pipelines_torch.analysis.findings import (
    ERROR,
    RULES,
    WARN,
    Finding,
    apply_node_suppressions,
    count_by_severity,
    gated,
    max_severity,
    sort_findings,
)
from tpu_pipelines_torch.analysis.graph_rules import GRAPH_RULES

ENV_LINT = "TPP_LINT"
# Exit code contract shared with `trace diff`: 3 = the gate tripped (a
# policy verdict, distinct from 1 = the tool itself failed).
EXIT_GATED = 3


class LintGateError(Exception):
    """A lint gate refused to proceed.  Carries the gated findings so
    callers (CLI, tests, wrapping orchestrators) can render or assert on
    them without re-running the analyzer."""

    def __init__(self, findings: Sequence[Finding], where: str):
        self.findings = list(findings)
        self.where = where
        lines = [f.format() for f in findings[:10]]
        more = len(findings) - 10
        if more > 0:
            lines.append(f"... and {more} more")
        super().__init__(
            f"lint gate ({where}): {len(findings)} blocking finding(s)\n"
            + "\n".join(lines)
        )


def _suppressions(ir) -> Dict[str, Sequence[str]]:
    return {
        n.id: tuple(getattr(n, "lint_suppress", ()) or ())
        for n in ir.nodes
    }


def analyze_ir(ir) -> List[Finding]:
    """Layer 1 (TPP1xx) findings for a compiled PipelineIR, suppressions
    applied, sorted errors-first."""
    findings: List[Finding] = []
    for rule_fn in GRAPH_RULES:
        findings.extend(rule_fn(ir))
    return sort_findings(
        apply_node_suppressions(findings, _suppressions(ir))
    )


def analyze_pipeline(
    pipeline, ir=None, spmd_sync: bool = False, continuous: bool = False,
) -> List[Finding]:
    """Both layers for a DSL Pipeline: graph rules on its compiled IR plus
    code rules on every component's executor and module-file entries.

    ``spmd_sync`` stamps the compiled IR as bound for the multi-host
    spmd runner (distribution degree lives in runner configs, not the
    DSL), arming the TPP108 in-runner-retry rule.  ``continuous`` stamps
    it as driven by the continuous controller, arming TPP111 (unbounded
    nodes wedge the always-on loop).
    """
    if ir is None:
        from tpu_pipelines_torch.dsl.compiler import Compiler

        ir = Compiler().compile(pipeline)
    if spmd_sync:
        ir.spmd_sync = True
    if continuous:
        ir.continuous = True
    findings = list(analyze_ir(ir))
    code: List[Finding] = []
    for comp in pipeline.components:
        code.extend(check_component_code(comp))
    findings.extend(
        apply_node_suppressions(code, _suppressions(ir))
    )
    return sort_findings(findings)


def lint_report(findings: Sequence[Finding]) -> Dict[str, object]:
    """Machine-readable summary (the CLI --json payload)."""
    counts = count_by_severity(findings)
    return {
        "findings": [f.to_json() for f in findings],
        "errors": counts.get(ERROR, 0),
        "warnings": counts.get(WARN, 0),
        "rules": sorted({f.rule for f in findings}),
    }


def format_findings(findings: Sequence[Finding]) -> str:
    if not findings:
        return "lint: clean (0 findings)"
    counts = count_by_severity(findings)
    body = "\n".join(f.format() for f in findings)
    return (
        f"{body}\nlint: {counts.get(ERROR, 0)} error(s), "
        f"{counts.get(WARN, 0)} warning(s)"
    )


def resolve_lint_level(explicit: Optional[str]) -> str:
    """Effective gate level: explicit argument > TPP_LINT env > off.

    Returns "error", "warn", or "" (no gate).  "off"/"0"/"" disable."""
    import os

    level = explicit if explicit is not None else os.environ.get(
        ENV_LINT, ""
    )
    level = (level or "").strip().lower()
    if level in (ERROR, WARN):
        return level
    return ""


def gate_or_raise(
    findings: Sequence[Finding], fail_on: str, where: str
) -> None:
    """Raise LintGateError when any finding reaches ``fail_on`` level."""
    blocking = gated(findings, fail_on)
    if blocking:
        raise LintGateError(blocking, where)


__all__ = [
    "ERROR",
    "WARN",
    "RULES",
    "Finding",
    "LintGateError",
    "EXIT_GATED",
    "ENV_LINT",
    "analyze_ir",
    "analyze_pipeline",
    "check_callable",
    "check_component_code",
    "check_metric_docs",
    "check_serving_metric_docs",
    "count_by_severity",
    "format_findings",
    "gate_or_raise",
    "gated",
    "lint_report",
    "max_severity",
    "resolve_lint_level",
    "sort_findings",
]
