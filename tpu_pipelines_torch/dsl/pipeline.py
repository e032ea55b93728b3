"""Pipeline: a named DAG of components with a root artifact directory."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from tpu_pipelines_torch.dsl.component import Component


class Pipeline:
    """A named collection of components; edges come from channel wiring.

    ``pipeline_root`` is where artifact payloads live
    (``<root>/<node>/<output_key>/<execution_id>/``); ``metadata_path`` is the
    SQLite metadata store ( ``:memory:`` for tests).
    """

    def __init__(
        self,
        name: str,
        components: Sequence[Component],
        pipeline_root: str,
        metadata_path: str = ":memory:",
        enable_cache: bool = True,
        node_timeout_s: float = 0.0,
        retry_policy=None,
    ):
        self.name = name
        self.pipeline_root = pipeline_root
        self.metadata_path = metadata_path
        self.enable_cache = enable_cache
        # Default per-node execution deadline (seconds; 0 = none).  A
        # component's own EXECUTION_TIMEOUT_S / with_execution_timeout()
        # overrides it; env TPP_NODE_TIMEOUT_S is the outermost fallback.
        if node_timeout_s < 0:
            raise ValueError(
                f"Pipeline {name!r}: node_timeout_s must be >= 0"
            )
        self.node_timeout_s = float(node_timeout_s)
        # Default per-node retry policy (RetryPolicy | dict | None).  A
        # component's own RETRY_POLICY / with_retry_policy() overrides it;
        # env TPP_RETRY_* is the outermost fallback — the same precedence
        # shape as node_timeout_s (docs/RECOVERY.md).
        from tpu_pipelines_torch.dsl.component import _coerce_retry_policy

        self.retry_policy = _coerce_retry_policy(
            retry_policy, f"Pipeline {name!r}"
        )
        self.components = self._closure_in_topo_order(components)
        ids = [c.id for c in self.components]
        dupes = {i for i in ids if ids.count(i) > 1}
        if dupes:
            # Importer-specific diagnosis: two
            # Importers of the same artifact_type both default to
            # 'Importer.<type>', and the generic duplicate-id error hides
            # the actual fix (pass instance_name=).
            hints = []
            for d in sorted(dupes):
                uris = {
                    c.exec_properties.get("source_uri")
                    for c in self.components
                    if c.id == d and "source_uri" in c.exec_properties
                }
                if len(uris) > 1:
                    hints.append(
                        f"{d!r} is the default id shared by Importer nodes "
                        f"for different sources {sorted(uris)}; pass "
                        "instance_name= to each Importer to disambiguate"
                    )
            raise ValueError(
                f"Pipeline {name!r}: duplicate component ids {sorted(dupes)}; "
                "use .with_id() to disambiguate"
                + ("".join(f". {h}" for h in hints))
            )

    @staticmethod
    def _closure_in_topo_order(components: Sequence[Component]) -> List[Component]:
        """Transitive closure over upstream producers, topologically sorted.

        Deterministic: stable DFS post-order over the declaration order, so
        compiling the same pipeline twice yields byte-identical IR.
        """
        order: List[Component] = []
        state: Dict[int, int] = {}  # id(component) -> 0 visiting / 1 done

        def visit(c: Component, chain: List[str]) -> None:
            s = state.get(id(c))
            if s == 1:
                return
            if s == 0:
                raise ValueError(
                    f"Pipeline has a cycle through: {' -> '.join(chain + [c.id])}"
                )
            state[id(c)] = 0
            for dep in c.upstream:
                visit(dep, chain + [c.id])
            state[id(c)] = 1
            order.append(c)

        for c in components:
            visit(c, [])
        return order

    def get(self, component_id: str) -> Optional[Component]:
        for c in self.components:
            if c.id == component_id:
                return c
        return None
