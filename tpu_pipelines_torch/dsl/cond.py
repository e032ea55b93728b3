"""Conditional execution (``with Cond(...)``): not ported yet.

The reference's ``tpu_pipelines/dsl/cond.py`` gates nodes on predicates
over upstream artifact properties and runtime parameters.  The port's
runner executes every node; ``Cond`` raises, naming ``ROADMAP.md`` A18.
"""

from __future__ import annotations


class Cond:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "Cond (conditional nodes) is not ported yet (ROADMAP.md A18)"
        )
