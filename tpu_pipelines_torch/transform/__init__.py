"""Transform: full-pass analyzers + skew-free preprocessing graphs.

The port of ``tpu_pipelines/transform``: the user's
``preprocessing_fn(inputs, tft)`` builds a column-expression DAG through
the ``tft`` namespace; one pass over the dataset resolves every analyzer,
and the resolved DAG plus analyzer state is the serialized TransformGraph
artifact, evaluated in numpy on the host and by a torch evaluator on the
device (``graph.py``).
"""

from tpu_pipelines_torch.transform.expr import ColumnRef, TftNamespace  # noqa: F401
from tpu_pipelines_torch.transform.graph import TransformGraph  # noqa: F401
