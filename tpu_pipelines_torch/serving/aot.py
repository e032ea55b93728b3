"""Ahead-of-time prepared serving steps: one CUDA graph per padded bucket.

The port of ``tpu_pipelines/serving/aot.py``.  The reference compiles the
device step once per padded bucket shape before a version becomes
eligible, so no request pays a compile mid-traffic.  Here the counterpart
of that executable is a ``torch.cuda.CUDAGraph``: ``warm_loaded`` runs the
loaded model's device step once per bucket, eagerly (kernel builds,
cuBLAS handles and the models' cached index tables are made here), then
captures it into static input and output buffers and installs, in
``loaded.aot``, a callable that copies a batch into those buffers,
replays the graph and returns a copy of the output.  A capture that fails
raises: the fleet turns that into a refused canary, never an eager path.

  * **One graph set per warm-up.**  The graphs of one ``warm_loaded`` call
    share one memory pool, one CUDA stream and one lock: a graph with
    static buffers is not reentrant, and graphs sharing a pool must not run
    at once, so the replicas' replays of one version take turns (the card
    runs them one after another anyway).
  * **Kernel counters.**  Each capture records its attention launches into
    ``fa.launch_tally()``; each replay ``fa.credit``\\ s them, so the
    launch counters read the same as an eager run's.
  * **No executable cache.**  The reference also serializes executables to
    a cross-process disk cache (``TPP_AOT_CACHE``); a CUDA graph cannot be
    serialized, so every process captures its own and ``cache_hits`` stays
    0.  ``payload_fingerprint`` and ``cache_key`` are kept for callers that
    key other state on a payload.

On the CPU (the tests) there are no graphs: ``warm_loaded`` runs the
reference's legacy warm-up, one predict per bucket, and installs nothing
(``fallback_warm`` True).  On CUDA it captures or raises: a loaded model
without the step handles a capture needs is an error, not a legacy warm.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from tpu_pipelines_torch.ops import flash_attention as fa
from tpu_pipelines_torch.serving.batching import bucket_sizes
from tpu_pipelines_torch.trainer.export import AotDispatch, on_device
from tpu_pipelines_torch.utils.fingerprint import fingerprint_dir, fingerprint_json

log = logging.getLogger("tpu_pipelines_torch.serving")

# Payload entries whose bytes define the served program.
_PAYLOAD_ENTRIES = (
    "model_spec.json", "module_copy.py", "checkpoint", "transform_graph",
)

def payload_fingerprint(uri: str) -> str:
    """Content hash of the payload files that define the served program
    (byte-identical payloads key identically across processes)."""
    h = hashlib.sha256()
    for entry in _PAYLOAD_ENTRIES:
        path = os.path.join(uri, entry)
        if os.path.exists(path):
            h.update(entry.encode())
            h.update(fingerprint_dir(path).encode())
    return h.hexdigest()


def cache_key(
    payload_fp: str,
    bucket: int,
    dtype: str,
    device_kind: str,
    endpoint: str,
    signature: tuple,
) -> str:
    """The reference's executable cache key, with torch's version in the
    place of jax's."""
    return fingerprint_json({
        "payload": payload_fp,
        "bucket": int(bucket),
        "dtype": dtype,
        "device_kind": device_kind,
        "endpoint": endpoint,
        "signature": [list(map(str, entry)) for entry in signature],
        "torch": torch.__version__,
    })


def capture(fn: Callable[[], Any], *, stream: torch.cuda.Stream,
            pool=None) -> Tuple[torch.cuda.CUDAGraph, Any, Dict[str, int]]:
    """Capture ``fn()`` into a CUDA graph on ``stream`` (into ``pool``, a
    new pool when None); returns ``(graph, fn's output, the attention
    launches the graph holds)``.  Other threads keep launching work while
    this one captures (``thread_local`` capture mode); captures themselves
    take turns."""
    graph = torch.cuda.CUDAGraph()
    with fa.capture_lock:
        with fa.launch_tally() as tally, torch.cuda.graph(
                graph, pool=pool, stream=stream,
                capture_error_mode="thread_local"):
            out = fn()
    return graph, out, dict(tally)


class _GraphSet:
    """The graphs of one warm-up: one pool, stream and lock."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.lock = threading.Lock()
        self.pool = None


class GraphStep:
    """One bucket's captured device step.  ``(params, batch)`` like the
    eager step; ``params`` are the ones captured.  Returns a copy of the
    output, ordered on the caller's stream."""

    def __init__(self, graphs: _GraphSet, graph, inputs, output, tally):
        self.graphs = graphs
        self.graph = graph
        self.inputs = inputs
        self.output = output
        self.tally = tally

    def __call__(self, params, batch: Dict[str, Any]) -> torch.Tensor:
        g = self.graphs
        caller = torch.cuda.current_stream(g.device)
        with g.lock:
            g.stream.wait_stream(caller)
            with torch.cuda.stream(g.stream):
                for k, buf in self.inputs.items():
                    v = batch[k]
                    buf.copy_(v if isinstance(v, torch.Tensor)
                              else torch.from_numpy(np.asarray(v)))
                self.graph.replay()
                out = self.output.clone()
            fa.credit(self.tally)
        caller.wait_stream(g.stream)
        out.record_stream(caller)
        return out


def _capture_bucket(graphs: _GraphSet, step, params, device_batch):
    """Warm the step on the graph stream, then capture it into static
    buffers; returns the installed :class:`GraphStep`."""
    inputs = on_device(device_batch, graphs.device)
    graphs.stream.wait_stream(torch.cuda.current_stream(graphs.device))
    with torch.cuda.stream(graphs.stream):
        step(params, inputs)            # first run: builds, handles, caches
    graphs.stream.synchronize()
    try:
        graph, output, tally = capture(lambda: step(params, inputs),
                                       stream=graphs.stream, pool=graphs.pool)
    except Exception as e:
        raise RuntimeError(
            f"aot: capturing the serving step into a CUDA graph failed for "
            f"batch signature {AotDispatch.signature(device_batch)}: {e}"
        ) from e
    if graphs.pool is None:
        graphs.pool = graph.pool()
    if not isinstance(output, torch.Tensor):
        raise TypeError(
            f"aot: the serving step returned {type(output).__name__}; a "
            "captured step must return one tensor"
        )
    return GraphStep(graphs, graph, inputs, output, tally)


def warm_loaded(
    loaded: Any,
    batch: Dict[str, Any],
    max_batch_size: int,
    *,
    raw: bool = True,
    use_cache: Optional[bool] = None,
) -> Dict[str, Any]:
    """Prepare every padded bucket shape of a loaded payload.

    On CUDA: one captured graph per bucket of the device step the serving
    path dispatches (raw endpoint: the host stage runs first, outside the
    graph, and the graph holds the transform's device stage fused with the
    forward; transformed endpoint: the bare forward), installed in
    ``loaded.aot`` under the padded batch signature the replica batchers
    will pose; a loaded model on CUDA without ``aot`` or the step handle
    raises.  On the CPU the legacy warm-up: one predict per bucket,
    nothing installed.
    ``use_cache`` is accepted for the reference's signature; graphs are
    never cached across processes.

    Returns ``{"buckets", "compiled", "cache_hits", "seconds",
    "fallback_warm", "cached_to_disk"}``; ``compiled`` counts captures."""
    del use_cache
    t0 = time.monotonic()
    buckets = bucket_sizes(max_batch_size)
    row = {k: np.asarray(v)[:1] for k, v in batch.items()}
    endpoint = "raw" if raw else "transformed"
    dispatch = getattr(loaded, "aot", None)
    step = getattr(loaded, "device_step" if raw else "forward_step", None)
    device = getattr(loaded, "device", None)
    stats = {
        "buckets": list(buckets), "compiled": 0, "cache_hits": 0,
        "fallback_warm": False, "cached_to_disk": 0, "seconds": 0.0,
    }
    if device is None or torch.device(device).type != "cuda":
        fn = loaded.predict if raw else loaded.predict_transformed
        for bucket in buckets:
            fn({k: np.repeat(v, bucket, axis=0) for k, v in row.items()})
        stats["fallback_warm"] = True
        stats["seconds"] = round(time.monotonic() - t0, 6)
        return stats
    if dispatch is None or step is None:
        missing = "aot" if dispatch is None else (
            "device_step" if raw else "forward_step")
        raise RuntimeError(
            f"aot: the loaded model on {device} has no {missing!r}; the "
            "serving step cannot be captured"
        )

    host = (getattr(loaded, "host_preprocess", None) if raw else None) or (
        lambda b: b)
    graphs = _GraphSet(torch.device(device))
    for bucket in buckets:
        padded = {k: np.repeat(v, bucket, axis=0) for k, v in row.items()}
        device_batch = host(padded)
        sig = AotDispatch.signature(device_batch)
        exe = _capture_bucket(graphs, step, loaded.params, device_batch)
        stats["compiled"] += 1
        dispatch.install(endpoint, sig, exe)
        if getattr(loaded, "transform", None) is None:
            # Without a transform both endpoints run the same step.
            dispatch.install("transformed" if raw else "raw", sig, exe)
    stats["seconds"] = round(time.monotonic() - t0, 6)
    return stats
