"""Standalone model server: ``python -m tpu_pipelines_torch.serving``.

Serves a versioned payload layout (``<base-dir>/<version>/``) written by
``tpu_pipelines_torch.trainer.export.export_model`` over TF-Serving-style
REST, polls the base dir for newly pushed versions (``--poll-seconds``)
and hot-swaps to the highest one.  The model runs on the card unless
``--device cpu`` is given; without CUDA the default refuses to start.

    python -m tpu_pipelines_torch.serving \
        --model-name bert --base-dir /serving/bert --port 8501 --batching

Fleet mode (replica batchers behind a latency-aware router, resident
versions with canary-gated hot-swap, each version's buckets captured as
CUDA graphs before it serves): add ``--replicas 2 --max-versions 2
--slo-p99-ms 50``; ``--model-type generative`` serves ``:generate`` through
per-replica continuous-batching engines.  ``/healthz`` then carries a
``fleet`` block.  ``--slo-monitor 2`` evaluates SLO burn rates every 2 s and
rolls a version that breaches inside the post-swap probation window
(``TPP_SWAP_PROBATION_S``) back to the prior one; env
``TPP_SERVING_MONITOR_SAMPLE`` samples traffic into drift windows (read
with ``python -m tpu_pipelines_torch drift --url ...``).  ``--grpc-port``
adds the gRPC surface (``serving/grpc_server.py``), ``--transformed-inputs``
serves ``predict_transformed``, ``--request-trace all --trace-dir D``
records request spans (read with ``python -m tpu_pipelines_torch trace
serve D``), and ``--slo-ms-per-token`` prices each generation's per-token
deadline.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading
import time

from tpu_pipelines_torch.serving.server import ModelServer

log = logging.getLogger("tpu_pipelines_torch.serving")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model-name", required=True)
    parser.add_argument("--base-dir", required=True,
                        help="versioned model dir (Pusher destination)")
    parser.add_argument("--port", type=int, default=8501)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--transformed-inputs", action="store_true",
                        help="serve predict_transformed (callers send "
                             "transformed features, not raw examples)")
    parser.add_argument("--batching", action="store_true",
                        help="micro-batch concurrent requests (bucketed "
                             "shapes, one device call per batch)")
    parser.add_argument("--max-batch-size", type=int, default=64)
    parser.add_argument("--batch-timeout-ms", type=float, default=5.0)
    parser.add_argument("--poll-seconds", type=float, default=30.0,
                        help="version-watch interval; 0 disables hot reload")
    parser.add_argument("--max-queue-depth", type=int, default=0,
                        help="admission-control bound: refuse (429 + "
                             "Retry-After) predict requests once in-flight "
                             "+ queued work reaches this; 0 = env "
                             "TPP_SERVING_MAX_QUEUE, else unbounded")
    parser.add_argument("--replicas", type=int, default=0,
                        help="replica workers behind the latency-aware "
                             "router (fleet mode when > 1; 0 = env "
                             "TPP_SERVING_REPLICAS, else 1)")
    parser.add_argument("--max-versions", type=int, default=0,
                        help="model versions kept resident for instant "
                             "rollback (fleet mode when > 1; 0 = env "
                             "TPP_SERVING_MAX_VERSIONS, else 1)")
    parser.add_argument("--slo-p99-ms", type=float, default=-1.0,
                        help="p99 latency budget the SLO-driven batch "
                             "deadline spends (0 = fixed window; -1 = env "
                             "TPP_SERVING_SLO_P99_MS)")
    parser.add_argument("--model-type", default="",
                        choices=["", "predict", "generative"],
                        help="'predict' or 'generative' (continuous-batching "
                             ":generate through the fleet's engines; empty "
                             "= env TPP_SERVING_MODEL_TYPE, else predict)")
    parser.add_argument("--decode-page-size", type=int, default=0,
                        help="generative KV-cache page (bucket) size; 0 = "
                             "env TPP_SERVING_PAGE_SIZE, else one bucket")
    parser.add_argument("--max-queue-tokens", type=int, default=0,
                        help="generative admission bound in outstanding "
                             "decode tokens (429 past it); 0 = env "
                             "TPP_SERVING_MAX_TOKENS, else unbounded")
    parser.add_argument("--slo-ms-per-token", type=float, default=-1.0,
                        help="per-token latency budget pricing each "
                             "generation's deadline; negative = env "
                             "TPP_SERVING_SLO_MS_PER_TOKEN, 0 = none")
    parser.add_argument("--grpc-port", type=int, default=-1,
                        help="also serve gRPC predict on this port "
                             "(0 = ephemeral; -1 = REST only)")
    parser.add_argument("--request-trace", default="",
                        help="request tracing: off | sample:N | all (empty "
                             "= env TPP_REQUEST_TRACE, else off)")
    parser.add_argument("--trace-dir", default="",
                        help="write request spans to "
                             "<dir>/serving/events.jsonl; empty = env "
                             "TPP_REQUEST_TRACE_DIR, else memory only")
    parser.add_argument("--slo-monitor", type=float, default=-1.0,
                        help="SLO burn-rate monitor evaluation interval "
                             "(seconds; fleet mode with --slo-p99-ms): "
                             "breaches inside the TPP_SWAP_PROBATION_S "
                             "window roll back to the prior version; "
                             "negative = env TPP_SLO_MONITOR, 0 = off")
    parser.add_argument("--device", default="cuda",
                        help="torch device the model runs on (cuda, cuda:N "
                             "or cpu)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    # The server may come up before the first push: wait for a version.
    while True:
        try:
            server = ModelServer(
                args.model_name,
                args.base_dir,
                raw=not args.transformed_inputs,
                batching=args.batching,
                max_batch_size=args.max_batch_size,
                batch_timeout_s=args.batch_timeout_ms / 1000.0,
                max_queue_depth=args.max_queue_depth,
                replicas=args.replicas,
                max_versions=args.max_versions,
                slo_p99_ms=args.slo_p99_ms,
                model_type=args.model_type,
                decode_page_size=args.decode_page_size,
                max_queue_tokens=args.max_queue_tokens,
                slo_ms_per_token=args.slo_ms_per_token,
                request_trace_mode=args.request_trace,
                trace_dir=args.trace_dir,
                slo_monitor_interval_s=args.slo_monitor,
                device=args.device,
            )
            break
        except FileNotFoundError:
            log.info(
                "no model versions under %r yet; waiting for the first push",
                args.base_dir,
            )
            time.sleep(max(args.poll_seconds, 1.0))
    port = server.start(port=args.port, host=args.host)
    log.info(
        "serving %r (version %s) on %s:%d",
        args.model_name, server.version, args.host, port,
    )
    grpc_server = None
    if args.grpc_port >= 0:
        from tpu_pipelines_torch.serving.grpc_server import start_grpc_server

        grpc_server, grpc_port = start_grpc_server(
            server, port=args.grpc_port, host=args.host
        )
        log.info("grpc predict on %s:%d", args.host, grpc_port)

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    try:
        while not stop.wait(args.poll_seconds or None):
            try:
                before = server.version
                after = server.reload()
                if after != before:
                    log.info("hot-swapped to version %s", after)
            except Exception as e:  # noqa: BLE001 — keep serving old version
                log.warning("version rescan failed: %s", e)
    finally:
        if grpc_server is not None:
            grpc_server.stop(grace=2)
        server.stop()
        log.info("server stopped")
    return 0


if __name__ == "__main__":
    sys.exit(main())
