"""Standalone model server: ``python -m tpu_pipelines_torch.serving``.

Serves a versioned payload layout (``<base-dir>/<version>/``) written by
``tpu_pipelines_torch.trainer.export.export_model`` over TF-Serving-style
REST, polls the base dir for newly pushed versions (``--poll-seconds``)
and hot-swaps to the highest one.  The model runs on the card unless
``--device cpu`` is given; without CUDA the default refuses to start.

    python -m tpu_pipelines_torch.serving \
        --model-name bert --base-dir /serving/bert --port 8501 --batching
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
                             "+ queued work reaches this; 0 = unbounded")
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
                batching=args.batching,
                max_batch_size=args.max_batch_size,
                batch_timeout_s=args.batch_timeout_ms / 1000.0,
                max_queue_depth=args.max_queue_depth,
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
        server.stop()
        log.info("server stopped")
    return 0


if __name__ == "__main__":
    sys.exit(main())
