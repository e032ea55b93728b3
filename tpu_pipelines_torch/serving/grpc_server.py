"""gRPC predict surface sharing the REST server's model and batcher.

The port of ``tpu_pipelines/serving/grpc_server.py``.  One
``GrpcPredictionService`` wraps an existing ``ModelServer`` and exposes:

    /tpu_pipelines.serving.PredictionService/Predict
    /tpu_pipelines.serving.PredictionService/Generate
    /tpu_pipelines.serving.PredictionService/GetModelStatus
    /tpu_pipelines.serving.PredictionService/Reload

The service keeps the reference's name, messages and paths
(``prediction_service_pb2`` registers the reference's descriptor), so
either package's ``PredictionClient`` calls either package's server.
Requests route through ``ModelServer``'s predict path: micro-batching and
the fleet coalesce gRPC and REST callers into the same device calls, and
hot-swaps apply to both surfaces at once.  A W3C ``traceparent`` rides the
call's metadata and comes back in its trailing metadata.

The handlers are hand-written ``grpc.method_handlers`` over the generated
messages (no grpc codegen plugin is needed).  ``grpc`` is imported inside
the functions that need it, so importing this module needs only protobuf.
"""

from __future__ import annotations

import contextlib
import logging
from concurrent import futures
from typing import Any, Dict, Tuple

import numpy as np

from tpu_pipelines_torch.observability import request_trace
from tpu_pipelines_torch.serving import prediction_service_pb2 as pb
from tpu_pipelines_torch.serving.server import ModelServer

log = logging.getLogger("tpu_pipelines_torch.serving")

# The reference's service name, from the descriptor both packages register:
# the wire paths are "/<SERVICE_NAME>/<method>".
SERVICE_NAME = pb.DESCRIPTOR.services_by_name["PredictionService"].full_name

_NUMERIC_DTYPES = ("float32", "float64", "int32", "int64", "bool")


# ------------------------------------------------------------------- codec

def array_to_tensor(arr: np.ndarray) -> "pb.TensorValue":
    arr = np.asarray(arr)
    t = pb.TensorValue(shape=list(arr.shape))
    if arr.dtype.kind in ("U", "S", "O"):
        t.dtype = "string"
        t.string_vals.extend(
            v if isinstance(v, bytes) else str(v).encode("utf-8")
            for v in arr.reshape(-1)
        )
        return t
    if arr.dtype.name not in _NUMERIC_DTYPES:
        # Widen wire-exotic numerics instead of failing: models
        # routinely predict in bfloat16/float16, and the REST surface
        # (preds.tolist()) serves them fine — the two surfaces must agree.
        if arr.dtype.kind == "f":
            arr = arr.astype(np.float32)
        elif arr.dtype.kind in ("i", "u"):
            arr = arr.astype(np.int64)
        else:
            raise ValueError(f"unsupported tensor dtype {arr.dtype.name!r}")
    t.dtype = arr.dtype.name
    t.data = np.ascontiguousarray(arr).astype(arr.dtype.newbyteorder("<")).tobytes()
    return t


def tensor_to_array(t: "pb.TensorValue") -> np.ndarray:
    shape = tuple(t.shape)
    if t.dtype == "string":
        vals = [v.decode("utf-8") for v in t.string_vals]
        return np.asarray(vals, dtype=object).reshape(shape)
    if t.dtype not in _NUMERIC_DTYPES:
        raise ValueError(f"unsupported tensor dtype {t.dtype!r}")
    arr = np.frombuffer(t.data, dtype=np.dtype(t.dtype).newbyteorder("<"))
    return arr.astype(t.dtype).reshape(shape)


# ----------------------------------------------------------------- service

class GrpcPredictionService:
    """The servicer: validates the model name, decodes tensors, and predicts
    through the shared ``ModelServer`` (batcher included).  Predict and
    Generate share the wire messages and the decode/encode halves; only the
    middle call differs."""

    def __init__(self, server: ModelServer):
        self._server = server

    @contextlib.contextmanager
    def _traced(self, endpoint: str, context):
        """Request-trace root for one RPC: the W3C ``traceparent`` rides
        gRPC metadata (the HTTP header's twin), the trace id is handed
        back in the trailing metadata, and the root span closes with the
        RPC verdict — abort paths raise through the with-block, so the
        finally sees them."""
        tracer = self._server.request_tracer
        if tracer is None:
            yield None
            return
        header = None
        for k, v in (context.invocation_metadata() or ()):
            if k.lower() == "traceparent":
                header = v
        ctx = tracer.start(endpoint, header)
        if ctx is None:
            yield None
            return
        token = request_trace.push(ctx)
        code = "OK"
        try:
            context.set_trailing_metadata(
                (("traceparent", ctx.traceparent()),)
            )
        except Exception:  # noqa: BLE001 — a test double without trailing
            pass           # metadata support must not break serving
        try:
            yield ctx
        except BaseException:
            code = "ERR"
            raise
        finally:
            request_trace.pop(token)
            ctx.finish(code)

    def _decode_inputs(self, request, context) -> Dict[str, Any]:
        import grpc

        if request.model_name and request.model_name != self._server.model_name:
            context.abort(
                grpc.StatusCode.NOT_FOUND,
                f"unknown model {request.model_name!r} "
                f"(serving {self._server.model_name!r})",
            )
        try:
            batch: Dict[str, Any] = {
                k: tensor_to_array(v) for k, v in request.inputs.items()
            }
            if not batch:
                raise ValueError("request has no inputs")
            return batch
        except Exception as e:  # noqa: BLE001 — request decode/shape faults
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT, f"{type(e).__name__}: {e}"
            )

    def _encode_response(self, arr, context) -> "pb.PredictResponse":
        import grpc

        try:
            return pb.PredictResponse(
                model_version=self._server.version or "",
                predictions=array_to_tensor(np.asarray(arr)),
            )
        except Exception as e:  # noqa: BLE001 — encode fault is server-side
            context.abort(
                grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}"
            )

    def _call(self, fn, batch, context):
        import grpc

        from tpu_pipelines_torch.serving.server import GenerateUnsupported

        from tpu_pipelines_torch.serving.fleet.supervisor import FleetUnavailable
        from tpu_pipelines_torch.serving.generative import (
            EngineOverloaded,
            GenerationEvicted,
        )

        try:
            return fn(batch)
        except FleetUnavailable as e:
            # Every replica ejected or breaker-open: capacity is being
            # rebuilt — the gRPC twin of HTTP 503 + Retry-After.
            context.abort(
                grpc.StatusCode.UNAVAILABLE, f"{type(e).__name__}: {e}"
            )
        except GenerateUnsupported as e:
            # Typed contract with ModelServer: the deployment cannot serve
            # this RPC at all — not retryable, not the request's fault.
            context.abort(
                grpc.StatusCode.FAILED_PRECONDITION, f"{type(e).__name__}: {e}"
            )
        except EngineOverloaded as e:
            # Token-level admission shed — the gRPC twin of HTTP 429:
            # back off and retry.
            context.abort(
                grpc.StatusCode.RESOURCE_EXHAUSTED, f"{type(e).__name__}: {e}"
            )
        except GenerationEvicted as e:
            # The generation lost its per-token SLO race; the server is
            # healthy and a retry may land in budget.
            context.abort(
                grpc.StatusCode.UNAVAILABLE, f"{type(e).__name__}: {e}"
            )
        except (ValueError, KeyError, TypeError) as e:
            # The model rejecting this batch (missing feature, wrong shape)
            # is still the caller's fault.
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT, f"{type(e).__name__}: {e}"
            )
        except Exception as e:  # noqa: BLE001 — server-side fault: the
            # client's request is fine and a retry may succeed (model mid-
            # swap, device error); INVALID_ARGUMENT would tell clients and
            # load balancers to stop retrying.
            context.abort(
                grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}"
            )

    def Predict(self, request: "pb.PredictRequest", context):
        with self._traced("predict", context):
            batch = self._decode_inputs(request, context)
            preds = self._call(self._server.predict_batch, batch, context)
            return self._encode_response(preds, context)

    def Generate(self, request: "pb.PredictRequest", context):
        """Seq2seq decoding — same wire messages as Predict (inputs map ->
        token tensor); FAILED_PRECONDITION when the served payload has no
        make_generate_step hook."""
        with self._traced("generate", context):
            batch = self._decode_inputs(request, context)
            tokens = self._call(self._server.generate_batch, batch, context)
            return self._encode_response(tokens, context)

    def GetModelStatus(self, request: "pb.ModelStatusRequest", context):
        import grpc

        if request.model_name and request.model_name != self._server.model_name:
            context.abort(
                grpc.StatusCode.NOT_FOUND,
                f"unknown model {request.model_name!r}",
            )
        return pb.ModelStatusResponse(
            version=self._server.version or "", state="AVAILABLE"
        )

    def Reload(self, request: "pb.ModelStatusRequest", context):
        """Rescan the version dir and hot-swap to the newest version — the
        gRPC twin of REST ``:reload`` (Pusher push-URL hook, ops tooling).
        A canary-refused push maps to FAILED_PRECONDITION: the server is
        healthy, the pushed payload is not."""
        import grpc

        from tpu_pipelines_torch.serving.fleet.versions import CanaryRefused

        if request.model_name and request.model_name != self._server.model_name:
            context.abort(
                grpc.StatusCode.NOT_FOUND,
                f"unknown model {request.model_name!r}",
            )
        try:
            with self._traced("reload", context):
                version = self._server.reload()
        except CanaryRefused as e:
            context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                f"{type(e).__name__}: {e}",
            )
        except Exception as e:  # noqa: BLE001 — reload fault is server-side
            context.abort(
                grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}"
            )
        return pb.ModelStatusResponse(version=version, state="AVAILABLE")


def _method_handlers(service: GrpcPredictionService):
    import grpc

    return {
        "Predict": grpc.unary_unary_rpc_method_handler(
            service.Predict,
            request_deserializer=pb.PredictRequest.FromString,
            response_serializer=pb.PredictResponse.SerializeToString,
        ),
        "Generate": grpc.unary_unary_rpc_method_handler(
            service.Generate,
            request_deserializer=pb.PredictRequest.FromString,
            response_serializer=pb.PredictResponse.SerializeToString,
        ),
        "GetModelStatus": grpc.unary_unary_rpc_method_handler(
            service.GetModelStatus,
            request_deserializer=pb.ModelStatusRequest.FromString,
            response_serializer=pb.ModelStatusResponse.SerializeToString,
        ),
        "Reload": grpc.unary_unary_rpc_method_handler(
            service.Reload,
            request_deserializer=pb.ModelStatusRequest.FromString,
            response_serializer=pb.ModelStatusResponse.SerializeToString,
        ),
    }


def start_grpc_server(
    model_server: ModelServer,
    *,
    port: int = 0,
    host: str = "127.0.0.1",
    max_workers: int = 16,
) -> Tuple[Any, int]:
    """Serve gRPC predict for ``model_server``; returns (grpc_server, port).

    Call ``grpc_server.stop(grace)`` to shut down.  Runs alongside (not
    instead of) the REST surface; both share one loaded model and batcher.
    """
    import grpc

    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers((
        grpc.method_handlers_generic_handler(
            SERVICE_NAME, _method_handlers(GrpcPredictionService(model_server))
        ),
    ))
    bound = server.add_insecure_port(f"{host}:{port}")
    if bound == 0:
        raise RuntimeError(f"could not bind gRPC port on {host}:{port}")
    server.start()
    log.info("gRPC predict for %r on %s:%d", model_server.model_name, host, bound)
    return server, bound


# ------------------------------------------------------------------ client

class PredictionClient:
    """Minimal client for tests and the InfraValidator gRPC canary."""

    def __init__(self, target: str):
        import grpc

        self._channel = grpc.insecure_channel(target)
        self._predict = self._channel.unary_unary(
            f"/{SERVICE_NAME}/Predict",
            request_serializer=pb.PredictRequest.SerializeToString,
            response_deserializer=pb.PredictResponse.FromString,
        )
        self._status = self._channel.unary_unary(
            f"/{SERVICE_NAME}/GetModelStatus",
            request_serializer=pb.ModelStatusRequest.SerializeToString,
            response_deserializer=pb.ModelStatusResponse.FromString,
        )
        self._generate = self._channel.unary_unary(
            f"/{SERVICE_NAME}/Generate",
            request_serializer=pb.PredictRequest.SerializeToString,
            response_deserializer=pb.PredictResponse.FromString,
        )
        self._reload = self._channel.unary_unary(
            f"/{SERVICE_NAME}/Reload",
            request_serializer=pb.ModelStatusRequest.SerializeToString,
            response_deserializer=pb.ModelStatusResponse.FromString,
        )

    def predict(
        self, model_name: str, batch: Dict[str, Any], timeout: float = 30.0
    ) -> Tuple[np.ndarray, str]:
        req = pb.PredictRequest(model_name=model_name)
        for k, v in batch.items():
            req.inputs[k].CopyFrom(array_to_tensor(np.asarray(v)))
        resp = self._predict(req, timeout=timeout)
        return tensor_to_array(resp.predictions), resp.model_version

    def generate(
        self, model_name: str, batch: Dict[str, Any], timeout: float = 60.0
    ) -> Tuple[np.ndarray, str]:
        req = pb.PredictRequest(model_name=model_name)
        for k, v in batch.items():
            req.inputs[k].CopyFrom(array_to_tensor(np.asarray(v)))
        resp = self._generate(req, timeout=timeout)
        return tensor_to_array(resp.predictions), resp.model_version

    def reload(
        self, model_name: str, timeout: float = 120.0
    ) -> Dict[str, str]:
        """Trigger a version rescan + hot-swap; returns the now-active
        version.  Generous default timeout: the server loads (and canary-
        smokes) the new payload before answering."""
        resp = self._reload(
            pb.ModelStatusRequest(model_name=model_name), timeout=timeout
        )
        return {"version": resp.version, "state": resp.state}

    def model_status(
        self, model_name: str, timeout: float = 10.0
    ) -> Dict[str, str]:
        resp = self._status(
            pb.ModelStatusRequest(model_name=model_name), timeout=timeout
        )
        return {"version": resp.version, "state": resp.state}

    def close(self) -> None:
        self._channel.close()
