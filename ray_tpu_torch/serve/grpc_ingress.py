"""gRPC ingress for Serve: the port of ``ray_tpu/serve/grpc_ingress.py``
(reference: serve/_private/proxy.py gRPC side + serve/grpc_util.py).

A generic-handler gRPC server (no generated stubs needed): requests are
``wire``-encoded, routed to deployment handles exactly like the HTTP proxy.

  unary    /ray_tpu.serve.ServeAPI/Call    {deployment, method?, body}
  stream   /ray_tpu.serve.ServeAPI/Stream  same request, one message per
                                           replica yield (token streaming)
  unary    /ray_tpu.serve.ServeAPI/Healthz {"ok": true}

The JAX ingress runs ``grpcio``; this one runs on the port's own gRPC over
HTTP/2 (``serve/_http2.py``, the standard library only). The service name,
methods and bodies are the JAX ingress's (``wire`` writes the JAX
``wire``'s bytes), so a ``grpcio`` client, the JAX ``ServeGrpcClient``
among them, calls this ingress, and this module's client calls the JAX one.
A failed call raises :class:`GrpcError` (``code()``, ``details()``) where
the JAX client raises ``grpc.RpcError``.

Runs inside a detached actor (`start_grpc_proxy`), sharing the controller
topology through ordinary DeploymentHandles.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch._private import wire
from ray_tpu_torch.serve import _http2
from ray_tpu_torch.serve._http2 import GrpcError, StatusCode

__all__ = ["SERVICE", "GrpcError", "ServeGrpcClient", "StatusCode",
           "start_grpc_proxy"]

SERVICE = "ray_tpu.serve.ServeAPI"

# the typed wire codec round-trips numpy arrays, sets, and framework
# structs losslessly (and refuses what it can't represent, instead of
# silently stringifying it)
_encode = wire.dumps
_decode = wire.loads


class _ServeGrpcHandler:
    """The generic handler routing to deployment handles."""

    def __init__(self):
        self._handles: Dict[tuple, Any] = {}

    def _handle(self, name: str, method: str, stream: bool):
        from ray_tpu_torch.serve.api import DeploymentHandle, _get_controller

        key = (name, method, stream)
        h = self._handles.get(key)
        if h is None:
            # validate the name against the controller first: an unknown
            # deployment must NOT-FOUND immediately instead of pinning a
            # worker thread in the handle's replica-wait loop
            controller = _get_controller(create=False)
            try:
                ray_tpu_torch.get(controller.get_topology.remote(name),
                                  timeout=10.0)
            except Exception:
                raise LookupError(f"no deployment named {name!r}")
            h = DeploymentHandle(name, method_name=method or "__call__",
                                 stream=stream)
            self._handles[key] = h
        return h

    def service(self, handler_call_details):
        method = handler_call_details.method
        if method == f"/{SERVICE}/Call":
            return _http2.unary_unary_rpc_method_handler(
                self._call, request_deserializer=_decode,
                response_serializer=_encode)
        if method == f"/{SERVICE}/Stream":
            return _http2.unary_stream_rpc_method_handler(
                self._stream, request_deserializer=_decode,
                response_serializer=_encode)
        if method == f"/{SERVICE}/Healthz":
            return _http2.unary_unary_rpc_method_handler(
                lambda req, ctx: {"ok": True},
                request_deserializer=_decode, response_serializer=_encode)
        return None

    def _call(self, request, context):
        try:
            h = self._handle(request["deployment"],
                             request.get("method", "__call__"), False)
            result = ray_tpu_torch.get(
                h.remote(request.get("body", {})),
                timeout=float(request.get("timeout", 120.0)))
            return {"result": result}
        except LookupError as e:
            context.abort(StatusCode.NOT_FOUND, str(e))
        except KeyError as e:
            context.abort(StatusCode.INVALID_ARGUMENT, f"missing field {e}")
        except Exception as e:
            context.abort(StatusCode.INTERNAL, str(e))

    def _stream(self, request, context):
        gen = None
        try:
            h = self._handle(request["deployment"],
                             request.get("method", "__call__"), True)
            timeout = float(request.get("timeout", 120.0))
            gen = h.remote(request.get("body", {}))
            for ref in gen:
                if not context.is_active():
                    # client went away: cancel the replica's generator so
                    # it stops producing for a dead stream
                    ray_tpu_torch.cancel(gen)
                    return
                yield {"chunk": ray_tpu_torch.get(ref, timeout=timeout)}
        except LookupError as e:
            context.abort(StatusCode.NOT_FOUND, str(e))
        except KeyError as e:
            context.abort(StatusCode.INVALID_ARGUMENT, f"missing field {e}")
        except Exception as e:
            if gen is not None and not context.is_active():
                try:
                    ray_tpu_torch.cancel(gen)
                except Exception:
                    pass
            context.abort(StatusCode.INTERNAL, str(e))


@ray_tpu_torch.remote
class _GrpcProxy:
    def __init__(self, port: int):
        self.port = port
        self._server = None
        self._bound_port = 0

    def start(self) -> int:
        if self._server is not None:
            return self._bound_port  # get_if_exists re-entry: already up
        handler = _ServeGrpcHandler()
        server = _http2.GrpcServer(handler.service)
        try:
            bound = server.start("127.0.0.1", self.port)
        except OSError as e:
            raise RuntimeError(
                f"cannot bind gRPC ingress to port {self.port}: {e}")
        self._server = server
        self._bound_port = bound
        return bound


def start_grpc_proxy(port: int = 0) -> int:
    """Start (or reuse) the detached gRPC ingress actor; returns the bound
    port."""
    proxy = _GrpcProxy.options(
        name="serve_grpc_proxy", lifetime="detached", num_cpus=0.1,
        max_concurrency=32, get_if_exists=True).remote(port)
    return ray_tpu_torch.get(proxy.start.remote(), timeout=120)


class ServeGrpcClient:
    """Minimal client for the generic ingress (tests / SDK use)."""

    def __init__(self, address: str):
        self._channel = _http2.GrpcChannel(address)
        self._call = self._channel.unary_unary(
            f"/{SERVICE}/Call", request_serializer=_encode,
            response_deserializer=_decode)
        self._stream = self._channel.unary_stream(
            f"/{SERVICE}/Stream", request_serializer=_encode,
            response_deserializer=_decode)

    def call(self, deployment: str, body: Optional[dict] = None,
             method: str = "__call__", timeout: float = 120.0):
        return self._call({"deployment": deployment, "method": method,
                           "body": body or {}, "timeout": timeout},
                          timeout=timeout + 10.0)["result"]

    def stream(self, deployment: str, body: Optional[dict] = None,
               method: str = "__call__", timeout: float = 120.0,
               overall_timeout: Optional[float] = None):
        """`timeout` is the server's PER-CHUNK budget; the gRPC deadline
        for the whole stream is only set when `overall_timeout` is given —
        a healthy long token stream must not be killed client-side."""
        for msg in self._stream({"deployment": deployment, "method": method,
                                 "body": body or {}, "timeout": timeout},
                                timeout=overall_timeout):
            yield msg["chunk"]

    def close(self):
        self._channel.close()
