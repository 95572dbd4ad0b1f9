"""gRPC ingress for Serve.

The port's copy of ``ray_tpu/serve/grpc_proxy.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Parity: the reference's per-node ``gRPCProxy`` (``serve/_private/proxy.py:534``,
service schema ``src/ray/protobuf/serve.proto:317`` — ``ListApplications``/
``Healthz`` plus user-defined method handlers routed by the ``application``
request metadata). Here the service is a generic-bytes contract (no protoc
codegen, so user payload schemas stay open):

  /ray_tpu.serve.Serve/Predict           unary-unary, bytes -> bytes
  /ray_tpu.serve.Serve/ListApplications  '' -> JSON list of app names
  /ray_tpu.serve.Serve/Healthz           '' -> b"success"

Routing: request metadata ``application`` picks the app (default:
``default``); ``payload-codec`` metadata selects the codec —
``json`` (default) or ``pickle`` for arbitrary Python/numpy values on both
legs (``content-type`` is reserved by gRPC itself and cannot be user-set).
"""

from __future__ import annotations

import json
import pickle
from concurrent import futures
from typing import Dict, Optional

from ray_tpu_torch.serve.router import DeploymentHandle

#: the JAX package's service name: a client of either package calls the same
#: methods
_SERVICE = "ray_tpu.serve.Serve"


class GRPCProxy:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        request_timeout_s: float = 30.0,
        *,
        allow_pickle: bool = False,
    ):
        import grpc

        self._grpc = grpc
        self.host = host
        self.request_timeout_s = request_timeout_s
        # pickle deserializes CLIENT-CONTROLLED bytes => arbitrary code
        # execution; only enable on a trusted network (opt-in, like the
        # runtime's own worker channel which assumes a trusted cluster)
        self.allow_pickle = allow_pickle
        self.apps: Dict[str, DeploymentHandle] = {}
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=32))
        handler = grpc.method_handlers_generic_handler(
            _SERVICE,
            {
                "Predict": grpc.unary_unary_rpc_method_handler(self._predict),
                "ListApplications": grpc.unary_unary_rpc_method_handler(self._list_apps),
                "Healthz": grpc.unary_unary_rpc_method_handler(self._healthz),
            },
        )
        self._server.add_generic_rpc_handlers((handler,))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        self._server.start()

    # -- handlers (bytes in / bytes out) ------------------------------------
    def _predict(self, request: bytes, context) -> bytes:
        md = {k: v for k, v in (context.invocation_metadata() or ())}
        codec = md.get("payload-codec", "json")
        if codec == "pickle" and not self.allow_pickle:
            # security gate FIRST: never unpickle client bytes un-opted-in,
            # regardless of whether the target app exists
            context.abort(
                self._grpc.StatusCode.INVALID_ARGUMENT,
                "pickle codec disabled; start the proxy with allow_pickle=True "
                "(serve.start(grpc_allow_pickle=True)) on trusted networks only",
            )
        app = md.get("application", "default")
        handle = self.apps.get(app)
        if handle is None:
            context.abort(
                self._grpc.StatusCode.NOT_FOUND,
                f"no application {app!r} (have: {sorted(self.apps)})",
            )
        from ray_tpu_torch.runtime.context import pop_tenant, push_tenant

        tenant_token = push_tenant(md.get("x-tenant-id") or md.get("x-tenant"))
        try:
            if codec == "pickle":
                payload = pickle.loads(request) if request else None
            else:
                payload = json.loads(request) if request else None
            result = handle.remote(payload).result(timeout=self.request_timeout_s)
            if codec == "pickle" and not hasattr(result, "__next__"):
                return pickle.dumps(result)
        except Exception as exc:  # noqa: BLE001
            # HTTP-coherent status mapping (RESOURCE_EXHAUSTED is the 429
            # equivalent; retry_after_s rides the detail string since
            # unary abort has no trailing-metadata helper here)
            from ray_tpu_torch.runtime.admission import grpc_code_for, unwrap

            code_name, retry_after = grpc_code_for(exc)
            cause = unwrap(exc)
            detail = f"{type(cause).__name__}: {cause}"
            if retry_after is not None:
                detail += f" (retry_after_s={retry_after:g})"
            context.abort(getattr(self._grpc.StatusCode, code_name), detail)
        finally:
            pop_tenant(tenant_token)
        if hasattr(result, "__next__"):
            # streaming deployments (stream=True generators) have no
            # unary-gRPC representation; the HTTP proxy serves them as SSE —
            # tell the client instead of dying in json.dumps. OUTSIDE the
            # try: context.abort raises, and the catch-all would rewrite the
            # status to INTERNAL.
            context.abort(
                self._grpc.StatusCode.UNIMPLEMENTED,
                "deployment returned a stream; streaming is not supported "
                "over gRPC Predict — use the HTTP proxy (SSE)",
            )
        try:
            from ray_tpu_torch.serve.proxy import _jsonify

            return json.dumps(result, default=_jsonify).encode()
        except Exception as exc:  # noqa: BLE001
            context.abort(self._grpc.StatusCode.INTERNAL, f"{type(exc).__name__}: {exc}")

    def _list_apps(self, request: bytes, context) -> bytes:
        return json.dumps(sorted(self.apps)).encode()

    def _healthz(self, request: bytes, context) -> bytes:
        return b"success"

    # -- proxy surface (mirrors HTTPProxy) ----------------------------------
    def add_app(self, name: str, handle: DeploymentHandle) -> None:
        self.apps[name] = handle

    def remove_app(self, name: str) -> None:
        self.apps.pop(name, None)

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def shutdown(self) -> None:
        self._server.stop(grace=0.5)
