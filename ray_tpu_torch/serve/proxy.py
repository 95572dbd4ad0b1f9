"""HTTP proxy: the ingress.

The port's copy of ``ray_tpu/serve/proxy.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``; a tensor in a response (a CUDA or bfloat16 one too)
renders as the JAX package renders the matching numpy array.

Parity: ``python/ray/serve/_private/proxy.py`` — per-node HTTP ingress
routing requests by path prefix to the app's ingress deployment handle.
The reference uses uvicorn/starlette (ASGI); here a stdlib threading HTTP
server keeps the image dependency-free — each request thread blocks on the
handle's DeploymentResponse, and replica concurrency does the fan-out.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from ray_tpu_torch.core.sync import join_threads
from ray_tpu_torch.serve.router import DeploymentHandle


class _ServeHTTPHandler(BaseHTTPRequestHandler):
    proxy: "HTTPProxy" = None  # set by server factory

    def log_message(self, fmt, *args):  # silence request logging
        pass

    def _handle(self, body: Optional[bytes]) -> None:
        from urllib.parse import urlsplit

        path = urlsplit(self.path).path  # strip ?query before matching
        handle = None
        for prefix, h in sorted(self.proxy.routes.items(), key=lambda kv: -len(kv[0])):
            if path == prefix or path.startswith(prefix.rstrip("/") + "/") or prefix == "/":
                handle = h
                break
        if handle is None:
            self.send_response(404)
            self.end_headers()
            self.wfile.write(b'{"error": "no app at this route"}')
            return
        from ray_tpu_torch.observability import reqtrace
        from ray_tpu_torch.runtime.context import (
            pop_request_trace,
            pop_tenant,
            push_request_trace,
            push_tenant,
        )

        # tenant id rides the ingress header into the request context, then
        # handle -> replica -> engine admission (weighted fairness keys)
        tenant = self.headers.get("X-Tenant-Id") or self.headers.get("X-Tenant")
        tenant_token = push_tenant(tenant)
        # the request trace is BORN here (proxy admission) and rides the
        # same context path; None when disabled or not sampled
        trace = reqtrace.start_trace(
            route=prefix,
            deployment=getattr(handle, "deployment_name", ""),
            tenant=tenant,
        )
        trace_token = push_request_trace(trace)
        outcome, detail = "ok", ""
        try:
            payload: Any = None
            if body:
                try:
                    payload = json.loads(body)
                except json.JSONDecodeError:
                    payload = body.decode("utf-8", "replace")
            result = handle.remote(payload).result(timeout=self.proxy.request_timeout_s)
            if _is_stream(result):
                # generator result (in-proc replica) -> server-sent events,
                # one `data:` frame per item, flushed as produced. Once the
                # 200 + headers are out, a mid-stream failure must NOT fall
                # through to an error status (that writes a second status
                # line into the open body) — emit an error event and close.
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                try:
                    for item in result:
                        frame = json.dumps(item, default=_jsonify)
                        self.wfile.write(f"data: {frame}\n\n".encode())
                        self.wfile.flush()
                except OSError:
                    # the socket died mid-stream: the client went away
                    outcome, detail = "disconnect", "client disconnected mid-stream"
                except Exception as exc:  # noqa: BLE001
                    outcome, detail = _trace_outcome(exc)
                    try:
                        err = json.dumps({"error": str(exc)})
                        self.wfile.write(f"data: {err}\n\n".encode())
                        self.wfile.flush()
                    except OSError:
                        outcome, detail = "disconnect", "client disconnected mid-stream"
                finally:
                    # a disconnected client must FREE its decode slot: close
                    # the generator chain NOW (GeneratorExit propagates into
                    # the engine's stream pump and marks the request
                    # abandoned) instead of waiting for GC to find it
                    close = getattr(result, "close", None)
                    if close is not None:
                        try:
                            close()
                        except Exception:  # noqa: BLE001
                            pass
                return
            data = json.dumps(result, default=_jsonify).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(data)
        except Exception as exc:  # noqa: BLE001
            # coherent error -> status contract (regression-tested):
            # OverloadedError -> 429 + Retry-After, deadline/timeout -> 504,
            # actor/worker death past the retry budget -> 503, else 500.
            from ray_tpu_torch.runtime.admission import http_status_for, unwrap

            outcome, detail = _trace_outcome(exc)
            status, retry_after = http_status_for(exc)
            cause = unwrap(exc)
            self.send_response(status)
            payload = {"error": str(cause), "type": type(cause).__name__}
            if retry_after is not None:
                self.send_header("Retry-After", str(max(1, int(round(retry_after)))))
                payload["retry_after_s"] = retry_after
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(json.dumps(payload).encode())
        finally:
            pop_request_trace(trace_token)
            pop_tenant(tenant_token)
            # an engine-side terminal (crash/shed/disconnect) claimed first
            # wins: finish_trace's outcome only fills an unclaimed trace
            reqtrace.finish_trace(trace, outcome, detail)

    def do_GET(self):
        self._handle(None)

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        self._handle(self.rfile.read(length) if length else None)


def _is_stream(result) -> bool:
    """Iterator/generator results stream as SSE; lists/dicts/strs do not."""
    return hasattr(result, "__next__")


def _trace_outcome(exc: BaseException) -> tuple:
    """Map a request-terminal exception to the trace outcome vocabulary
    (finish/shed/deadline/disconnect/crash are the flight recorder's
    buckets); mirrors admission.http_status_for's type unwrapping."""
    from ray_tpu_torch.exceptions import (
        DeadlineExceededError,
        GetTimeoutError,
        OverloadedError,
        RayActorError,
        WorkerCrashedError,
    )
    from ray_tpu_torch.runtime.admission import unwrap

    cause = unwrap(exc)
    if isinstance(cause, OverloadedError):
        return "shed", f"{cause.layer}:{cause.reason}" if hasattr(cause, "layer") else str(cause)
    if isinstance(cause, (DeadlineExceededError, GetTimeoutError)):
        return "deadline", str(cause)
    if isinstance(cause, (RayActorError, WorkerCrashedError)):
        return "crash", f"{type(cause).__name__}: {cause}"
    return "error", f"{type(cause).__name__}: {cause}"


def _jsonify(obj):
    """JSON form of what ``json`` cannot render. A tensor, on the card or
    in bfloat16 too, renders as the JAX package renders the numpy array of
    the same values: ``tolist()`` of its host copy."""
    import numpy as np
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    if hasattr(obj, "tolist"):
        return obj.tolist()
    return str(obj)


class HTTPProxy:
    def __init__(self, host: str = "127.0.0.1", port: int = 8000, request_timeout_s: float = 30.0):
        self.host = host
        self.port = port
        self.routes: Dict[str, DeploymentHandle] = {}
        self.request_timeout_s = request_timeout_s
        handler = type("Handler", (_ServeHTTPHandler,), {"proxy": self})
        self.server = ThreadingHTTPServer((host, port), handler)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True, name="serve-proxy")
        self.thread.start()

    def add_route(self, prefix: str, handle: DeploymentHandle) -> None:
        self.routes[prefix] = handle

    def remove_route(self, prefix: str) -> None:
        self.routes.pop(prefix, None)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def shutdown(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        join_threads([self.thread])
