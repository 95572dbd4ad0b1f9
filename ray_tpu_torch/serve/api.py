"""serve public API: run/start/shutdown/status/get_deployment_handle.

The port's copy of ``ray_tpu/serve/api.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Parity: ``python/ray/serve/api.py`` — ``serve.run(app)`` deploys a bound
application graph and returns the ingress handle; composition materializes
child Applications as DeploymentHandles passed to parent constructors
(deployment-graph semantics, SURVEY §3.6).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.controller import ServeControllerActor
from ray_tpu_torch.serve.deployment import Application, Deployment
from ray_tpu_torch.serve.proxy import HTTPProxy
from ray_tpu_torch.serve.router import DeploymentHandle

_state_lock = threading.RLock()
_controller = None
_proxy: Optional[HTTPProxy] = None
_grpc_proxy = None
_apps: Dict[str, DeploymentHandle] = {}  # app name -> ingress handle
_topology: Dict[str, dict] = {}  # app name -> deployment DAG (dashboard view)


@dataclass
class HTTPOptions:
    """HTTP ingress options (parity: serve.config.HTTPOptions — the
    subset the proxy honors; pass to ``serve.start(http_options=...)``)."""

    host: str = "127.0.0.1"
    port: int = 0
    request_timeout_s: float = 30.0


def start(
    *,
    http_host: str = "127.0.0.1",
    http_port: int = 0,
    request_timeout_s: float = 30.0,
    grpc_port: Optional[int] = None,
    grpc_allow_pickle: bool = False,
    http_options: Optional[HTTPOptions] = None,
):
    """Start the Serve instance (controller + HTTP proxy; pass ``grpc_port``
    — 0 for an ephemeral port — to also open the gRPC ingress, parity with
    the reference's gRPCOptions). ``grpc_allow_pickle`` enables the pickle
    payload codec — trusted networks only (pickle executes client bytes)."""
    if http_options is not None:
        http_host = http_options.host
        http_port = http_options.port
        request_timeout_s = http_options.request_timeout_s
    global _controller, _proxy, _grpc_proxy
    with _state_lock:
        if _controller is None:
            _controller = ServeControllerActor.options(execution="inproc", max_concurrency=64).remote()
            ray_tpu_torch.get(_controller.ping.remote())
        if _proxy is None:
            _proxy = HTTPProxy(http_host, http_port, request_timeout_s)
        if _grpc_proxy is None and grpc_port is not None:
            from ray_tpu_torch.serve.grpc_proxy import GRPCProxy

            _grpc_proxy = GRPCProxy(
                http_host, grpc_port, request_timeout_s, allow_pickle=grpc_allow_pickle
            )
            for app_name, handle in _apps.items():  # apps deployed pre-start
                _grpc_proxy.add_app(app_name, handle)
    return _controller


def _require_started():
    if _controller is None:
        start()
    return _controller


def run(app: Application, *, name: str = "default", route_prefix: Optional[str] = "/") -> DeploymentHandle:
    """Deploy an application graph; returns the ingress handle."""
    controller = _require_started()
    apps = app.walk()  # dependencies first
    # the DAG shape for the dashboard's topology view (reference: the
    # serve dashboard's application graph) — registered under the state
    # lock AFTER every deploy succeeds, beside _apps, so status() never
    # shows an app that failed to deploy or raced a shutdown
    topology = {
        "ingress": app.deployment.name,
        "route_prefix": route_prefix,
        "deployments": [
            {
                "name": sub.deployment.name,
                "num_replicas": sub.deployment.num_replicas,
                "depends_on": sorted(
                    {
                        a.deployment.name
                        for a in list(sub.init_args) + list(sub.init_kwargs.values())
                        if isinstance(a, Application)
                    }
                ),
            }
            for sub in apps
        ],
    }
    handles: Dict[int, DeploymentHandle] = {}
    for sub in apps:
        init_args = tuple(handles[id(a)] if isinstance(a, Application) else a for a in sub.init_args)
        init_kwargs = {
            k: (handles[id(v)] if isinstance(v, Application) else v) for k, v in sub.init_kwargs.items()
        }
        ray_tpu_torch.get(controller.deploy.remote(sub.deployment, init_args, init_kwargs))
        handles[id(sub)] = DeploymentHandle(sub.deployment.name, controller)
    ingress = handles[id(app)]
    if route_prefix is not None:
        ray_tpu_torch.get(controller.set_ingress.remote(route_prefix, app.deployment.name))
    # registration into the proxies/app map under the state lock: a
    # concurrent shutdown()/start() must not see a half-registered app or
    # register into a proxy being torn down
    with _state_lock:
        if route_prefix is not None and _proxy is not None:
            _proxy.add_route(route_prefix, ingress)
        _apps[name] = ingress
        _topology[name] = topology
        if _grpc_proxy is not None:
            _grpc_proxy.add_app(name, ingress)
    return ingress


def run_config(config) -> Dict[str, Any]:
    """Deploy from a declarative config: a dict, or a path to a YAML file
    (parity: ``serve deploy`` / ``serve run`` config path, serve/schema.py)."""
    from ray_tpu_torch.serve import schema

    if isinstance(config, str):
        config = schema.load_config_file(config)
    return schema.deploy_config(config)


def get_deployment_handle(deployment_name: str, app_name: str = "default") -> DeploymentHandle:
    controller = _require_started()
    return DeploymentHandle(deployment_name, controller)


def get_app_handle(name: str = "default") -> DeploymentHandle:
    """Handle to a running application's ingress deployment (parity:
    serve.get_app_handle)."""
    with _state_lock:
        handle = _apps.get(name)
    if handle is None:
        raise KeyError(
            f"no running Serve application named {name!r}; deployed apps: "
            f"{sorted(_apps)}"
        )
    return handle


def _run(app, *, name: str = "default", route_prefix: Optional[str] = "/", **_ignored) -> DeploymentHandle:
    """Internal non-blocking deploy variant (reference serve._run — same
    behavior here because run() already returns without blocking)."""
    return run(app, name=name, route_prefix=route_prefix)


def ingress(app):
    """FastAPI ingress decorator (parity: serve.ingress).  The fastapi
    package is not installed in this environment; plain deployments with
    __call__ handlers and the HTTP proxy's route dispatch cover the
    native ingress path."""
    raise ImportError(
        "serve.ingress requires the fastapi package, which is not installed "
        "in this environment; define a deployment class with a __call__ "
        "(request) handler and serve.run(app, route_prefix=...) instead"
    )


def status() -> Dict[str, Any]:
    controller = _require_started()
    return {
        "deployments": ray_tpu_torch.get(controller.list_deployments.remote()),
        "proxy_url": _proxy.url if _proxy else None,
        "grpc_address": _grpc_proxy.address if _grpc_proxy else None,
        "applications": dict(_topology),
    }


def delete(name: str) -> None:
    controller = _require_started()
    ray_tpu_torch.get(controller.delete_deployment.remote(name))
    # drop app registrations / proxy routes whose ingress was this
    # deployment — a stale handle would surface as ActorDiedError next call.
    # Under the state lock so a concurrent shutdown()/start() can't race the
    # proxy map mutations.
    with _state_lock:
        for app, handle in list(_apps.items()):
            if getattr(handle, "deployment_name", None) == name:
                del _apps[app]
                _topology.pop(app, None)
        # deleting a non-ingress member invalidates its app's DAG too
        for app, topo in list(_topology.items()):
            if any(d["name"] == name for d in topo.get("deployments", ())):
                _topology.pop(app, None)
        if _grpc_proxy is not None:
            for app, handle in list(_grpc_proxy.apps.items()):
                if getattr(handle, "deployment_name", None) == name:
                    _grpc_proxy.remove_app(app)
        if _proxy is not None:
            for prefix, handle in list(_proxy.routes.items()):
                if getattr(handle, "deployment_name", None) == name:
                    _proxy.remove_route(prefix)


def proxy_url() -> Optional[str]:
    return _proxy.url if _proxy else None


def grpc_address() -> Optional[str]:
    """host:port of the gRPC ingress, or None when not started."""
    return _grpc_proxy.address if _grpc_proxy else None


def shutdown() -> None:
    global _controller, _proxy, _grpc_proxy
    with _state_lock:
        _apps.clear()
        _topology.clear()
        if _grpc_proxy is not None:
            _grpc_proxy.shutdown()
            _grpc_proxy = None
        if _proxy is not None:
            _proxy.shutdown()
            _proxy = None
        if _controller is not None:
            try:
                ray_tpu_torch.get(_controller.shutdown.remote())
                ray_tpu_torch.kill(_controller)
            except Exception:
                pass
            _controller = None
        from ray_tpu_torch.serve.router import clear_router_cache

        clear_router_cache()
