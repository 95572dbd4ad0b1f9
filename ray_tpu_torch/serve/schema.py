"""Declarative Serve config: schema, validation, and deploy-from-config.

The port's copy of ``ray_tpu/serve/schema.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Parity: ``python/ray/serve/schema.py`` (``ServeDeploySchema`` /
``ServeApplicationSchema`` / ``DeploymentSchema``) and the config path of
``serve deploy`` — a YAML/dict description of applications:

.. code-block:: yaml

    applications:
      - name: app1
        route_prefix: /app1
        import_path: my_module:app          # module:attr of a bound Application
        deployments:                        # per-deployment overrides
          - name: Model
            num_replicas: 2
            max_ongoing_requests: 16
            autoscaling_config: {min_replicas: 1, max_replicas: 4}

``import_path`` resolves to either a bound ``Application`` (``.bind()``
result) or a ``Deployment`` (bound with no args). Overrides are applied
with ``Deployment.options`` before deploy.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List, Optional

from ray_tpu_torch.serve.deployment import Application, Deployment

_DEPLOYMENT_OVERRIDE_KEYS = {
    "num_replicas",
    "autoscaling_config",
    "ray_actor_options",
    "max_ongoing_requests",
    "max_queued_requests",
    "idempotent",
    "user_config",
    "version",
    "roles",
}


class ServeConfigError(ValueError):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ServeConfigError(msg)


def validate_config(config: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Validate a deploy config dict; returns the application list."""
    _require(isinstance(config, dict), "serve config must be a mapping")
    apps = config.get("applications")
    _require(isinstance(apps, list) and apps, "config needs a non-empty 'applications' list")
    seen_names: set = set()
    seen_prefixes: set = set()
    for app in apps:
        _require(isinstance(app, dict), "each application must be a mapping")
        _require(bool(app.get("import_path")), "application missing 'import_path'")
        name = app.get("name", "default")
        _require(name not in seen_names, f"duplicate application name {name!r}")
        seen_names.add(name)
        prefix = app.get("route_prefix", "/")
        if prefix is not None:
            _require(
                isinstance(prefix, str) and prefix.startswith("/"),
                f"route_prefix must be a string starting with '/': {prefix!r}",
            )
            _require(prefix not in seen_prefixes, f"duplicate route_prefix {prefix!r}")
            seen_prefixes.add(prefix)
        for dep in app.get("deployments", []) or []:
            _require(isinstance(dep, dict) and "name" in dep, "deployment override needs 'name'")
            unknown = set(dep) - _DEPLOYMENT_OVERRIDE_KEYS - {"name"}
            _require(not unknown, f"unknown deployment override keys: {sorted(unknown)}")
    return apps


def import_application(import_path: str) -> Application:
    """Resolve ``module.sub:attr`` to a bound Application."""
    _require(":" in import_path, f"import_path must be 'module:attr', got {import_path!r}")
    module_name, attr = import_path.split(":", 1)
    module = importlib.import_module(module_name)
    target = module
    for part in attr.split("."):
        target = getattr(target, part)
    if isinstance(target, Deployment):
        target = target.bind()
    _require(
        isinstance(target, Application),
        f"{import_path!r} resolved to {type(target).__name__}, expected a bound Application",
    )
    return target


def apply_overrides(app: Application, overrides: List[Dict[str, Any]]) -> Application:
    """Overridden COPY of the app graph. The input graph is typically the
    module-cached object behind import_path — mutating it would leak one
    deploy's overrides into the next."""
    by_name = {o["name"]: {k: v for k, v in o.items() if k != "name"} for o in overrides}
    if not by_name:
        return app
    used: set = set()
    memo: Dict[int, Application] = {}

    def clone(node: Application) -> Application:
        cached = memo.get(id(node))
        if cached is not None:
            return cached
        args = tuple(clone(a) if isinstance(a, Application) else a for a in node.init_args)
        kwargs = {k: (clone(v) if isinstance(v, Application) else v) for k, v in node.init_kwargs.items()}
        dep = node.deployment
        opts = by_name.get(dep.name)
        if opts is not None:
            used.add(dep.name)
            dep = dep.options(name=dep.name, **opts)
        out = memo[id(node)] = Application(dep, args, kwargs)
        return out

    cloned = clone(app)
    unknown = set(by_name) - used
    _require(not unknown, f"overrides for unknown deployments: {sorted(unknown)}")
    return cloned


def deploy_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """Deploy every application in the config; returns a status dict."""
    from ray_tpu_torch import serve

    apps = validate_config(config)
    deployed = {}
    for spec in apps:
        app = import_application(spec["import_path"])
        app = apply_overrides(app, spec.get("deployments", []) or [])
        name = spec.get("name", "default")
        handle = serve.run(app, name=name, route_prefix=spec.get("route_prefix", "/"))
        deployed[name] = {
            "route_prefix": spec.get("route_prefix", "/"),
            "ingress": handle.deployment_name,
        }
    return deployed


def load_config_file(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    _require(isinstance(cfg, dict), f"{path} did not parse to a mapping")
    return cfg
