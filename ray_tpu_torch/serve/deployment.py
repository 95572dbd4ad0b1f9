"""Deployments: the unit of serving.

The port's copy of ``ray_tpu/serve/deployment.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Parity: ``python/ray/serve/deployment.py`` + ``api.py`` — ``@serve.deployment``
wraps a class or function; ``.options()`` tweaks replica count/resources;
``.bind(*args)`` builds the composition graph (args may be other bound
deployments, which materialize as ``DeploymentHandle``s at run time).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union


@dataclass
class AutoscalingConfig:
    """Parity: serve autoscaling_policy.py basic config."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.5
    downscale_delay_s: float = 2.0


class Deployment:
    def __init__(
        self,
        func_or_class: Union[Callable, type],
        name: str,
        *,
        num_replicas: Union[int, str] = 1,
        autoscaling_config: Optional[Union[dict, AutoscalingConfig]] = None,
        ray_actor_options: Optional[dict] = None,
        max_ongoing_requests: int = 100,
        max_queued_requests: int = -1,
        idempotent: bool = False,
        user_config: Optional[dict] = None,
        version: str = "1",
        roles: Optional[Dict[str, int]] = None,
    ):
        self.func_or_class = func_or_class
        self.name = name
        self.num_replicas = num_replicas
        # Disaggregated serving (serve/disagg.py): ``roles={"prefill": n,
        # "decode": m}`` materializes two independently-scaled replica
        # pools instead of one homogeneous set; the router migrates each
        # request's KV blocks from its prefill replica to a decode replica
        # over the device plane.  None = classic homogeneous deployment.
        # Validated at deploy time (controller.deploy -> validate_roles).
        self.roles = dict(roles) if roles else None
        if self.roles is not None:
            self.num_replicas = sum(int(v) for v in self.roles.values())
        if isinstance(autoscaling_config, dict):
            autoscaling_config = AutoscalingConfig(**autoscaling_config)
        if num_replicas == "auto" and autoscaling_config is None:
            # Parity: num_replicas="auto" enables default autoscaling.
            autoscaling_config = AutoscalingConfig()
        self.autoscaling_config = autoscaling_config
        self.ray_actor_options = ray_actor_options or {}
        self.max_ongoing_requests = max_ongoing_requests
        # Admission bound on requests WAITING for this deployment beyond
        # its replicas' concurrency (parity: serve's max_queued_requests
        # rejection path).  -1 = unbounded (the historical behavior); past
        # the bound the router sheds with OverloadedError -> HTTP 429.
        self.max_queued_requests = max_queued_requests
        # Replica-death replay gate: only idempotent deployments may have a
        # request REPLAYED after its replica died mid-flight (the original
        # may have executed its side effects before dying).  Default False:
        # at-most-once — the caller sees the typed actor error and decides.
        self.idempotent = idempotent
        self.user_config = user_config
        self.version = version

    def options(self, **kwargs) -> "Deployment":
        merged = dict(
            num_replicas=self.num_replicas,
            autoscaling_config=self.autoscaling_config,
            ray_actor_options=self.ray_actor_options,
            max_ongoing_requests=self.max_ongoing_requests,
            max_queued_requests=self.max_queued_requests,
            idempotent=self.idempotent,
            user_config=self.user_config,
            version=self.version,
            roles=self.roles,
        )
        name = kwargs.pop("name", self.name)
        merged.update(kwargs)
        return Deployment(self.func_or_class, name, **merged)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    def __repr__(self) -> str:
        return f"Deployment(name={self.name!r}, num_replicas={self.num_replicas})"


class Application:
    """A bound deployment DAG node (parity: serve Application from .bind())."""

    def __init__(self, deployment: Deployment, init_args: Tuple, init_kwargs: dict):
        self.deployment = deployment
        self.init_args = init_args
        self.init_kwargs = init_kwargs

    def walk(self) -> List["Application"]:
        """All Applications in this graph, dependencies first."""
        seen: List[Application] = []

        def visit(app: Application):
            for a in list(app.init_args) + list(app.init_kwargs.values()):
                if isinstance(a, Application):
                    visit(a)
            if app not in seen:
                seen.append(app)

        visit(self)
        return seen


def deployment(
    _func_or_class: Optional[Union[Callable, type]] = None,
    *,
    name: Optional[str] = None,
    num_replicas: Union[int, str] = 1,
    autoscaling_config: Optional[Union[dict, AutoscalingConfig]] = None,
    ray_actor_options: Optional[dict] = None,
    max_ongoing_requests: int = 100,
    max_queued_requests: int = -1,
    idempotent: bool = False,
    user_config: Optional[dict] = None,
    version: str = "1",
    roles: Optional[Dict[str, int]] = None,
):
    """``@serve.deployment`` (parity: serve/api.py:deployment)."""

    def wrap(fc):
        return Deployment(
            fc,
            name or getattr(fc, "__name__", "deployment"),
            num_replicas=num_replicas,
            autoscaling_config=autoscaling_config,
            ray_actor_options=ray_actor_options,
            max_ongoing_requests=max_ongoing_requests,
            max_queued_requests=max_queued_requests,
            idempotent=idempotent,
            user_config=user_config,
            version=version,
            roles=roles,
        )

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap
