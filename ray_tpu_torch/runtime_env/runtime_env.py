"""The port's copy of ``ray_tpu/runtime_env/runtime_env.py``.

RuntimeEnv / RuntimeEnvConfig classes (parity:
``python/ray/runtime_env/runtime_env.py`` — the dict-like user-facing
config objects) and ``mpi_init`` (``python/ray/runtime_env/mpi.py``)."""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch.runtime_env.plugin import validate_runtime_env


class RuntimeEnvConfig(dict):
    """Execution knobs for env setup itself (parity: RuntimeEnvConfig)."""

    def __init__(
        self,
        setup_timeout_seconds: int = 600,
        eager_install: bool = True,
    ):
        super().__init__(
            setup_timeout_seconds=setup_timeout_seconds,
            eager_install=eager_install,
        )

    @property
    def setup_timeout_seconds(self) -> int:
        return self["setup_timeout_seconds"]

    @property
    def eager_install(self) -> bool:
        return self["eager_install"]


class RuntimeEnv(dict):
    """Dict-like runtime environment (parity: ray.runtime_env.RuntimeEnv).
    Fields validate on construction through the plugin registry, so a typo'd
    key fails at definition time, not at worker start."""

    def __init__(self, **fields: Any):
        config = fields.pop("config", None)
        validate_runtime_env({k: v for k, v in fields.items()})
        super().__init__(**fields)
        if config is not None:
            self["config"] = (
                config if isinstance(config, RuntimeEnvConfig) else RuntimeEnvConfig(**config)
            )

    def to_dict(self) -> Dict[str, Any]:
        return dict(self)

    def plugin_uris(self) -> list:
        return [v for k, v in self.items() if isinstance(v, str) and "://" in v]


def mpi_init() -> Optional[Any]:
    """Initialize MPI inside an ``mpi`` runtime-env worker (parity:
    ``ray.runtime_env.mpi_init`` — the entrypoint the reference tells MPI
    jobs to call first). Returns the COMM_WORLD communicator."""
    try:
        from mpi4py import MPI  # type: ignore[import-not-found]
    except ImportError as exc:
        raise ImportError(
            "mpi_init() needs mpi4py inside the worker; declare "
            'runtime_env={"pip": ["mpi4py"], "mpi": {...}} on the task/actor'
        ) from exc
    if not MPI.Is_initialized():
        MPI.Init()
    return MPI.COMM_WORLD
