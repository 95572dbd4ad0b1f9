"""Runtime environments: per-job/task/actor execution environments.

The port's copy of ``ray_tpu/runtime_env/`` (the same ``__all__``).

Parity with ``python/ray/_private/runtime_env/``: a plugin architecture
(``plugin.py``) where each field of the ``runtime_env`` dict (env_vars,
working_dir, py_modules, …) is handled by a named plugin that prepares
resources and mutates the worker/driver process context; URI-addressed
artifacts are cached with reference counting (``uri_cache.py``).
"""

from ray_tpu_torch.runtime_env.plugin import (
    RuntimeEnvPlugin,
    apply_to_process_env,
    get_plugin,
    register_plugin,
    validate_runtime_env,
)
from ray_tpu_torch.runtime_env.runtime_env import RuntimeEnv, RuntimeEnvConfig, mpi_init
from ray_tpu_torch.runtime_env.uri_cache import URICache

__all__ = [
    "RuntimeEnv",
    "RuntimeEnvConfig",
    "RuntimeEnvPlugin",
    "apply_to_process_env",
    "get_plugin",
    "mpi_init",
    "register_plugin",
    "validate_runtime_env",
    "URICache",
]
