"""Runtime-env plugin architecture.

The port's copy of ``ray_tpu/runtime_env/plugin.py``: the same plugins,
validation, staging and errors.  Its staged artifacts live in a resource
directory of its own (``<tmp>/rt_torch_runtime_env_<pid>``) and task
profiles default to ``<tmp>/rt_torch_task_profiles``, so the two packages
in one process never evict or overwrite each other's files.  A task that
holds a GPU share runs its runtime env in a worker that sees the card
(``runtime/worker_pool.py``).

Parity with ``python/ray/_private/runtime_env/plugin.py``: each runtime_env
field maps to a plugin with validate/create/modify hooks.  Shipped plugins:

  * ``env_vars``    — extra environment variables (validated str→str)
  * ``working_dir`` — a local directory packaged (copied) into the session's
    resource dir and used as the process cwd (``working_dir.py`` parity;
    remote URIs are out of scope with zero egress)
  * ``py_modules``  — local module dirs/files staged and prepended to
    PYTHONPATH (``py_modules.py`` parity)
  * ``pip`` / ``conda`` — declared for API parity; creation raises unless
    the env already satisfies them, since the image has no network

Creation is cached per-URI through :class:`~ray_tpu_torch.runtime_env.uri_cache.URICache`.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
from typing import Dict, Optional, Tuple

from ray_tpu_torch.runtime_env.uri_cache import URICache

_RESOURCE_DIR = None
_cache = URICache()
#: where ``runtime_env={"profiling": True}`` dumps a task's pstats file
PROFILE_DIR = os.path.join(tempfile.gettempdir(), "rt_torch_task_profiles")


def _resource_dir() -> str:
    global _RESOURCE_DIR
    if _RESOURCE_DIR is None:
        _RESOURCE_DIR = os.path.join(tempfile.gettempdir(), f"rt_torch_runtime_env_{os.getpid()}")
        os.makedirs(_RESOURCE_DIR, exist_ok=True)
    return _RESOURCE_DIR


class RuntimeEnvPlugin:
    """Base plugin. ``name`` is the runtime_env dict key it owns."""

    name: str = ""
    priority: int = 10

    def validate(self, value) -> None:
        pass

    def create(self, value) -> Optional[str]:
        """Prepare resources; returns a URI for cache bookkeeping (or None)."""
        return None

    def modify_context(
        self,
        value,
        env: Dict[str, str],
        cwd: Optional[str],
        uris: Optional[list] = None,
    ) -> Tuple[Dict[str, str], Optional[str]]:
        """Mutate the process env/cwd the worker or driver will start with.
        Staging plugins append the cache URIs they used to ``uris`` so the
        caller can hold references for the process's lifetime."""
        return env, cwd


class EnvVarsPlugin(RuntimeEnvPlugin):
    name = "env_vars"
    priority = 0

    def validate(self, value) -> None:
        if not isinstance(value, dict) or not all(
            isinstance(k, str) and isinstance(v, str) for k, v in value.items()
        ):
            raise TypeError("runtime_env['env_vars'] must be a Dict[str, str]")

    def modify_context(self, value, env, cwd, uris=None):
        env.update(value)
        return env, cwd


def _fingerprint(path: str) -> str:
    """Cheap content fingerprint: relative names + sizes + mtimes. A changed
    source dir therefore yields a new URI and gets re-staged (the reference
    hashes the packaged zip the same way, packaging.py)."""
    path = os.path.abspath(os.path.expanduser(path))
    if not os.path.exists(path):
        raise FileNotFoundError(f"runtime_env path does not exist: {path}")
    h = hashlib.sha1(path.encode())
    if os.path.isfile(path):
        st = os.stat(path)
        h.update(f"{st.st_size}:{st.st_mtime_ns}".encode())
    else:
        for root, dirs, files in os.walk(path):
            dirs.sort()
            for f in sorted(files):
                fp = os.path.join(root, f)
                try:
                    st = os.stat(fp)
                except OSError:
                    continue
                h.update(f"{os.path.relpath(fp, path)}:{st.st_size}:{st.st_mtime_ns};".encode())
    return h.hexdigest()[:16]


def uri_for(path: str, kind: str) -> str:
    return f"{kind}://{os.path.abspath(os.path.expanduser(path))}@{_fingerprint(path)}"


def _stage_dir(path: str, kind: str) -> str:
    """Copy a local dir/file into the session resource dir, content-addressed;
    the copy lands in a temp dir and is renamed into place so readers never
    see a partial stage."""
    path = os.path.abspath(os.path.expanduser(path))
    h = _fingerprint(path)
    # Keep the artifact's own basename (it must stay importable for
    # py_modules); uniqueness comes from the hashed parent dir.
    parent = os.path.join(_resource_dir(), f"{kind}-{h}")
    dest = os.path.join(parent, os.path.basename(path))
    if not os.path.exists(dest):
        tmp_parent = parent + ".tmp"
        shutil.rmtree(tmp_parent, ignore_errors=True)
        os.makedirs(tmp_parent, exist_ok=True)
        tmp = os.path.join(tmp_parent, os.path.basename(path))
        if os.path.isdir(path):
            shutil.copytree(path, tmp)
        else:
            shutil.copy2(path, tmp)
        try:
            os.rename(tmp_parent, parent)
        except OSError:
            shutil.rmtree(tmp_parent, ignore_errors=True)  # a racer won
    return dest


class WorkingDirPlugin(RuntimeEnvPlugin):
    name = "working_dir"
    priority = 1

    def validate(self, value) -> None:
        if not isinstance(value, str):
            raise TypeError("runtime_env['working_dir'] must be a local directory path")

    def create(self, value) -> str:
        return _stage_dir(value, "working_dir")

    def modify_context(self, value, env, cwd, uris=None):
        uri = uri_for(value, "working_dir")
        staged = _cache.get_or_create(uri, lambda: self.create(value), add_ref=uris is not None)
        if uris is not None:
            uris.append(uri)
        return env, staged


class PyModulesPlugin(RuntimeEnvPlugin):
    name = "py_modules"
    priority = 2

    def validate(self, value) -> None:
        if not isinstance(value, (list, tuple)) or not all(isinstance(v, str) for v in value):
            raise TypeError("runtime_env['py_modules'] must be a list of local paths")

    def modify_context(self, value, env, cwd, uris=None):
        staged_paths = []
        for mod in value:
            uri = uri_for(mod, "py_modules")
            staged = _cache.get_or_create(
                uri, lambda m=mod: _stage_dir(m, "py_modules"), add_ref=uris is not None
            )
            if uris is not None:
                uris.append(uri)
            # a staged package dir's *parent* goes on sys.path
            staged_paths.append(os.path.dirname(staged) if os.path.isdir(staged) else staged)
        existing = env.get("PYTHONPATH", "")
        env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(staged_paths + ([existing] if existing else [])))
        return env, cwd


_DIST_MODULES: Optional[Dict[str, list]] = None


def _dist_module_map() -> Dict[str, list]:
    """distribution name -> importable module(s): "scikit-learn" installs
    "sklearn" etc. Scanning installed-dist metadata is O(100ms); the result
    only changes on (un)install, so compute once per process."""
    global _DIST_MODULES
    if _DIST_MODULES is None:
        import importlib.metadata

        mapping: Dict[str, list] = {}
        try:
            for module, dists in importlib.metadata.packages_distributions().items():
                for d in dists:
                    mapping.setdefault(d.lower().replace("_", "-"), []).append(module)
        except Exception:
            pass
        _DIST_MODULES = mapping
    return _DIST_MODULES


class PipPlugin(RuntimeEnvPlugin):
    """Parity with ``pip.py:425``; the zero-egress image cannot install, so
    creation verifies the requirements are already importable and otherwise
    raises with a clear message."""

    name = "pip"
    priority = 3

    def validate(self, value) -> None:
        if not isinstance(value, (list, dict)):
            raise TypeError("runtime_env['pip'] must be a list of requirements or a dict")

    def modify_context(self, value, env, cwd, uris=None):
        import importlib.util

        dist_modules = _dist_module_map()
        reqs = value if isinstance(value, list) else value.get("packages", [])
        missing = []
        for req in reqs:
            base = req.split("==")[0].split(">=")[0].split("<")[0].strip()
            candidates = list(dist_modules.get(base.lower().replace("_", "-"), []))
            candidates.append(base.replace("-", "_"))
            if not any(importlib.util.find_spec(c) is not None for c in candidates):
                missing.append(req)
        if missing:
            raise RuntimeError(
                f"runtime_env pip packages not pre-installed and the environment "
                f"has no network access: {missing}"
            )
        return env, cwd


class CondaPlugin(RuntimeEnvPlugin):
    """Parity with ``conda.py:259``; like pip, the zero-egress image cannot
    solve/install environments, so the plugin validates shape and verifies
    any pip-style dependency list is already importable."""

    name = "conda"
    priority = 3

    def validate(self, value) -> None:
        if not isinstance(value, (str, dict)):
            raise TypeError(
                "runtime_env['conda'] must be an env name or an environment.yml dict"
            )

    def modify_context(self, value, env, cwd, uris=None):
        if isinstance(value, str):
            raise RuntimeError(
                f"runtime_env conda env {value!r}: no conda installation is "
                "available in this environment"
            )
        deps = value.get("dependencies", [])
        reqs = []
        for d in deps:
            if isinstance(d, dict) and "pip" in d:
                reqs.extend(d["pip"])
            elif isinstance(d, str) and d.split("=")[0] not in ("python", "pip"):
                # conda-native packages verify the same way: importable or
                # fail fast with the clear not-pre-installed error
                reqs.append(d.split("=")[0])
        if reqs:
            return PipPlugin().modify_context(reqs, env, cwd, uris)
        return env, cwd


class ContainerPlugin(RuntimeEnvPlugin):
    """Run the job entrypoint inside a container (reference:
    ``python/ray/_private/runtime_env/container.py`` — podman-wrapped worker
    commands).  Value shape::

        {"image": "img:tag", "run_options": ["--net=host", ...]}

    The container engine is resolved at validate time (podman preferred,
    docker fallback); the repo/working dir is bind-mounted so staged
    runtime-env artifacts stay visible."""

    name = "container"
    priority = 90  # wraps last: sees the final env/cwd

    def _engine(self) -> Optional[str]:
        import shutil as _shutil

        for exe in ("podman", "docker"):
            if _shutil.which(exe):
                return exe
        return None

    def validate(self, value) -> None:
        if not isinstance(value, dict) or "image" not in value:
            raise ValueError("runtime_env['container'] must be {'image': ..., ...}")
        if self._engine() is None:
            raise ValueError(
                "runtime_env['container'] requires podman or docker on PATH"
            )

    def wrap_entrypoint(
        self, value, entrypoint: str, env: Dict[str, str], cwd: Optional[str],
        runtime_env: Optional[dict] = None,
    ) -> str:
        import shlex

        engine = self._engine()
        workdir = cwd or os.getcwd()
        # forward exactly the user's env_vars (host PYTHONPATH etc. would be
        # dangling paths inside the image — the image must ship its own
        # Python environment, reference container.py behavior)
        user_env = (runtime_env or {}).get("env_vars", {})
        parts = [engine, "run", "--rm"]
        parts.extend(shlex.quote(o) for o in value.get("run_options", ()))
        parts.extend(["-v", f"{shlex.quote(workdir)}:/work", "-w", "/work"])
        for k, v in user_env.items():
            parts.extend(["-e", shlex.quote(f"{k}={v}")])
        parts.extend([shlex.quote(value["image"]), "/bin/sh", "-c", shlex.quote(entrypoint)])
        # join non-empty parts with single spaces: a post-hoc
        # .replace("  ", " ") would corrupt double spaces INSIDE quoted values
        return " ".join(p for p in parts if p)


class MPIPlugin(RuntimeEnvPlugin):
    """Wrap the entrypoint in ``mpirun`` (reference:
    ``python/ray/_private/runtime_env/mpi.py:41`` ``MPIPlugin`` wrapping
    worker exec in mpirun :104).  Value shape::

        {"worker_entry": ..., "args": ["-n", "4"]}  # or {"processes": 4}
    """

    name = "mpi"
    priority = 80

    def validate(self, value) -> None:
        if not isinstance(value, dict):
            raise ValueError("runtime_env['mpi'] must be a dict")
        import shutil as _shutil

        if _shutil.which("mpirun") is None:
            raise ValueError("runtime_env['mpi'] requires mpirun on PATH")

    def wrap_entrypoint(
        self, value, entrypoint: str, env: Dict[str, str], cwd: Optional[str],
        runtime_env: Optional[dict] = None,
    ) -> str:
        import shlex

        if "args" in value:
            args = " ".join(shlex.quote(a) for a in value["args"])
        else:
            args = f"-n {int(value.get('processes', 1))}"
        return f"mpirun {args} /bin/sh -c {shlex.quote(entrypoint)}"


class ProfilingPlugin(RuntimeEnvPlugin):
    """Per-task cProfile capture (reference role: the profiling runtime-env
    plugins — ``_private/runtime_env/nsight.py`` shape, py-spy dashboard
    integration — rebuilt CPU-native: device work is profiled by
    ``torch.profiler``, what needs a runtime-env switch is the PYTHON side of
    a task).  Value shape::

        {"profiling": True}                      # profiles to the session dir
        {"profiling": {"dir": "/tmp/profs"}}     # explicit output dir

    Workers honor ``RAY_TPU_TASK_PROFILING``: every task/actor-call body
    runs under cProfile and dumps ``<name>_<task_id>.prof`` (pstats
    loadable) into the directory.  Zero overhead when unset."""

    name = "profiling"
    priority = 5

    def validate(self, value) -> None:
        if not (value is True or isinstance(value, dict)):
            raise ValueError("runtime_env['profiling'] must be True or {'dir': path}")
        if isinstance(value, dict) and set(value) - {"dir"}:
            raise ValueError(f"unknown profiling keys {set(value) - {'dir'}}")

    def modify_context(self, value, env, cwd, uris=None):
        out_dir = value.get("dir") if isinstance(value, dict) else None
        if not out_dir:
            out_dir = PROFILE_DIR
        os.makedirs(out_dir, exist_ok=True)
        env["RAY_TPU_TASK_PROFILING"] = out_dir
        return env, cwd


def maybe_profile(name: str, task_id_hex: str, fn, args, kwargs):
    """Worker-side hook for ProfilingPlugin: run a task body under cProfile
    when RAY_TPU_TASK_PROFILING is set, dumping a pstats-loadable file per
    task.  One getenv when profiling is off."""
    out_dir = os.environ.get("RAY_TPU_TASK_PROFILING")
    if not out_dir:
        return fn(*args, **kwargs)
    import cProfile
    import re

    prof = cProfile.Profile()
    try:
        return prof.runcall(fn, *args, **kwargs)
    finally:
        safe = re.sub(r"[^A-Za-z0-9_.-]", "_", name or "task")[:60]
        try:
            os.makedirs(out_dir, exist_ok=True)  # this process may not be the creator
            prof.dump_stats(os.path.join(out_dir, f"{safe}_{task_id_hex[:12]}.prof"))
        except OSError as exc:
            # profiling must never fail the task — but silence here means
            # "profiling on, zero profiles, no clue"; say why once
            import logging

            logging.getLogger(__name__).warning(
                "profiling dump to %s failed: %s", out_dir, exc
            )


def wrap_entrypoint(
    runtime_env: dict, entrypoint: str, env: Dict[str, str], cwd: Optional[str]
) -> str:
    """Apply every command-wrapping plugin (mpi, container) to a job
    entrypoint, in priority order."""
    for key in sorted(runtime_env, key=lambda k: getattr(_plugins.get(k), "priority", 10)):
        plugin = _plugins.get(key)
        if plugin is not None and hasattr(plugin, "wrap_entrypoint"):
            entrypoint = plugin.wrap_entrypoint(
                runtime_env[key], entrypoint, env, cwd, runtime_env=runtime_env
            )
    return entrypoint


_plugins: Dict[str, RuntimeEnvPlugin] = {}


def register_plugin(plugin: RuntimeEnvPlugin) -> None:
    _plugins[plugin.name] = plugin


def get_plugin(name: str) -> Optional[RuntimeEnvPlugin]:
    return _plugins.get(name)


for _p in (
    EnvVarsPlugin(), WorkingDirPlugin(), PyModulesPlugin(), PipPlugin(),
    CondaPlugin(), ContainerPlugin(), MPIPlugin(), ProfilingPlugin(),
):
    register_plugin(_p)


# meta keys that configure env setup itself rather than naming a plugin
# (parity: runtime_env["config"] = RuntimeEnvConfig — runtime_env.py)
_META_KEYS = frozenset({"config"})


def validate_runtime_env(runtime_env: dict) -> None:
    for key, value in runtime_env.items():
        if key in _META_KEYS:
            continue
        plugin = _plugins.get(key)
        if plugin is None:
            raise ValueError(f"unknown runtime_env field {key!r}; known: {sorted(_plugins)}")
        plugin.validate(value)


def apply_to_process_env(
    runtime_env: dict,
    env: Dict[str, str],
    cwd: Optional[str] = None,
    uris_out: Optional[list] = None,
) -> Tuple[Dict[str, str], Optional[str]]:
    """Run every relevant plugin's modify_context, in priority order.

    Pass ``uris_out`` to collect the cache URIs the env uses; each staged
    artifact is reference-pinned atomically as it is handed out, so eviction
    never deletes a directory a live job is running from. Release with
    :func:`remove_references` when the process exits.
    """
    validate_runtime_env(runtime_env)
    for plugin in sorted(
        (_plugins[k] for k in runtime_env if k not in _META_KEYS),
        key=lambda p: p.priority,
    ):
        env, cwd = plugin.modify_context(runtime_env[plugin.name], env, cwd, uris_out)
    return env, cwd


def add_references(uris: list) -> None:
    for uri in uris:
        _cache.add_reference(uri)


def remove_references(uris: list) -> None:
    for uri in uris:
        _cache.remove_reference(uri)
