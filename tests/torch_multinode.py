"""Run the JAX package's multi-node test bodies through both packages.

A scenario is a test function of a JAX test module (``test_multihost.py``,
``test_head_restart.py``, ...).  :func:`run_case` runs it once as written,
against the JAX head and JAX node agents, or once ported
(``torch_ported.ported``: module globals, imports and the agent module named
in its strings bound to ``ray_tpu_torch``), against the port's head and the
port's agents on the CPU.  The fixtures the JAX bodies take are rebuilt here
for the package at hand; a port agent logs to a per-pid file, as
``test_multihost._spawn_agent`` does, but under the temporary directory
(``TMPDIR``): the JAX bodies' fixed ``/tmp/rt_*`` paths are rewritten to
``<tmp>/rttorch_*``.
"""

import contextlib
import importlib
import inspect
import os
import tempfile
import types

from torch_ported import ported

PACKAGES = ("ray_tpu", "ray_tpu_torch")

#: substrings of the JAX tests' string constants that name the JAX package
#: (agent command lines, the head runner scripts)
_PORT_SUBSTRINGS = (
    ("ray_tpu.runtime.agent", "ray_tpu_torch.runtime.agent"),
    ("import ray_tpu as rt", "import ray_tpu_torch as rt"),
    ("from ray_tpu.util import collective", "from ray_tpu_torch.util import collective"),
    # the agent log directory and session paths: the port's own, under TMPDIR
    ("/tmp/rt_", os.path.join(tempfile.gettempdir(), "rttorch_")),
)


def rewrite(s: str) -> str:
    for a, b in _PORT_SUBSTRINGS:
        s = s.replace(a, b)
    return s


def for_package(fn, pkg: str, **overrides):
    """``fn`` as written for the JAX package, ported for the port (the
    modules its code imports renamed too: the functions and classes a body
    defines run in agent processes)."""
    if pkg == "ray_tpu":
        return fn
    return ported(fn, rewrite, _rename_imports=True, **overrides)


def _mh(pkg: str):
    """test_multihost's agent helpers for ``pkg``."""
    import test_multihost as jax_mh

    return (for_package(jax_mh._spawn_agent, pkg), for_package(jax_mh._wait_for_nodes, pkg))


def _start_clean(rt) -> None:
    """Shut down a runtime of this package that an earlier test in this
    process left running, so this case starts from none.  Under load a
    JAX serve test's background thread can call the API after its test's
    ``shutdown``, and the API's auto-init then starts a new runtime
    (ROADMAP Queue 3, F27)."""
    if rt.is_initialized():
        rt.shutdown()


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=10)


@contextlib.contextmanager
def two_process_cluster(pkg: str, agent_cpus: int = 2):
    """``test_multihost.two_process_cluster`` for ``pkg`` (``agent_cpus``:
    room for the actors of several cases on one shared agent)."""
    rt = importlib.import_module(pkg)
    spawn, wait = _mh(pkg)
    _start_clean(rt)
    rt.init(num_cpus=2)
    cluster = rt.get_cluster()
    proc = spawn(cluster.start_head_service(), num_cpus=agent_cpus)
    try:
        wait(cluster, 2)
        yield cluster, proc
    finally:
        _stop([proc])
        rt.shutdown()


@contextlib.contextmanager
def two_agent_cluster(pkg: str):
    """``test_data_plane.two_agent_cluster`` for ``pkg``."""
    rt = importlib.import_module(pkg)
    spawn, wait = _mh(pkg)
    _start_clean(rt)
    rt.init(num_cpus=2)
    cluster = rt.get_cluster()
    address = cluster.start_head_service()
    procs = [spawn(address, extra_resources='{"ra": 4}'),
             spawn(address, extra_resources='{"rb": 4}')]
    try:
        wait(cluster, 3)
        yield cluster
    finally:
        _stop(procs)
        rt.shutdown()


@contextlib.contextmanager
def ray_start_regular(pkg: str):
    """``conftest.ray_start_regular`` for ``pkg``."""
    rt = importlib.import_module(pkg)
    _start_clean(rt)
    rt.init(num_cpus=4)
    try:
        yield rt
    finally:
        rt.shutdown()


@contextlib.contextmanager
def ray_start_cluster(pkg: str):
    """``conftest.ray_start_cluster`` for ``pkg``: (rt, cluster)."""
    rt = importlib.import_module(pkg)
    _start_clean(rt)
    cluster = rt.init(num_cpus=2)
    try:
        yield rt, cluster
    finally:
        rt.shutdown()


_BUILT = {"two_process_cluster": two_process_cluster,
          "two_agent_cluster": two_agent_cluster,
          "ray_start_regular": ray_start_regular,
          "ray_start_cluster": ray_start_cluster}


def with_modules(fn, modules: dict):
    """``fn`` (a ported copy) importing ``modules`` (name -> object) in
    place of the modules of those names: a body's own ``from test_multihost
    import ...`` then binds the port's helpers."""
    g = fn.__globals__
    base = g["__builtins__"]["__import__"]

    def _import(name, globals=None, locals=None, fromlist=(), level=0):
        if name in modules:
            return modules[name]
        return base(name, globals, locals, fromlist, level)

    g["__builtins__"] = {**g["__builtins__"], "__import__": _import}
    # a function keeps the builtins of its creation: make it anew over them
    return types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__, fn.__closure__)


def run_case(module_name: str, fn_name: str, pkg: str, request, modules=None, **overrides):
    """Run one JAX test body for ``pkg`` with its fixtures rebuilt:
    runtime fixtures from :data:`_BUILT`, the rest (``tmp_path``,
    ``capsys``, ...) from pytest's ``request``.  ``overrides`` replace
    globals of the ported copy (helpers a module imports from another
    test module); ``modules`` replace the modules its body imports, for
    the port (:func:`with_modules`)."""
    fn = for_package(getattr(importlib.import_module(module_name), fn_name), pkg, **overrides)
    if modules and pkg != "ray_tpu":
        fn = with_modules(fn, modules)
    _start_clean(importlib.import_module(pkg))
    with contextlib.ExitStack() as stack:
        kw = {}
        for name in inspect.signature(fn).parameters:
            if name in _BUILT:
                kw[name] = stack.enter_context(_BUILT[name](pkg))
            else:
                kw[name] = request.getfixturevalue(name)
        fn(**kw)


def helper_module(pkg: str):
    """test_multihost as a body of ``pkg`` imports it inside a function."""
    spawn, wait = _mh(pkg)
    return types.SimpleNamespace(_spawn_agent=spawn, _wait_for_nodes=wait)


def agent_helpers(pkg: str) -> dict:
    """Overrides that bind test_multihost's agent helpers to ``pkg`` in a
    module that imports them (test_collective_transport, test_head_restart,
    test_data_plane)."""
    spawn, wait = _mh(pkg)
    return {"_spawn_agent": spawn, "_wait_for_nodes": wait}
