"""Run a JAX-package test's own body against the port.

:func:`ported` returns a copy of a test function whose module globals and
``import`` statements name the port (``ray_tpu`` -> ``ray_tpu_torch``)
and whose string constants pass through ``rewrite``, so the reference's
assertions hold the port to the same behaviour.  The test files that use
it import the JAX test module and run each case once as written and once
ported.
"""

import builtins
import importlib
import types


def port_name(name: str) -> str:
    if name == "ray_tpu" or name.startswith("ray_tpu."):
        return "ray_tpu_torch" + name[len("ray_tpu"):]
    return name


def _port_import(name, globals=None, locals=None, fromlist=(), level=0):
    return builtins.__import__(port_name(name), globals, locals, fromlist, level)


def is_ported(fn) -> bool:
    return fn.__globals__.get("__builtins__", {}).get("__import__") is _port_import


def _port_value(v, rewrite):
    """The port's counterpart of a JAX-package module, class or function;
    a string through ``rewrite``."""
    if isinstance(v, str):
        return rewrite(v)
    if isinstance(v, types.ModuleType) and (v.__name__ == "ray_tpu"
                                            or v.__name__.startswith("ray_tpu.")):
        return importlib.import_module(port_name(v.__name__))
    mod = getattr(v, "__module__", None)
    if (isinstance(v, (type, types.FunctionType)) and isinstance(mod, str)
            and mod.startswith("ray_tpu.")):
        return getattr(importlib.import_module(port_name(mod)), v.__name__)
    return v


def _port_code(code: types.CodeType, rewrite) -> types.CodeType:
    consts = tuple(_port_code(c, rewrite) if isinstance(c, types.CodeType)
                   else rewrite(c) if isinstance(c, str) else c
                   for c in code.co_consts)
    return code.replace(co_consts=consts)


def _copy(fn, g, rewrite):
    return types.FunctionType(_port_code(fn.__code__, rewrite), g, fn.__name__,
                              fn.__defaults__, fn.__closure__)


def _with_helpers(fn, g, rewrite):
    """Copies of ``fn`` and of its module's functions over the globals ``g``."""
    for k, v in list(g.items()):
        if isinstance(v, types.FunctionType) and v.__module__ == fn.__module__:
            g[k] = _copy(v, g, rewrite)
    return _copy(fn, g, rewrite)


def rebound(fn, **overrides):
    """``fn`` and its module's helpers with ``overrides`` in their globals."""
    return _with_helpers(fn, {**fn.__globals__, **overrides}, lambda s: s)


def ported(fn, rewrite=lambda s: s, **overrides):
    """``fn`` with its globals and imports bound to the port; the helper
    functions of its module are ported with it; ``overrides`` replace
    globals of the copy."""
    g = {k: _port_value(v, rewrite) for k, v in fn.__globals__.items()}
    g["__builtins__"] = {**vars(builtins), "__import__": _port_import}
    g.update(overrides)
    return _with_helpers(fn, g, rewrite)
