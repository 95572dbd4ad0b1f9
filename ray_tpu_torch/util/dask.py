"""Dask-on-ray_tpu_torch: execute dask task graphs on the cluster's task fabric.

The port's copy of ``ray_tpu/util/dask.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Parity: ``python/ray/util/dask/scheduler.py`` (``ray_dask_get`` — the
drop-in dask scheduler that turns every graph node into a submitted task,
with dependencies passed as object refs so the fabric handles ordering and
locality) and ``python/ray/util/dask/__init__.py`` (``enable_dask_on_ray``
config hook).

A dask graph is plain data — ``{key: literal | key | (callable, *args)}``
with keys referenced anywhere inside task args — so the scheduler itself
has no dask dependency at all; only ``enable_dask_on_ray`` (which flips
``dask.config``) needs dask importable.  That means graphs hand-built or
produced by any dask collection run unmodified.
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, List, Set

import ray_tpu_torch

__all__ = [
    "ray_dask_get",
    "ray_dask_get_sync",
    "enable_dask_on_ray",
    "disable_dask_on_ray",
]

_DEP = "__rt_dask_dep__"


def _istask(x: Any) -> bool:
    return isinstance(x, tuple) and bool(x) and callable(x[0])


def _find_deps(comp: Any, dsk_keys, out: Set[Hashable]) -> None:
    """Collect graph keys referenced anywhere inside a computation.

    Mirrors ``dask.core.get_dependencies``: inside a task tuple, any value
    that *is* a key of the graph is a reference to it; lists/dicts recurse.
    """
    if _istask(comp):
        for arg in comp[1:]:
            _find_deps(arg, dsk_keys, out)
        return
    try:
        if comp in dsk_keys:
            out.add(comp)
            return
    except TypeError:
        pass  # unhashable literal (list/dict) — recurse below
    if isinstance(comp, list):
        for item in comp:
            _find_deps(item, dsk_keys, out)
    elif isinstance(comp, dict):
        for item in comp.values():
            _find_deps(item, dsk_keys, out)


def _rewrite(comp: Any, dep_index: Dict[Hashable, int]) -> Any:
    """Replace key references with positional markers resolved in-task."""
    if _istask(comp):
        return (comp[0],) + tuple(_rewrite(a, dep_index) for a in comp[1:])
    try:
        if comp in dep_index:
            return (_DEP, dep_index[comp])
    except TypeError:
        pass
    if isinstance(comp, list):
        return [_rewrite(item, dep_index) for item in comp]
    if isinstance(comp, dict):
        return {k: _rewrite(v, dep_index) for k, v in comp.items()}
    return comp


def _evaluate(comp: Any, deps: tuple) -> Any:
    if isinstance(comp, tuple) and len(comp) == 2 and comp[0] == _DEP:
        return deps[comp[1]]
    if _istask(comp):
        return comp[0](*[_evaluate(a, deps) for a in comp[1:]])
    if isinstance(comp, list):
        return [_evaluate(item, deps) for item in comp]
    if isinstance(comp, dict):
        return {k: _evaluate(v, deps) for k, v in comp.items()}
    return comp


def _toposort(dsk: Dict[Hashable, Any]):
    """Returns (execution order, {key: dependency set})."""
    deps: Dict[Hashable, Set[Hashable]] = {}
    keys = dsk.keys()
    for k, comp in dsk.items():
        found: Set[Hashable] = set()
        _find_deps(comp, keys, found)
        found.discard(k)
        deps[k] = found
    order: List[Hashable] = []
    state: Dict[Hashable, int] = {}  # 1 = visiting, 2 = done
    for root in dsk:
        if state.get(root) == 2:
            continue
        stack: List[tuple] = [(root, False)]
        while stack:
            k, children_done = stack.pop()
            if children_done:
                state[k] = 2
                order.append(k)
                continue
            if state.get(k) == 2:
                continue
            if state.get(k) == 1:
                raise ValueError(f"cycle in dask graph through key {k!r}")
            state[k] = 1
            stack.append((k, True))
            for d in sorted(deps[k], key=repr, reverse=True):
                if state.get(d) != 2:
                    stack.append((d, False))
    return order, deps


def _unpack(keys: Any, values: Dict[Hashable, Any]) -> Any:
    """Match dask's get contract: nested key lists map to nested results."""
    if isinstance(keys, list):
        return [_unpack(k, values) for k in keys]
    return values[keys]


_NODE_TASK = None


def _node_task():
    """The shared graph-node remote function, created once per process
    (re-registering it per scheduler call wastes export overhead)."""
    global _NODE_TASK
    if _NODE_TASK is None:

        @ray_tpu_torch.remote
        def _dask_node(spec, *dep_vals):
            return _evaluate(spec, dep_vals)

        _NODE_TASK = _dask_node
    return _NODE_TASK


def ray_dask_get(dsk: Dict[Hashable, Any], keys: Any, *, ray_persist: bool = False, **_: Any) -> Any:
    """Dask scheduler: one submitted task per graph node.

    Dependencies flow as object refs, so independent branches execute
    concurrently on the fabric and data stays in the object store between
    nodes.  ``keys`` may be a single key or arbitrarily nested lists of
    keys (dask collections pass nested lists); ``ray_persist=True`` returns
    refs instead of materialized values (parity: scheduler.py's persist
    path).
    """
    node = _node_task()
    refs: Dict[Hashable, Any] = {}
    order, deps = _toposort(dsk)
    for k in order:
        ordered = sorted(deps[k], key=repr)
        dep_index = {d: i for i, d in enumerate(ordered)}
        spec = _rewrite(dsk[k], dep_index)
        refs[k] = node.remote(spec, *[refs[d] for d in ordered])
    if ray_persist:
        return _unpack(keys, refs)
    flat: List[Hashable] = []

    def _flatten(ks):
        if isinstance(ks, list):
            for x in ks:
                _flatten(x)
        else:
            flat.append(ks)

    _flatten(keys)
    values = dict(zip(flat, ray_tpu_torch.get([refs[k] for k in flat])))
    return _unpack(keys, values)


def ray_dask_get_sync(dsk: Dict[Hashable, Any], keys: Any, **_: Any) -> Any:
    """Serial in-process variant (parity: scheduler.py ray_dask_get_sync) —
    the debugging scheduler: no tasks submitted, plain topological eval."""
    values: Dict[Hashable, Any] = {}
    order, deps = _toposort(dsk)
    for k in order:
        ordered = sorted(deps[k], key=repr)
        dep_index = {d: i for i, d in enumerate(ordered)}
        spec = _rewrite(dsk[k], dep_index)
        values[k] = _evaluate(spec, tuple(values[d] for d in ordered))
    return _unpack(keys, values)


def enable_dask_on_ray() -> None:
    """Make ray_dask_get dask's default scheduler (needs dask installed)."""
    try:
        import dask
    except ImportError as exc:
        raise ImportError(
            "enable_dask_on_ray() needs dask installed (`pip install dask`). "
            "ray_dask_get/ray_dask_get_sync work on raw graphs without it."
        ) from exc
    dask.config.set(scheduler=ray_dask_get)


def disable_dask_on_ray() -> None:
    try:
        import dask
    except ImportError as exc:
        raise ImportError("dask is not installed") from exc
    dask.config.set(scheduler=None)
