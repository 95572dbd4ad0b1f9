"""Serializability inspection (parity: python/ray/util/check_serialize.py).

The port's copy of ``ray_tpu/util/check_serialize.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.
"""

from __future__ import annotations

from typing import Any, Set, Tuple


def inspect_serializability(obj: Any, name: str = None) -> Tuple[bool, Set[str]]:
    """Returns (is_serializable, set_of_problem_descriptions)."""
    problems: Set[str] = set()
    _check(obj, name or repr(obj), problems, depth=0)
    return (not problems, problems)


def _check(obj: Any, name: str, problems: Set[str], depth: int) -> None:
    import cloudpickle

    if depth > 3:
        return
    try:
        cloudpickle.dumps(obj)
        return
    except Exception as exc:  # noqa: BLE001
        problems.add(f"{name}: {type(exc).__name__}: {exc}")
    # Drill into closures/attributes to find the offending member.
    closure = getattr(obj, "__closure__", None)
    if closure:
        names = obj.__code__.co_freevars
        for var, cell in zip(names, closure):
            try:
                cloudpickle.dumps(cell.cell_contents)
            except Exception:
                _check(cell.cell_contents, f"{name}.<closure>.{var}", problems, depth + 1)
    d = getattr(obj, "__dict__", None)
    if isinstance(d, dict):
        for k, v in list(d.items())[:20]:
            try:
                cloudpickle.dumps(v)
            except Exception:
                _check(v, f"{name}.{k}", problems, depth + 1)
