"""``chaos-determinism`` — keep the deterministic fabric deterministic.

The chaos layer's entire value proposition is that the SAME seed produces
the SAME fault schedule and a byte-identical fault log (``failpoints.fp``
decisions are pure blake2b of (seed, name, hit-index)).  One stray
``time.time()`` or ``random.random()`` on a decision path silently turns a
reproducible chaos run into an unreproducible one — and those regressions
do not fail any test, they just make the next flake un-rerunnable.

Two manifests, matched by path:

* STRICT (``runtime/failpoints.py`` and everything under ``chaos/``):
  wall-clock AND randomness sources are forbidden —
  ``time.time``/``time_ns``, ``random.*``, ``os.urandom``,
  ``uuid.uuid1``/``uuid4`` — and iterating a ``set`` (or ``set(...)``)
  directly in a ``for``/comprehension or into an f-string is flagged
  unless wrapped in ``sorted(...)``: set order is hash-seed-dependent and
  leaks into logs.
* FRAME (``runtime/data_plane.py``, ``runtime/device_plane.py``): the
  data-plane frame paths — randomness sources only.  Wall-clock is
  legitimate there (deadlines, backpressure timing) and stays allowed.

Observability side-paths that genuinely need wall-clock timestamps or a
random trace id carry a ``# rt-lint: disable=chaos-determinism`` with the
justification that they never feed a chaos decision.  Import aliasing is
resolved (``import time as t``, ``from os import urandom``); calls through
stored references are not — keep the fabric simple enough to audit.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Optional, Tuple

from ray_tpu_torch.analysis.framework import CheckPlugin, FileContext, Project

#: module -> forbidden attrs ("*" = every attribute; random has no
#: deterministic members worth allowing on these paths).
_FORBIDDEN: Dict[str, frozenset] = {
    "time": frozenset({"time", "time_ns"}),
    "random": frozenset({"*"}),
    "os": frozenset({"urandom", "getrandom"}),
    "uuid": frozenset({"uuid1", "uuid4"}),
    "secrets": frozenset({"*"}),
}

_STRICT_PATHS = ("ray_tpu_torch/runtime/failpoints.py",)
_STRICT_DIRS = ("ray_tpu_torch/chaos/",)
_FRAME_PATHS = (
    "ray_tpu_torch/runtime/data_plane.py",
    "ray_tpu_torch/runtime/device_plane.py",
)
#: on FRAME paths only randomness is forbidden, not wall-clock
_FRAME_ALLOWED_MODULES = frozenset({"time"})


def _manifest_mode(relpath: str) -> Optional[str]:
    rel = relpath.replace(os.sep, "/")
    if rel in _STRICT_PATHS or any(rel.startswith(d) for d in _STRICT_DIRS):
        return "strict"
    if rel in _FRAME_PATHS:
        return "frame"
    return None


class DeterminismChecker(CheckPlugin):
    check_id = "chaos-determinism"
    interests = (
        ast.Import,
        ast.ImportFrom,
        ast.Call,
        ast.For,
        ast.comprehension,
        ast.FormattedValue,
    )

    def begin_file(self, ctx: FileContext, project: Project) -> None:
        self._mode = _manifest_mode(ctx.relpath)
        #: local name -> module it aliases (``import time as t`` -> t: time)
        self._mod_alias: Dict[str, str] = {}
        #: local name -> (module, attr) (``from os import urandom``)
        self._from_alias: Dict[str, Tuple[str, str]] = {}

    # -- helpers -------------------------------------------------------
    def _forbidden_reason(self, module: str, attr: str) -> Optional[str]:
        attrs = _FORBIDDEN.get(module)
        if attrs is None:
            return None
        if self._mode == "frame" and module in _FRAME_ALLOWED_MODULES:
            return None
        if "*" in attrs or attr in attrs:
            return f"{module}.{attr}"
        return None

    def _call_target(self, func: ast.AST) -> Optional[Tuple[str, str]]:
        if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
            module = self._mod_alias.get(func.value.id)
            if module is not None:
                return module, func.attr
        elif isinstance(func, ast.Name):
            target = self._from_alias.get(func.id)
            if target is not None:
                return target
        return None

    def _is_raw_set(self, node: ast.AST) -> bool:
        """A set literal or bare ``set(...)`` call — iteration order is
        hash-seed-dependent.  ``sorted(...)`` wrappers make it fine and are
        naturally not matched here."""
        if isinstance(node, ast.Set):
            return True
        return (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id in ("set", "frozenset")
        )

    def _flag(self, project: Project, ctx: FileContext, line: int, what: str) -> None:
        scope = (
            "the deterministic chaos fabric"
            if self._mode == "strict"
            else "a data-plane frame path"
        )
        self.report(
            project,
            ctx.relpath,
            line,
            f"{what} on {scope}: same-seed runs must replay byte-identically "
            f"(fp decisions are pure hashes of seed/name/hit); route through "
            f"the seeded schedule, or annotate "
            f"`# rt-lint: disable={self.check_id}` with why this never feeds "
            f"a chaos decision or the fault log",
        )

    # -- walk hooks ----------------------------------------------------
    def enter(self, node: ast.AST, ctx: FileContext, project: Project) -> None:
        if isinstance(node, ast.Import):
            for alias in node.names:
                self._mod_alias[alias.asname or alias.name] = alias.name
            return
        if isinstance(node, ast.ImportFrom):
            if node.module:
                for alias in node.names:
                    self._from_alias[alias.asname or alias.name] = (
                        node.module,
                        alias.name,
                    )
            return
        if self._mode is None:
            return
        if isinstance(node, ast.Call):
            target = self._call_target(node.func)
            if target is not None:
                reason = self._forbidden_reason(*target)
                if reason is not None:
                    self._flag(
                        project, ctx, node.lineno, f"nondeterministic call {reason}()"
                    )
            return
        if self._mode != "strict":
            return
        # unsorted-set iteration leaking hash order into behavior/logs
        if isinstance(node, ast.For) and self._is_raw_set(node.iter):
            self._flag(
                project,
                ctx,
                node.lineno,
                "iterating an unsorted set (hash-seed-dependent order)",
            )
        elif isinstance(node, ast.comprehension) and self._is_raw_set(node.iter):
            self._flag(
                project,
                ctx,
                node.iter.lineno,
                "iterating an unsorted set (hash-seed-dependent order)",
            )
        elif isinstance(node, ast.FormattedValue) and self._is_raw_set(node.value):
            self._flag(
                project,
                ctx,
                getattr(node.value, "lineno", node.lineno),
                "formatting an unsorted set into output "
                "(hash-seed-dependent rendering)",
            )
