"""``metric-parity`` — the metric registry and its call sites stay honest.

Three properties, matching how ``observability/metric_defs.py`` is laid out
(module-level ``NAME = _reg.counter("family", ...)`` constants plus an
``ALL_METRICS`` list literal that the dashboard and ``/metrics`` endpoint
iterate):

1. every metric constructed in ``metric_defs.py`` is a member of
   ``ALL_METRICS`` — a constant left out silently vanishes from scrapes;
2. every *literal-named* construction OUTSIDE ``metric_defs.py`` (the
   dashboard's ``counter("tasks_terminal_total")`` re-get idiom) names a
   family that ``metric_defs.py`` actually defines — a typo there creates
   a ghost family that never aggregates with the real one;
3. every call site of a metric constant (``X.inc/.set/.observe`` where
   ``X`` is an UPPER_CASE name) uses a consistent ``tags={...}`` label
   keyset — mixed keysets split one logical series into un-joinable
   shards.  The most common keyset is taken as canonical; deviating sites
   are flagged.

User-facing wrappers (``util/metrics.py``) pass names as variables and are
invisible to the literal matching by design — they are a different layer
with runtime validation.  Cross-file judgements only fire on whole-tree
runs.
"""

from __future__ import annotations

import ast
import os
import re
from collections import Counter
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.analysis.framework import CheckPlugin, FileContext, Project

_CTOR_METHODS = {"counter", "gauge", "histogram"}
_USE_METHODS = {"inc", "set", "observe"}
_CONST_RE = re.compile(r"^[A-Z][A-Z0-9_]*$")
_DEFS_SUFFIX = "observability/metric_defs.py"


def _receiver_const(func: ast.Attribute) -> Optional[str]:
    """``TASKS_SUBMITTED.inc`` / ``metric_defs.TASKS_SUBMITTED.inc`` ->
    "TASKS_SUBMITTED" when the receiver is an UPPER_CASE constant."""
    recv = func.value
    name = None
    if isinstance(recv, ast.Name):
        name = recv.id
    elif isinstance(recv, ast.Attribute):
        name = recv.attr
    if name is not None and _CONST_RE.match(name):
        return name
    return None


class MetricParityChecker(CheckPlugin):
    check_id = "metric-parity"
    interests = (ast.Assign, ast.Call)

    def __init__(self) -> None:
        #: constant name -> (family, relpath, line) from metric_defs.py
        self.defined: Dict[str, Tuple[str, str, int]] = {}
        self.families: Set[str] = set()
        self.all_metrics_members: Optional[Set[str]] = None
        self._all_metrics_site: Optional[Tuple[str, int]] = None
        #: literal constructions outside metric_defs: (family, relpath, line)
        self.foreign_ctors: List[Tuple[str, str, int]] = []
        #: constant -> list of (keyset, relpath, line)
        self.call_tags: Dict[str, List[Tuple[frozenset, str, int]]] = {}
        self._saw_defs = False

    # -- collection ----------------------------------------------------
    def _is_defs_file(self, ctx: FileContext) -> bool:
        return ctx.relpath.replace(os.sep, "/").endswith(_DEFS_SUFFIX)

    def _ctor_family(self, node: ast.Call) -> Optional[str]:
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _CTOR_METHODS
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            return node.args[0].value
        return None

    def enter(self, node: ast.AST, ctx: FileContext, project: Project) -> None:
        in_defs = self._is_defs_file(ctx)
        if isinstance(node, ast.Assign):
            if in_defs:
                self._saw_defs = True
                family = (
                    self._ctor_family(node.value)
                    if isinstance(node.value, ast.Call)
                    else None
                )
                for t in node.targets:
                    if not isinstance(t, ast.Name):
                        continue
                    if family is not None and _CONST_RE.match(t.id):
                        self.defined[t.id] = (family, ctx.relpath, node.lineno)
                        self.families.add(family)
                    if t.id == "ALL_METRICS" and isinstance(
                        node.value, (ast.List, ast.Tuple)
                    ):
                        self.all_metrics_members = {
                            e.id for e in node.value.elts if isinstance(e, ast.Name)
                        }
                        self._all_metrics_site = (ctx.relpath, node.lineno)
            return
        # Calls: constructions and metric uses
        family = self._ctor_family(node)
        if family is not None and not in_defs:
            self.foreign_ctors.append((family, ctx.relpath, node.lineno))
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _USE_METHODS
        ):
            const = _receiver_const(node.func)
            if const is None:
                return
            keyset: Optional[frozenset] = frozenset()
            for kw in node.keywords:
                if kw.arg == "tags":
                    if isinstance(kw.value, ast.Dict) and all(
                        isinstance(k, ast.Constant) and isinstance(k.value, str)
                        for k in kw.value.keys
                    ):
                        keyset = frozenset(k.value for k in kw.value.keys)
                    else:
                        keyset = None  # dynamic tags: unknowable, skip site
            if keyset is not None:
                self.call_tags.setdefault(const, []).append(
                    (keyset, ctx.relpath, node.lineno)
                )

    # -- judgement -----------------------------------------------------
    def finalize(self, project: Project) -> None:
        if not project.full_tree or not self._saw_defs:
            return
        # 1. every defined constant is listed in ALL_METRICS
        if self.all_metrics_members is None:
            site = next(iter(self.defined.values()), ("", 1))[1:]
            self.report(
                project,
                site[0] or _DEFS_SUFFIX,
                site[1] if len(site) > 1 else 1,
                "metric_defs.py has metric definitions but no ALL_METRICS "
                "list literal — the /metrics endpoint iterates it",
            )
        else:
            for const, (family, relpath, line) in sorted(self.defined.items()):
                if const not in self.all_metrics_members:
                    self.report(
                        project,
                        relpath,
                        line,
                        f"metric {const} ({family!r}) is constructed here but "
                        f"missing from ALL_METRICS — it will never be exported "
                        f"by the /metrics endpoint or the dashboard",
                    )
        # 2. literal re-gets elsewhere must name a defined family
        for family, relpath, line in self.foreign_ctors:
            if family not in self.families:
                self.report(
                    project,
                    relpath,
                    line,
                    f"metric family {family!r} is constructed here but not "
                    f"defined in metric_defs.py — a typo creates a ghost "
                    f"series that never joins the real one; define it in "
                    f"metric_defs.py (and ALL_METRICS) or fix the name",
                )
        # 3. consistent tag keysets per metric constant
        for const, sites in sorted(self.call_tags.items()):
            if const not in self.defined:
                continue  # UPPER name that is not a known metric constant
            counts = Counter(keyset for keyset, _, _ in sites)
            if len(counts) <= 1:
                continue
            canonical, _n = max(
                counts.items(), key=lambda kv: (kv[1], sorted(kv[0]))
            )
            for keyset, relpath, line in sites:
                if keyset == canonical:
                    continue
                self.report(
                    project,
                    relpath,
                    line,
                    f"{const} is recorded here with label keys "
                    f"{sorted(keyset) or '[]'} but its majority call sites use "
                    f"{sorted(canonical) or '[]'} — mixed label sets split one "
                    f"logical series into un-joinable shards",
                )
