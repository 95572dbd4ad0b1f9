"""``knob-hygiene`` — every ``core/config.py`` knob is real and documented.

Two ways a Config field rots:

* **dead knob** — the field exists (and its ``RAY_TPU_<NAME>`` env override
  is parsed) but nothing outside ``config.py`` ever reads it.  Operators
  set it and nothing changes — worse than no knob.
* **undocumented knob** — the field is live but appears in no docs knob
  table, so the only way to discover it is reading ``config.py``.

A read is any attribute *load* of the field's name outside ``config.py``
(``cfg.scheduler_max_retries``, ``get_config().heartbeat_interval_s`` —
the access idiom everywhere in the tree).  Matching is by attribute name:
a same-named attribute on an unrelated object also counts, which is the
deliberately-cheap trade-off — false negatives over false positives, and
knob names are long enough (``router_queue_wait_timeout_s``) that
collisions are rare.  Documentation is a backticked ```field_name```
anywhere in ``docs/*.md`` or ``README.md`` (the knob tables use that
form).  Violations anchor at the field's definition line in ``config.py``.
Whole-tree runs only.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Set, Tuple

from ray_tpu_torch.analysis.framework import CheckPlugin, FileContext, Project

_CONFIG_SUFFIX = "core/config.py"


class KnobHygieneChecker(CheckPlugin):
    check_id = "knob-hygiene"
    interests = (ast.ClassDef, ast.Attribute)

    def __init__(self) -> None:
        #: field name -> (relpath, line) of the AnnAssign in Config
        self.fields: Dict[str, Tuple[str, int]] = {}
        #: attribute names loaded anywhere outside config.py
        self.reads: Set[str] = set()

    def _is_config_file(self, ctx: FileContext) -> bool:
        return ctx.relpath.replace(os.sep, "/").endswith(_CONFIG_SUFFIX)

    def enter(self, node: ast.AST, ctx: FileContext, project: Project) -> None:
        if isinstance(node, ast.ClassDef):
            if node.name == "Config" and self._is_config_file(ctx):
                for stmt in node.body:
                    if isinstance(stmt, ast.AnnAssign) and isinstance(
                        stmt.target, ast.Name
                    ):
                        self.fields[stmt.target.id] = (ctx.relpath, stmt.lineno)
            return
        # attribute loads anywhere else count as knob reads
        if isinstance(node.ctx, ast.Load) and not self._is_config_file(ctx):
            self.reads.add(node.attr)

    def finalize(self, project: Project) -> None:
        if not project.full_tree or not self.fields:
            return
        docs = project.docs_text()
        for field, (relpath, line) in sorted(self.fields.items()):
            if field not in self.reads:
                self.report(
                    project,
                    relpath,
                    line,
                    f"Config.{field} is never read outside config.py — a dead "
                    f"knob (its RAY_TPU_{field.upper()} override parses but "
                    f"changes nothing); wire it up or delete it",
                )
            if not re.search(rf"`{re.escape(field)}`", docs):
                self.report(
                    project,
                    relpath,
                    line,
                    f"Config.{field} is missing from the docs knob tables "
                    f"(no `{field}` in docs/*.md or README.md) — operators "
                    f"cannot discover it; add a row to the knob table in "
                    f"docs/config.md",
                )
