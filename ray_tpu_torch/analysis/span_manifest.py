"""Span-name manifest: the tracing namespace vocabulary is pinned.

``rt timeline --tracing`` and the dashboard group spans by their
``<prefix>::`` namespace (``task::submit-to-finish``, ``execute::foo``,
``serve::prefill`` …), and downstream tooling keys off exactly those
prefixes.  A new namespace introduced ad hoc silently fragments the
timeline: its spans render, but nothing groups, filters, or documents
them.  This checker pins the manifest — any string literal (including an
f-string's constant head) that *looks like a span name*, i.e. starts
with ``identifier::``, must use a manifested prefix.

* Unprefixed span names (user spans like ``"preprocess"``) are always
  fine: the check only fires on the ``xyz::`` shape.
* Adding a genuine new namespace is a one-line change to
  :data:`SPAN_PREFIXES` — made deliberately, in the same PR that
  documents the namespace in ``docs/observability.md``.
"""

from __future__ import annotations

import ast
import re
from typing import Tuple

from ray_tpu_torch.analysis.framework import CheckPlugin, FileContext, Project

#: The pinned span namespaces. Grouped by subsystem; every ``::``-style
#: span name in the tree must start with one of these.
SPAN_PREFIXES = frozenset({
    # task lifecycle (cluster.py / worker_main.py / node.py)
    "task", "schedule", "execute", "put", "retry",
    # compiled plans and their channels (dag/plan.py, runtime/data_plane.py)
    "plan", "chan", "stage",
    # chaos failpoint injections (runtime/failpoints.py)
    "fault",
    # request-scope serving observability (observability/reqtrace.py)
    "serve", "llm",
})

#: A span-shaped name: a lowercase identifier immediately followed by
#: ``::`` at the very start of the string.
_SPAN_NAME_RE = re.compile(r"^([a-z_]+)::")


class SpanManifestChecker(CheckPlugin):
    """Flag ``prefix::``-shaped string literals whose prefix is not in
    the pinned manifest."""

    check_id = "span-manifest"
    # Plain literals AND f-string heads: an f-string's leading constant
    # (``f"serve::{phase}"`` -> Constant ``"serve::"``) is walked as an
    # ordinary Constant child node, so one interest covers both forms.
    interests: Tuple[type, ...] = (ast.Constant,)

    def enter(self, node: ast.AST, ctx: FileContext, project: Project) -> None:
        value = node.value  # type: ignore[attr-defined]
        if not isinstance(value, str):
            return
        m = _SPAN_NAME_RE.match(value)
        if m is None:
            return
        prefix = m.group(1)
        if prefix in SPAN_PREFIXES:
            return
        self.report(
            project, ctx.relpath, node.lineno,
            f"span namespace {prefix}:: is not in the pinned manifest "
            f"({', '.join(sorted(SPAN_PREFIXES))}); add it to "
            f"analysis/span_manifest.py SPAN_PREFIXES (and document it) "
            f"or rename the span",
        )
