"""Checker framework: one parse + one AST walk per file, checkers as plugins.

Model
-----
:func:`run_lint` parses every target file ONCE (stdlib ``ast``, no
third-party dependency), then drives a single recursive walk per tree.
Checkers are :class:`CheckPlugin` instances that declare the node types they
care about (``interests``); the walker dispatches ``enter(node)`` /
``leave(node)`` to interested plugins only, so adding a checker costs one
dict lookup per matching node, not a full extra traversal.  Per-file facts
feed cross-file checks through the shared :class:`Project`, and
``finalize()`` runs once after every file is walked (that is where the
protocol/metric/knob parity checks — inherently whole-tree properties —
emit their violations).

Suppressions
------------
Two inline annotations, parsed from comments (they never change runtime
behavior):

``# rt-lint: disable=<check>[,<check>...]``
    Suppress the named checks (or ``all``).  On a ``def``/``class``/``with``
    line the suppression covers that whole block; on a simple statement it
    covers just that statement; on its own line it covers the next
    statement.  Every use should carry a ``-- <justification>`` suffix.

``# rt-lint: guarded-by(<lock>[,<lock>...])``
    Assert the named lock attribute(s) are held throughout the annotated
    scope (same scope rules).  The lock-discipline checker treats accesses
    there as locked — use it on helpers that document "caller must hold
    ``self._lock``".

Both anchor to real AST statement spans, so an annotation on a method
header covers exactly that method body and nothing else.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: Package roots the full-tree gate lints (relative to the repo root).
DEFAULT_ROOTS = ("ray_tpu_torch",)

_ANNOT_RE = re.compile(r"#\s*rt-lint:\s*(.*)")
_DISABLE_RE = re.compile(r"disable=([\w\-,]+)")
_GUARDED_RE = re.compile(r"guarded-by\(([\w.,\s]+)\)")

#: Statement types whose annotation scope is the whole block.
_SIMPLE_STMTS = (
    ast.Assign, ast.AugAssign, ast.AnnAssign, ast.Expr, ast.Return,
    ast.Raise, ast.Assert, ast.Delete, ast.Pass, ast.Import,
    ast.ImportFrom, ast.Global, ast.Nonlocal,
)


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding: ``file:line: [check_id] message``."""

    file: str
    line: int
    check_id: str
    message: str

    def render(self) -> str:
        return f"{self.file}:{self.line}: [{self.check_id}] {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class _Annotations:
    """Resolved suppression / guard ranges for one file."""

    def __init__(self) -> None:
        # check_id (or "all") -> list of (start_line, end_line) inclusive
        self.disabled: Dict[str, List[Tuple[int, int]]] = {}
        # list of (start_line, end_line, frozenset of asserted lock names)
        self.guards: List[Tuple[int, int, frozenset]] = []

    def is_disabled(self, check_id: str, line: int) -> bool:
        for key in (check_id, "all"):
            for start, end in self.disabled.get(key, ()):
                if start <= line <= end:
                    return True
        return False

    def guards_at(self, line: int) -> frozenset:
        held: set = set()
        for start, end, locks in self.guards:
            if start <= line <= end:
                held.update(locks)
        return frozenset(held)


def _stmt_index(tree: ast.AST) -> List[ast.stmt]:
    return [n for n in ast.walk(tree) if isinstance(n, ast.stmt)]


def _scope_for_line(stmts: List[ast.stmt], line: int) -> Tuple[int, int]:
    """The statement span an annotation on ``line`` covers (see module doc)."""
    exact = [s for s in stmts if s.lineno == line]
    if exact:
        # innermost statement starting on this line: smallest span wins
        s = min(exact, key=lambda n: (n.end_lineno or n.lineno) - n.lineno)
        return s.lineno, s.end_lineno or s.lineno
    # comment inside a multi-line simple statement: cover that statement
    containing = [
        s for s in stmts
        if isinstance(s, _SIMPLE_STMTS) and s.lineno <= line <= (s.end_lineno or s.lineno)
    ]
    if containing:
        s = min(containing, key=lambda n: (n.end_lineno or n.lineno) - n.lineno)
        return s.lineno, s.end_lineno or s.lineno
    # standalone comment line: annotate the next statement (skipping any
    # blank/comment lines between — multi-line justification comments are
    # the normal form)
    following = [s for s in stmts if s.lineno > line]
    if following:
        first = min(s.lineno for s in following)
        at_first = [s for s in following if s.lineno == first]
        s = min(at_first, key=lambda n: (n.end_lineno or n.lineno) - n.lineno)
        return s.lineno, s.end_lineno or s.lineno
    return line, line


def parse_annotations(source: str, tree: ast.AST) -> _Annotations:
    ann = _Annotations()
    stmts: Optional[List[ast.stmt]] = None
    for lineno, text in enumerate(source.splitlines(), start=1):
        m = _ANNOT_RE.search(text)
        if m is None:
            continue
        body = m.group(1)
        if stmts is None:
            stmts = _stmt_index(tree)
        span = _scope_for_line(stmts, lineno)
        dm = _DISABLE_RE.search(body)
        if dm is not None:
            for check in dm.group(1).split(","):
                check = check.strip()
                if check:
                    ann.disabled.setdefault(check, []).append(span)
        gm = _GUARDED_RE.search(body)
        if gm is not None:
            locks = frozenset(
                tok.strip() for tok in gm.group(1).split(",") if tok.strip()
            )
            if locks:
                ann.guards.append((span[0], span[1], locks))
    return ann


class FileContext:
    """Everything a plugin may need about the file being walked."""

    __slots__ = ("path", "relpath", "source", "tree", "annotations")

    def __init__(self, path: str, relpath: str, source: str, tree: ast.AST):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.tree = tree
        self.annotations = parse_annotations(source, tree)


class Project:
    """Cross-file fact store shared by all plugins for one lint run."""

    def __init__(self, repo_root: str, full_tree: bool):
        self.repo_root = repo_root
        #: True when the run covers every DEFAULT_ROOTS file — whole-tree
        #: parity checks (protocol/metric/knob) only fire then, so linting
        #: a single file never false-positives on "handler not found".
        self.full_tree = full_tree
        self.violations: List[Violation] = []
        self.files: List[FileContext] = []
        #: free-form per-checker fact buckets, keyed by check id
        self.facts: Dict[str, dict] = {}
        #: docs override for tests ({relative name -> text}); None = read
        #: docs/*.md + README.md from repo_root on demand
        self.docs_override: Optional[Dict[str, str]] = None
        #: protocol-manifest override for tests; None = the checked-in file
        self.manifest_override: Optional[dict] = None

    def docs_text(self) -> str:
        if self.docs_override is not None:
            return "\n".join(self.docs_override.values())
        chunks: List[str] = []
        for name in sorted(os.listdir(os.path.join(self.repo_root, "docs"))) if os.path.isdir(os.path.join(self.repo_root, "docs")) else []:
            if name.endswith(".md"):
                try:
                    with open(os.path.join(self.repo_root, "docs", name)) as f:
                        chunks.append(f.read())
                except OSError:
                    pass
        readme = os.path.join(self.repo_root, "README.md")
        if os.path.exists(readme):
            try:
                with open(readme) as f:
                    chunks.append(f.read())
            except OSError:
                pass
        return "\n".join(chunks)


class CheckPlugin:
    """Base class for checkers.  Subclasses set ``check_id`` and
    ``interests`` (the ast node types they want ``enter``/``leave`` for)
    and implement any subset of the hooks."""

    check_id: str = "?"
    interests: Tuple[type, ...] = ()

    def begin_file(self, ctx: FileContext, project: Project) -> None:  # noqa: D401
        pass

    def enter(self, node: ast.AST, ctx: FileContext, project: Project) -> None:
        pass

    def leave(self, node: ast.AST, ctx: FileContext, project: Project) -> None:
        pass

    def end_file(self, ctx: FileContext, project: Project) -> None:
        pass

    def finalize(self, project: Project) -> None:
        pass

    # ------------------------------------------------------------------
    def report(self, project: Project, relpath: str, line: int, message: str) -> None:
        project.violations.append(Violation(relpath, line, self.check_id, message))


def _walk(tree: ast.AST, plugins: Sequence[CheckPlugin], ctx: FileContext, project: Project) -> None:
    dispatch: Dict[type, List[CheckPlugin]] = {}
    for p in plugins:
        for t in p.interests:
            dispatch.setdefault(t, []).append(p)

    def rec(node: ast.AST) -> None:
        interested = dispatch.get(type(node))
        if interested:
            for p in interested:
                p.enter(node, ctx, project)
        for child in ast.iter_child_nodes(node):
            rec(child)
        if interested:
            for p in interested:
                p.leave(node, ctx, project)

    rec(tree)


def _iter_py_files(roots: Iterable[str], repo_root: str) -> List[str]:
    out: List[str] = []
    for root in roots:
        abs_root = root if os.path.isabs(root) else os.path.join(repo_root, root)
        if os.path.isfile(abs_root):
            if abs_root.endswith(".py"):
                out.append(abs_root)
            continue
        for dirpath, dirnames, filenames in os.walk(abs_root):
            dirnames[:] = [d for d in dirnames if d not in ("__pycache__",)]
            for name in sorted(filenames):
                if name.endswith(".py"):
                    out.append(os.path.join(dirpath, name))
    return sorted(set(out))


def repo_root_dir() -> str:
    """The repository root (parent of the ``ray_tpu_torch`` package dir)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def all_checkers() -> List[CheckPlugin]:
    """Fresh instances of every registered checker (plugins keep per-run
    state, so a new set is built per lint run)."""
    from ray_tpu_torch.analysis.determinism import DeterminismChecker
    from ray_tpu_torch.analysis.knob_hygiene import KnobHygieneChecker
    from ray_tpu_torch.analysis.lock_discipline import LockDisciplineChecker
    from ray_tpu_torch.analysis.metric_parity import MetricParityChecker
    from ray_tpu_torch.analysis.protocol_parity import ProtocolParityChecker
    from ray_tpu_torch.analysis.span_manifest import SpanManifestChecker

    return [
        LockDisciplineChecker(),
        ProtocolParityChecker(),
        MetricParityChecker(),
        DeterminismChecker(),
        KnobHygieneChecker(),
        SpanManifestChecker(),
    ]


def run_lint(
    paths: Optional[Sequence[str]] = None,
    checks: Optional[Sequence[str]] = None,
    repo_root: Optional[str] = None,
    files: Optional[Sequence[Tuple[str, str]]] = None,
    docs_override: Optional[Dict[str, str]] = None,
    manifest_override: Optional[dict] = None,
    full_tree: Optional[bool] = None,
) -> List[Violation]:
    """Run the linter and return suppression-filtered violations.

    ``paths``: files/dirs (absolute, or relative to the repo root); default
    the full DEFAULT_ROOTS tree.  ``checks``: restrict to these check ids.
    ``files``: in-memory ``(relpath, source)`` pairs for tests — bypasses
    the filesystem entirely.  ``docs_override`` / ``manifest_override``
    substitute the docs corpus and protocol manifest (tests again).
    ``full_tree`` forces the whole-tree-parity mode on or off (tests treat
    an injected fixture set as a complete tree); None = inferred.
    """
    repo_root = repo_root or repo_root_dir()
    plugins = all_checkers()
    if checks:
        unknown = set(checks) - {p.check_id for p in plugins}
        if unknown:
            raise ValueError(f"unknown check id(s): {sorted(unknown)}")
        plugins = [p for p in plugins if p.check_id in checks]

    forced_full_tree = full_tree
    if files is not None:
        sources: List[Tuple[str, str, str]] = [(rel, rel, src) for rel, src in files]
        full_tree = False
    else:
        target_files = _iter_py_files(paths or DEFAULT_ROOTS, repo_root)
        default_files = (
            target_files if paths is None
            else _iter_py_files(DEFAULT_ROOTS, repo_root)
        )
        full_tree = set(default_files) <= set(target_files)
        sources = []
        for path in target_files:
            rel = os.path.relpath(path, repo_root)
            try:
                with open(path, encoding="utf-8") as f:
                    sources.append((path, rel, f.read()))
            except OSError:
                continue

    if forced_full_tree is not None:
        full_tree = forced_full_tree
    project = Project(repo_root, full_tree=full_tree)
    project.docs_override = docs_override
    project.manifest_override = manifest_override

    for path, rel, source in sources:
        try:
            tree = ast.parse(source, filename=rel)
        except SyntaxError as exc:
            project.violations.append(
                Violation(rel, exc.lineno or 1, "parse-error", f"syntax error: {exc.msg}")
            )
            continue
        ctx = FileContext(path, rel, source, tree)
        project.files.append(ctx)
        for p in plugins:
            p.begin_file(ctx, project)
        _walk(tree, plugins, ctx, project)
        for p in plugins:
            p.end_file(ctx, project)

    for p in plugins:
        p.finalize(project)

    ann_by_file = {ctx.relpath: ctx.annotations for ctx in project.files}
    out: List[Violation] = []
    for v in project.violations:
        ann = ann_by_file.get(v.file)
        if ann is not None and ann.is_disabled(v.check_id, v.line):
            continue
        out.append(v)
    out.sort(key=lambda v: (v.file, v.line, v.check_id))
    return out


def render_json(violations: Sequence[Violation]) -> str:
    return json.dumps([v.to_dict() for v in violations], indent=2)
