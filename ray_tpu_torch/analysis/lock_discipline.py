"""``lock-discipline`` — the race detector.

Contract: an attribute of a class that owns a ``threading.Lock`` /
``RLock`` / ``Condition`` and is ever WRITTEN inside ``with self.<lock>:``
(outside ``__init__``) is *guarded state*; every other read or write of it
in the class must also hold one of the locks it is written under.  This is
the mechanical form of the discipline clang's ``GUARDED_BY`` /
``-Wthread-safety`` enforces, inferred instead of declared: the locked
writes themselves declare the guarded set, so the checker catches exactly
the defect class review keeps finding by hand (the router ``_inflight``
re-keying, the demand-queue check-then-act overshoot — both were guarded
fields touched on an unlocked path).

What counts as holding the lock:

* being syntactically inside ``with self.<lock>:`` (or a ``Condition``
  constructed OVER that lock — ``self._cv = threading.Condition(self._lock)``
  makes ``with self._cv:`` hold ``_lock`` too; the checker resolves the
  alias),
* being inside a scope annotated ``# rt-lint: guarded-by(<lock>)`` — the
  assertion for helpers whose CALLERS hold the lock,
* being inside a method named ``*_locked`` — the repo-wide naming
  convention for exactly that caller-holds-the-lock contract (the suffix
  IS the annotation; the checker honors it for all of the class's locks).

Deliberate exemptions:

* ``__init__`` bodies — construction happens-before publication,
* accesses of the lock attributes themselves and of method names,
* classes that own no lock.

Anything else unlocked is a finding: fix it, or annotate it with a
justification (e.g. a monotonic-counter read that tolerates staleness).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.analysis.framework import CheckPlugin, FileContext, Project

#: threading constructors that make an attribute a lock (Semaphore/Event
#: deliberately excluded: they are signalling primitives, not mutual
#: exclusion — writes under ``with self._sem`` are not a guard claim).
_LOCK_CTORS = {"Lock", "RLock", "Condition"}


def _call_ctor_name(node: ast.AST) -> Optional[Tuple[str, Optional[str]]]:
    """``threading.Condition(self._lock)`` -> ("Condition", "_lock");
    ``threading.Lock()`` -> ("Lock", None); otherwise None.  Accepts both
    ``threading.X(...)`` and a bare ``X(...)`` imported name."""
    if not isinstance(node, ast.Call):
        return None
    func = node.func
    name = None
    if isinstance(func, ast.Attribute):
        name = func.attr
    elif isinstance(func, ast.Name):
        name = func.id
    if name not in _LOCK_CTORS:
        return None
    wrapped = None
    if node.args:
        arg = node.args[0]
        if (
            isinstance(arg, ast.Attribute)
            and isinstance(arg.value, ast.Name)
            and arg.value.id == "self"
        ):
            wrapped = arg.attr
    return name, wrapped


def _walk_own(node: ast.AST):
    """ast.walk pruned at nested ClassDefs: yields the class's OWN subtree
    so a nested class's locks/methods don't leak into the outer state."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, ast.ClassDef):
            continue
        stack.extend(ast.iter_child_nodes(n))


class _ClassState:
    __slots__ = ("name", "lock_alias", "methods", "accesses")

    def __init__(self, node: ast.ClassDef):
        self.name = node.name
        #: lock attr -> root lock name (a Condition over a lock maps to
        #: the underlying lock; standalone locks map to themselves)
        self.lock_alias: Dict[str, str] = {}
        #: method names (``self.foo()`` loads of these are calls, not state)
        self.methods: Set[str] = set()
        #: (attr, line, is_store, frozenset(held lock names), method_name)
        self.accesses: List[Tuple[str, int, bool, frozenset, str]] = []
        # prescan the class body: lock attributes may be assigned in any
        # method (not just __init__), and a ``with self._lock`` that the
        # walk reaches FIRST must still recognize them
        for n in _walk_own(node):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods.add(n.name)
            if not isinstance(n, (ast.Assign, ast.AnnAssign)):
                continue
            value = n.value
            if value is None:
                continue
            ctor = _call_ctor_name(value)
            if ctor is None:
                continue
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            for t in targets:
                if (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    _kind, wrapped = ctor
                    root = wrapped if wrapped is not None else t.attr
                    self.lock_alias[t.attr] = root
                    self.lock_alias.setdefault(root, root)
        # only direct class-body function defs count as methods too (the
        # prescan above already added them; nested helpers inside methods
        # are locals, not attributes, and never appear as self.<name>)


class LockDisciplineChecker(CheckPlugin):
    check_id = "lock-discipline"
    interests = (
        ast.ClassDef,
        ast.FunctionDef,
        ast.AsyncFunctionDef,
        ast.Lambda,
        ast.With,
        ast.AsyncWith,
        ast.Attribute,
    )

    def begin_file(self, ctx: FileContext, project: Project) -> None:
        self._classes: List[_ClassState] = []
        #: (function name, class depth at definition)
        self._func_stack: List[Tuple[str, int]] = []
        #: lock names held per enclosing With, innermost last
        self._with_stack: List[frozenset] = []

    # -- helpers -------------------------------------------------------
    def _cur_class(self) -> Optional[_ClassState]:
        return self._classes[-1] if self._classes else None

    def _cur_method(self) -> Optional[str]:
        """Innermost DIRECT method of the current class (nested defs and
        lambdas inherit it — their accesses belong to that method for the
        ``__init__`` exemption)."""
        depth = len(self._classes)
        for name, class_depth in reversed(self._func_stack):
            if class_depth == depth:
                return name
        return None

    # -- walk hooks ----------------------------------------------------
    def enter(self, node: ast.AST, ctx: FileContext, project: Project) -> None:
        if isinstance(node, ast.ClassDef):
            self._classes.append(_ClassState(node))
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._func_stack.append((node.name, len(self._classes)))
            return
        if isinstance(node, ast.Lambda):
            self._func_stack.append(("<lambda>", len(self._classes)))
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            cls = self._cur_class()
            locks: Set[str] = set()
            if cls is not None:
                for item in node.items:
                    expr = item.context_expr
                    if (
                        isinstance(expr, ast.Attribute)
                        and isinstance(expr.value, ast.Name)
                        and expr.value.id == "self"
                        and expr.attr in cls.lock_alias
                    ):
                        locks.add(expr.attr)
            self._with_stack.append(frozenset(locks))
            return
        if isinstance(node, ast.Attribute):
            cls = self._cur_class()
            if cls is None:
                return
            if not (isinstance(node.value, ast.Name) and node.value.id == "self"):
                return
            method = self._cur_method()
            if method is None:
                return  # class-body expression, not method code
            is_store = isinstance(node.ctx, (ast.Store, ast.Del))
            held: Set[str] = set()
            for frame in self._with_stack:
                held.update(frame)
            cls.accesses.append(
                (node.attr, node.lineno, is_store, frozenset(held), method)
            )

    def leave(self, node: ast.AST, ctx: FileContext, project: Project) -> None:
        if isinstance(node, ast.ClassDef):
            self._judge(self._classes.pop(), ctx, project)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            self._func_stack.pop()
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            self._with_stack.pop()

    # -- judgement -----------------------------------------------------
    def _judge(self, cls: _ClassState, ctx: FileContext, project: Project) -> None:
        if not cls.lock_alias:
            return
        ann = ctx.annotations
        all_roots = frozenset(cls.lock_alias.values())

        def effective_held(held_names: frozenset, line: int, method: str) -> frozenset:
            names = held_names | ann.guards_at(line)
            roots = {cls.lock_alias.get(n, n) for n in names}
            if method.endswith("_locked"):
                # repo convention: a *_locked method's caller holds the lock
                roots.update(all_roots)
            return frozenset(roots)

        guarded: Dict[str, Set[str]] = {}
        for attr, line, is_store, held, method in cls.accesses:
            if not is_store or method == "__init__":
                continue
            if attr in cls.lock_alias or attr in cls.methods:
                continue
            # a locked store carrying `# rt-lint: disable=lock-discipline`
            # is declared a benign PUBLICATION (atomic rebind read racily
            # by design) — it makes no guard claim for the attribute
            if ann.is_disabled(self.check_id, line):
                continue
            locks = effective_held(held, line, method)
            if locks:
                guarded.setdefault(attr, set()).update(locks)
        if not guarded:
            return

        for attr, line, is_store, held, method in cls.accesses:
            if method == "__init__":
                continue
            if attr in cls.lock_alias or attr in cls.methods:
                continue
            want = guarded.get(attr)
            if not want:
                continue
            locks = effective_held(held, line, method)
            if locks & want:
                continue
            verb = "written" if is_store else "read"
            lock_names = sorted(want)
            self.report(
                project,
                ctx.relpath,
                line,
                f"{cls.name}.{attr} is guarded by {'/'.join(lock_names)} "
                f"(written under it elsewhere) but {verb} here without holding it; "
                f"take the lock, or annotate with "
                f"`# rt-lint: guarded-by({lock_names[0]})` / `disable={self.check_id}` "
                f"with a justification",
            )
