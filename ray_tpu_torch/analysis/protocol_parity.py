"""``protocol-parity`` — every sent frame kind has a receiving handler, and
the frame-kind set is pinned to ``rpc.PROTOCOL_VERSION`` via a manifest.

Senders collected (string literals only — dynamic kinds are invisible to a
static pass and ride the handlers' own KeyError diagnostics):

* ``conn.send("kind", ...)`` / ``conn.request("kind", ...)`` /
  ``conn.request_async("kind", ...)`` — control-plane frames,
* ``rpc.request_with_budget(conn, "kind", ...)`` — the deadline-aware form,
* ``{"op": "kind", ...}`` dict literals and ``op="kind"`` keywords — the
  data-plane header idiom (``data_plane._send_header``) and the client
  proxy ops.

Receivers collected:

* string keys of handler-registry dict literals whose values are
  ``self._h_<kind>`` attributes or inline lambdas (the
  ``HeadService``/``agent`` idiom),
* ``handlers["kind"] = ...`` subscript installs,
* ``msg_type == "kind"`` / ``op == "kind"`` equality branches (the
  worker-IPC and data-plane server dispatch idiom).

A kind sent with no receiver anywhere in the tree is a violation at the
send site.  Kinds handled but never literally sent are NOT flagged (they
may be sent with computed kinds, e.g. re-routing).

The manifest (``ray_tpu_torch/analysis/protocol_manifest.json``) freezes the
sorted frame-kind set with a digest and the ``rpc.PROTOCOL_VERSION`` it was
generated under.  Changing the kind set without regenerating the manifest
fails lint; regenerating (``rt lint --update-protocol-manifest``) REFUSES
unless ``PROTOCOL_VERSION`` was bumped — so "add a frame, forget the
version bump" can no longer merge.  Whole-tree runs only: linting a subset
of files skips these checks (they are global properties).
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.analysis.framework import CheckPlugin, FileContext, Project

MANIFEST_RELPATH = os.path.join("ray_tpu_torch", "analysis", "protocol_manifest.json")

#: Kinds internal to the transport itself, never in the parity set.
_INTERNAL_KINDS = {"__reply__"}

_SEND_METHODS = {"send", "request", "request_async"}
#: Dispatch variable names whose == "literal" comparisons mark a receiver —
#: but only inside the wire-dispatch surfaces below.  ``op``/``kind``
#: comparisons in data/ (dataset op tables) and providers are not frame
#: handlers and must not pollute the handled set.
_DISPATCH_NAMES = {"msg_type", "op"}
_DISPATCH_SURFACES = ("ray_tpu_torch/runtime/", "ray_tpu_torch/util/client/")


def kind_digest(kinds: List[str]) -> str:
    return hashlib.blake2b(
        json.dumps(sorted(kinds)).encode(), digest_size=16
    ).hexdigest()


def load_manifest(repo_root: str) -> Optional[dict]:
    path = os.path.join(repo_root, MANIFEST_RELPATH)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def check_manifest(
    manifest: Optional[dict], kinds: List[str], protocol_version: Optional[int]
) -> List[str]:
    """Pure manifest validation (unit-testable without a tree scan):
    returns human-readable problem strings, empty when consistent."""
    problems: List[str] = []
    kinds = sorted(set(kinds) - _INTERNAL_KINDS)
    if manifest is None:
        problems.append(
            f"protocol manifest {MANIFEST_RELPATH} is missing or unreadable; "
            f"regenerate with `rt lint --update-protocol-manifest`"
        )
        return problems
    recorded = sorted(manifest.get("kinds", []))
    if recorded != kinds or manifest.get("digest") != kind_digest(kinds):
        added = sorted(set(kinds) - set(recorded))
        removed = sorted(set(recorded) - set(kinds))
        detail = []
        if added:
            detail.append(f"added {added}")
        if removed:
            detail.append(f"removed {removed}")
        problems.append(
            "frame-kind set changed vs the checked-in manifest "
            f"({'; '.join(detail) or 'digest mismatch'}); bump rpc.PROTOCOL_VERSION "
            "and regenerate with `rt lint --update-protocol-manifest`"
        )
    if (
        protocol_version is not None
        and manifest.get("protocol_version") != protocol_version
    ):
        problems.append(
            f"manifest was generated under PROTOCOL_VERSION "
            f"{manifest.get('protocol_version')} but rpc.PROTOCOL_VERSION is "
            f"{protocol_version}; regenerate with `rt lint --update-protocol-manifest`"
        )
    return problems


def update_manifest(repo_root: str) -> Tuple[bool, str]:
    """Regenerate the manifest from a fresh whole-tree scan.  Refuses when
    the kind set changed but PROTOCOL_VERSION did not — the bump workflow
    this checker exists to enforce.  Returns (ok, message)."""
    kinds, version = scan_kinds(repo_root)
    old = load_manifest(repo_root)
    if old is not None:
        old_kinds = sorted(old.get("kinds", []))
        if old_kinds != kinds and old.get("protocol_version") == version:
            return (
                False,
                f"refusing to update {MANIFEST_RELPATH}: the frame-kind set "
                f"changed but rpc.PROTOCOL_VERSION is still {version} — bump it "
                f"first (every kind add/remove is a wire-protocol change)",
            )
    manifest = {
        "protocol_version": version,
        "kinds": kinds,
        "digest": kind_digest(kinds),
    }
    path = os.path.join(repo_root, MANIFEST_RELPATH)
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
        f.write("\n")
    return True, f"wrote {MANIFEST_RELPATH} ({len(kinds)} kinds, v{version})"


def scan_kinds(repo_root: str) -> Tuple[List[str], Optional[int]]:
    """Whole-tree (sent ∪ handled) frame kinds + the PROTOCOL_VERSION
    literal, via a dedicated pass (used by the manifest updater)."""
    from ray_tpu_torch.analysis.framework import DEFAULT_ROOTS, _iter_py_files

    checker = ProtocolParityChecker()
    project = Project(repo_root, full_tree=True)
    for path in _iter_py_files(DEFAULT_ROOTS, repo_root):
        rel = os.path.relpath(path, repo_root)
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
            tree = ast.parse(source, filename=rel)
        except (OSError, SyntaxError):
            continue
        ctx = FileContext(path, rel, source, tree)
        checker.begin_file(ctx, project)
        for node in ast.walk(tree):
            if isinstance(node, checker.interests):
                checker.enter(node, ctx, project)
    # the manifest pins the SENT vocabulary: that is the wire surface a
    # version bump must cover (handled-only kinds include reply paths and
    # computed sends and would make the manifest jittery)
    kinds = sorted(checker.sent_kinds - _INTERNAL_KINDS)
    return kinds, checker.protocol_version


class ProtocolParityChecker(CheckPlugin):
    check_id = "protocol-parity"
    interests = (ast.Call, ast.Dict, ast.Compare, ast.Assign)

    def __init__(self) -> None:
        #: kind -> list of (relpath, line) send sites
        self.send_sites: Dict[str, List[Tuple[str, int]]] = {}
        self.sent_kinds: Set[str] = set()
        self.handled_kinds: Set[str] = set()
        self.protocol_version: Optional[int] = None
        self._version_site: Optional[Tuple[str, int]] = None

    # -- collection ----------------------------------------------------
    def _record_send(self, kind: str, ctx: FileContext, line: int) -> None:
        if kind in _INTERNAL_KINDS:
            return
        self.sent_kinds.add(kind)
        self.send_sites.setdefault(kind, []).append((ctx.relpath, line))

    def enter(self, node: ast.AST, ctx: FileContext, project: Project) -> None:
        if isinstance(node, ast.Call):
            func = node.func
            # conn.send("kind", ...) / conn.request("kind", ...)
            if (
                isinstance(func, ast.Attribute)
                and func.attr in _SEND_METHODS
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                self._record_send(node.args[0].value, ctx, node.lineno)
            # request_with_budget(conn, "kind", ...)
            name = func.attr if isinstance(func, ast.Attribute) else (
                func.id if isinstance(func, ast.Name) else None
            )
            if (
                name == "request_with_budget"
                and len(node.args) >= 2
                and isinstance(node.args[1], ast.Constant)
                and isinstance(node.args[1].value, str)
            ):
                self._record_send(node.args[1].value, ctx, node.lineno)
            # op="kind" keyword (client proxy idiom)
            for kw in node.keywords:
                if (
                    kw.arg == "op"
                    and isinstance(kw.value, ast.Constant)
                    and isinstance(kw.value.value, str)
                ):
                    self._record_send(kw.value.value, ctx, node.lineno)
            return
        if isinstance(node, ast.Dict):
            handler_values = 0
            literal_keys: List[str] = []
            for key, value in zip(node.keys, node.values):
                if not (isinstance(key, ast.Constant) and isinstance(key.value, str)):
                    continue
                # {"op": "kind", ...} data-plane header.  Real wire headers
                # always carry payload fields beside "op"; a single-key
                # {"op": "x"} is the metric TAG idiom, not a frame.
                if (
                    key.value == "op"
                    and len(node.keys) >= 2
                    and isinstance(value, ast.Constant)
                    and isinstance(value.value, str)
                ):
                    self._record_send(value.value, ctx, node.lineno)
                literal_keys.append(key.value)
                if isinstance(value, ast.Attribute) and value.attr.startswith("_h_"):
                    handler_values += 1
            # a handler registry: at least one value is an _h_* handler
            # (lambda-only dicts are op TABLES — dataset stages etc. — not
            # frame registries; the real registries mix _h_* and lambdas)
            if handler_values >= 1:
                self.handled_kinds.update(literal_keys)
            return
        if isinstance(node, ast.Compare):
            # msg_type == "kind" / op == "kind" dispatch branches, only on
            # the wire-dispatch surfaces
            rel = ctx.relpath.replace(os.sep, "/")
            if (
                any(rel.startswith(s) for s in _DISPATCH_SURFACES)
                and isinstance(node.left, ast.Name)
                and node.left.id in _DISPATCH_NAMES
                and len(node.ops) == 1
                and isinstance(node.ops[0], (ast.Eq, ast.In))
            ):
                comp = node.comparators[0]
                if isinstance(comp, ast.Constant) and isinstance(comp.value, str):
                    self.handled_kinds.add(comp.value)
                elif isinstance(comp, (ast.Tuple, ast.Set, ast.List)):
                    for elt in comp.elts:
                        if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                            self.handled_kinds.add(elt.value)
            return
        if isinstance(node, ast.Assign):
            # rpc.PROTOCOL_VERSION literal (only in runtime/rpc.py)
            if ctx.relpath.replace(os.sep, "/").endswith("runtime/rpc.py"):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id == "PROTOCOL_VERSION":
                        if isinstance(node.value, ast.Constant) and isinstance(
                            node.value.value, int
                        ):
                            self.protocol_version = node.value.value
                            self._version_site = (ctx.relpath, node.lineno)
            # handlers["kind"] = fn installs
            for t in node.targets:
                if (
                    isinstance(t, ast.Subscript)
                    and isinstance(t.value, ast.Name)
                    and "handler" in t.value.id
                    and isinstance(t.slice, ast.Constant)
                    and isinstance(t.slice.value, str)
                ):
                    self.handled_kinds.add(t.slice.value)

    # -- judgement -----------------------------------------------------
    def finalize(self, project: Project) -> None:
        if not project.full_tree:
            return
        for kind in sorted(self.sent_kinds - self.handled_kinds):
            for relpath, line in self.send_sites.get(kind, []):
                self.report(
                    project,
                    relpath,
                    line,
                    f"frame kind {kind!r} is sent here but no peer handler "
                    f"exists (no `_h_{kind}` registry entry, no "
                    f"`msg_type/op == \"{kind}\"` branch) — the peer will "
                    f"reply with a KeyError or drop the frame",
                )
        kinds = sorted(self.sent_kinds - _INTERNAL_KINDS)
        manifest = (
            project.manifest_override
            if project.manifest_override is not None
            else load_manifest(project.repo_root)
        )
        anchor = self._version_site or (MANIFEST_RELPATH, 1)
        for problem in check_manifest(manifest, kinds, self.protocol_version):
            self.report(project, anchor[0], anchor[1], problem)
