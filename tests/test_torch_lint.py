"""The port's linter (``ray_tpu_torch.analysis``, ``rt lint``) against the JAX
package's.

Each checker case of ``test_lint.py`` runs here through both packages: the
JAX test's own body, once as written and once bound to the port, its
fixture paths and sources moved from ``ray_tpu/`` to ``ray_tpu_torch/``
(the checkers key their rules on the package's paths).  Both runs must
report the same violations on the same sources, the package name masked.
The port's own tree lints clean; this test asserts no time (the lint's
time on the card is measured by ``chip_smoke.py``'s ``cli`` phase).
"""

import importlib
import re

import pytest
from torch_ported import ported, rebound

torch = pytest.importorskip("torch")

import test_lint as jax_lint  # noqa: E402

PACKAGES = ("ray_tpu", "ray_tpu_torch")
#: the JAX tree's gate (its time budget is the JAX package's); the port's
#: counterpart is test_port_tree_lints_clean
NOT_A_CHECKER_CASE = {"test_repo_tree_is_clean_and_fast"}


def to_port(s: str) -> str:
    """A fixture's package paths and module names, moved to the port."""
    return re.sub(r"\bray_tpu(?=[/.])", "ray_tpu_torch", s)


def masked(s: str) -> str:
    return s.replace("ray_tpu_torch", "ray_tpu")


CASES = sorted(n for n in vars(jax_lint) if n.startswith("test_") and n not in NOT_A_CHECKER_CASE)


@pytest.mark.parametrize("case", CASES)
def test_checker_case_gives_the_same_violations(case):
    found = {}
    for name in PACKAGES:
        run_lint = importlib.import_module(name + ".analysis").run_lint
        calls = []

        def recording(*a, _run=run_lint, _calls=calls, **kw):
            out = _run(*a, **kw)
            _calls.append(sorted(masked(v.render()) for v in out))
            return out

        fn = getattr(jax_lint, case)
        if name == "ray_tpu":
            fn = rebound(fn, run_lint=recording)
        else:
            fn = ported(fn, to_port, run_lint=recording)
        fn()
        found[name] = calls
    assert found["ray_tpu_torch"] == found["ray_tpu"]


def test_port_fixture_paths_reach_the_ports_rules():
    """The moved fixtures hit the port's path rules: the determinism
    checker's strict directory is the port's chaos package."""
    from ray_tpu_torch.analysis import determinism

    assert determinism._STRICT_DIRS == ("ray_tpu_torch/chaos/",)
    src = "import random\n\ndef decide(spec):\n    return random.random()\n"
    run_lint = importlib.import_module("ray_tpu_torch.analysis").run_lint
    vs = run_lint(files=[("ray_tpu_torch/chaos/x.py", src)], checks={"chaos-determinism"},
                  full_tree=True)
    assert len(vs) == 1 and vs[0].file == "ray_tpu_torch/chaos/x.py"


def test_port_tree_lints_clean():
    from ray_tpu_torch.analysis import run_lint
    from ray_tpu_torch.analysis.framework import DEFAULT_ROOTS

    assert DEFAULT_ROOTS == ("ray_tpu_torch",)
    violations = run_lint()
    assert violations == [], "\n".join(v.render() for v in violations)


def test_port_manifest_is_its_runtimes_frame_kinds():
    from ray_tpu_torch.analysis import protocol_parity
    from ray_tpu_torch.analysis.framework import repo_root_dir

    manifest = protocol_parity.load_manifest(repo_root_dir())
    kinds, version = protocol_parity.scan_kinds(repo_root_dir())
    assert manifest["kinds"] == kinds and manifest["protocol_version"] == version
    assert manifest["digest"] == protocol_parity.kind_digest(kinds)
    assert protocol_parity.MANIFEST_RELPATH.startswith("ray_tpu_torch")
    assert all(s.startswith("ray_tpu_torch/") for s in protocol_parity._DISPATCH_SURFACES)


def test_rt_lint_cli_over_the_port(capsys):
    from ray_tpu_torch.scripts.cli import main

    assert main(["lint"]) == 0
    assert main(["lint", "--check", "no-such-check"]) == 2
    assert "unknown check" in capsys.readouterr().err
