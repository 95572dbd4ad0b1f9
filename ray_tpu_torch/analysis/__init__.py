"""``rt lint`` — AST-based invariant linter for the runtime's own contracts.

Ten PRs of review hardening kept finding the same defect classes by hand:
shared fields mutated outside their lock, frames sent with no receiving
handler, metrics instantiated but missing from ``ALL_METRICS``, and
nondeterminism leaking into chaos-deterministic paths.  The reference
codebase leans on clang-tidy/TSan for exactly this; a pure-Python runtime
needs its own pass — each convention is encoded as a checker ONCE and every
future PR gets it enforced in tier-1 instead of in a fifth review round.

The port's copy of ``ray_tpu/analysis``: the same checkers and annotations
over the port's tree (``DEFAULT_ROOTS = ("ray_tpu_torch",)``), with its own
protocol manifest, generated from the port's ``runtime/`` frame kinds (the
one-node port sends 11 of them and has no ``rpc.PROTOCOL_VERSION`` yet: the
multi-host transport is ROADMAP item 10).

Six checkers (see :mod:`ray_tpu_torch.analysis.framework` for the plugin model
and ``docs/static_analysis.md`` for the catalog):

``lock-discipline``     attributes written under a class's lock must never
                        be touched outside one (race detector).
``protocol-parity``     every literally-sent control/data frame kind has a
                        receiving handler, and the frame-kind set is hashed
                        into a checked-in manifest tied to
                        ``rpc.PROTOCOL_VERSION``.
``metric-parity``       every metric family lives in
                        ``metric_defs.ALL_METRICS`` with consistent label
                        sets at every call site.
``chaos-determinism``   modules on the deterministic manifest may not call
                        wall-clock/randomness sources or iterate unsorted
                        sets into output.
``knob-hygiene``        every ``core/config.py`` knob is read somewhere and
                        documented in a docs knob table.
``span-manifest``       every ``prefix::``-shaped span name uses a pinned
                        tracing namespace (``task::``/``serve::``/``llm::``
                        …); a new namespace is a deliberate manifest edit.

Suppressions (inline, narrowest-scope-wins):

    x = self._hits          # rt-lint: disable=lock-discipline -- <why>
    def snapshot(self):     # rt-lint: guarded-by(_lock) -- caller holds it

Stdlib-``ast`` only, one parse per file, < ~5 s over the full tree — the
tier-1 gate (``tests/test_lint.py``) pins the repo at zero violations and
asserts the speed bound.
"""

from ray_tpu_torch.analysis.framework import (  # noqa: F401
    DEFAULT_ROOTS,
    Violation,
    all_checkers,
    run_lint,
)
