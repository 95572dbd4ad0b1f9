"""The port's in-process multi-node cluster against the JAX package's: the
cases of ``tests/test_cluster.py`` (scheduling across nodes, object
transfer, node death and reconstruction, placement groups, the conda gate,
the control-state snapshot).

Each case runs the JAX test's own body once as written and once ported
(``tests/torch_multinode.py``) on a fresh runtime of its package, shaped as
the JAX fixture makes it.  ``test_util_placement_group_api`` is held in
``tests/test_torch_util.py``.
"""

import pytest
from torch_multinode import PACKAGES, run_case

torch = pytest.importorskip("torch")

import test_cluster as jax_cluster  # noqa: E402

CASES = sorted(n for n in vars(jax_cluster) if n.startswith("test_")
               and n != "test_util_placement_group_api")


def test_the_cases_are_the_jax_files():
    assert len(CASES) == 15


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("pkg", PACKAGES)
def test_cluster_case(case, pkg, request):
    run_case("test_cluster", case, pkg, request)
