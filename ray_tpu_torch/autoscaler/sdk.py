"""Programmatic autoscaler commands (parity: ``ray.autoscaler.sdk``).

``request_resources`` is the reference's one widely-used entry point
(``python/ray/autoscaler/sdk/sdk.py:request_resources`` →
``_private/commands.py``): ask the cluster to scale to hold the given
bundles immediately, without waiting for tasks to queue. Replace semantics —
the newest call wins; ``request_resources()`` with no arguments clears the
floor and lets idle scale-down resume.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def request_resources(
    num_cpus: Optional[int] = None,
    bundles: Optional[List[Dict[str, float]]] = None,
) -> None:
    """Command the cluster to a capacity floor.

    ``num_cpus=N`` requests N single-CPU bundles (many small tasks);
    ``bundles=[{...}, ...]`` requests exact resource shapes (gangs). Both
    may be given; the floors add. Call with neither to clear.
    """
    from ray_tpu_torch.api import get_cluster

    shapes: List[Dict[str, float]] = []
    if num_cpus:
        shapes.extend({"CPU": 1.0} for _ in range(num_cpus))
    if bundles:
        shapes.extend(dict(b) for b in bundles)
    get_cluster().request_resources(shapes)
