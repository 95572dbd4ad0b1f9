"""Dashboard: REST state/metrics API + job submission endpoints.

The port's copy of ``ray_tpu/dashboard/`` (the same ``__all__``): the head
(``head.py``), its page (``ui.py``) and the stores the runtime keeps for it
(``reporter.py``: per-node utilization samples and worker log tails).

Parity with the reference's ``dashboard/`` head process (``head.py:81
DashboardHead``) and its module system (state, jobs, metrics, events):
a threaded stdlib HTTP server exposing the same JSON surfaces, backed
directly by the in-process control service (no aggregator hop), plus the
Prometheus ``/metrics`` endpoint the per-node metrics agent serves in the
reference (``python/ray/_private/metrics_agent.py``).
"""

from ray_tpu_torch.dashboard.head import DashboardHead

__all__ = ["DashboardHead"]
