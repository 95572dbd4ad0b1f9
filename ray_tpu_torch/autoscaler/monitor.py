"""Monitor: the background loop that drives the autoscaler.

Rebuild of ``python/ray/autoscaler/_private/monitor.py`` — on the reference
this is a standalone head-node process polling GCS for load; here it is a
daemon thread over the in-process fabric with the same cadence semantics.
"""

from __future__ import annotations

import threading

from ray_tpu_torch.autoscaler.autoscaler import AutoscalerConfig, StandardAutoscaler
from ray_tpu_torch.autoscaler.node_provider import InProcessNodeProvider, NodeProvider


class Monitor:
    def __init__(
        self,
        cluster,
        config: AutoscalerConfig,
        provider: NodeProvider | None = None,
    ):
        self._cluster = cluster
        self.provider = provider or InProcessNodeProvider(cluster)
        self.autoscaler = StandardAutoscaler(cluster, self.provider, config)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # expose the live autoscaler on the fabric (GET /api/autoscaler,
        # `rt nodes` read its summary through the dashboard)
        cluster.autoscaler_monitor = self

    def start(self) -> "Monitor":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._run, name="rt-autoscaler", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        interval = self.autoscaler.config.update_interval_s
        while not self._stop.wait(interval):
            try:
                self.autoscaler.update()
            except Exception:  # keep the loop alive like the reference monitor
                import logging

                logging.getLogger(__name__).exception("autoscaler update failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
