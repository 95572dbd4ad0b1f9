"""Cluster launcher: ``rt up <cluster.yaml>`` / ``rt down``.

Role parity with the reference's cluster lifecycle commands
(``python/ray/scripts/scripts.py:1279`` ``ray up`` / :1355 ``ray down``
driving ``python/ray/autoscaler/_private/`` providers + SSH command
runners): a YAML file declares the head and worker node types; ``up``
starts the head in THIS process (control plane + transport), provisions
``min_workers`` of each type through the configured provider, and runs the
autoscaler monitor so demand-driven scale-up/down continues; ``down``
terminates every provider-managed node.

YAML schema (subset of the reference's, same concepts)::

    cluster_name: demo
    provider:
      type: local            # local (subprocess agents) | ssh
      hosts: [10.0.0.2, ...] # ssh only
      ssh_user: ubuntu       # ssh only
      ssh_key: ~/.ssh/id     # ssh only
    head:
      num_cpus: 8
      port: 6380             # transport port (0 = auto)
    available_node_types:
      cpu_worker:
        resources: {CPU: 8}
        min_workers: 2
        max_workers: 10
    max_workers: 16
    idle_timeout_s: 120
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, Optional

from ray_tpu_torch.autoscaler.autoscaler import AutoscalerConfig
from ray_tpu_torch.autoscaler.demand import NodeTypeConfig
from ray_tpu_torch.autoscaler.monitor import Monitor
from ray_tpu_torch.autoscaler.node_provider import (
    NodeProvider,
    SSHNodeProvider,
    SubprocessNodeProvider,
)


def load_cluster_config(path: str) -> Dict[str, Any]:
    """Read a cluster config: YAML, or JSON (a YAML document too) where
    PyYAML is not installed."""
    with open(path) as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        cfg = json.loads(text) if text.strip() else {}
    else:
        cfg = yaml.safe_load(text) or {}
    if "available_node_types" not in cfg:
        raise ValueError(f"{path}: missing 'available_node_types'")
    return cfg


def _node_types(cfg: Dict[str, Any]) -> Dict[str, NodeTypeConfig]:
    out = {}
    for name, spec in cfg["available_node_types"].items():
        out[name] = NodeTypeConfig(
            name=name,
            resources={k: float(v) for k, v in (spec.get("resources") or {}).items()},
            min_workers=int(spec.get("min_workers", 0)),
            max_workers=int(spec.get("max_workers", 2**31 - 1)),
            labels=dict(spec.get("labels") or {}),
        )
    return out


def make_provider(cfg: Dict[str, Any], head_address: str, cluster=None) -> NodeProvider:
    provider_cfg = cfg.get("provider") or {"type": "local"}
    kind = provider_cfg.get("type", "local")
    if kind == "local":
        return SubprocessNodeProvider(head_address)
    if kind == "ssh":
        return SSHNodeProvider(
            head_address,
            provider_cfg.get("hosts") or [],
            ssh_user=provider_cfg.get("ssh_user", ""),
            ssh_key=provider_cfg.get("ssh_key", ""),
            remote_python=provider_cfg.get("remote_python", "python3"),
            remote_dir=provider_cfg.get("remote_dir", "~"),
        )
    if kind == "gcp-tpu":
        # Cloud TPU-VM slices as gang-provisioned nodes (reference:
        # autoscaler/_private/gcp/node_provider.py + accelerators/tpu.py)
        from ray_tpu_torch.autoscaler.gcp import (
            FakeGcloudTpuAPI,
            GcpTpuNodeProvider,
            live_slice_hosts_fn,
        )

        if not provider_cfg.get("fake") and not provider_cfg.get("project"):
            raise ValueError("gcp-tpu provider requires 'project' in the provider config")
        if not provider_cfg.get("zone"):
            raise ValueError("gcp-tpu provider requires 'zone' in the provider config")
        return GcpTpuNodeProvider(
            head_address,
            # fake: true = exercise the full lifecycle against the in-tree
            # fake API (slice hosts become real local agent processes)
            api=FakeGcloudTpuAPI() if provider_cfg.get("fake") else None,
            zone=provider_cfg.get("zone", ""),
            project=provider_cfg.get("project", ""),
            runtime_version=provider_cfg.get("runtime_version", "tpu-ubuntu2204-base"),
            name_prefix=provider_cfg.get("name_prefix", cfg.get("cluster_name", "rt")),
            remote_python=provider_cfg.get("remote_python", "python3"),
            gang_join_timeout_s=float(provider_cfg.get("gang_join_timeout_s", 600.0)),
            live_slice_hosts=live_slice_hosts_fn(cluster) if cluster is not None else None,
        )
    raise ValueError(f"unknown provider type {kind!r} (supported: local, ssh, gcp-tpu)")


class ClusterLauncher:
    """Owns one launched cluster: head runtime + provider + monitor."""

    def __init__(self, config: Dict[str, Any]):
        self.config = config
        self.provider: Optional[NodeProvider] = None
        self.monitor: Optional[Monitor] = None
        self.address: Optional[str] = None

    def up(self, *, wait_for_min_workers: bool = True, timeout_s: float = 120.0):
        """Start the head service in this process (initializing the runtime
        from ``head``'s ``num_cpus`` and ``num_tpus`` if it is not up; the
        head's GPUs are the CUDA devices ``init`` detects), provision
        ``min_workers`` of each node type through the provider, start the
        monitor, and by default wait until the provisioned agents have
        joined."""
        import ray_tpu_torch as rt

        head = self.config.get("head") or {}
        if not rt.is_initialized():
            rt.init(num_cpus=head.get("num_cpus"), num_tpus=head.get("num_tpus"))
        cluster = rt.get_cluster()
        self.address = cluster.start_head_service(
            host="0.0.0.0", port=int(head.get("port", 0))
        )
        self.provider = make_provider(self.config, self.address, cluster=cluster)
        node_types = _node_types(self.config)
        as_config = AutoscalerConfig(
            node_types=node_types,
            max_workers=int(self.config.get("max_workers", 64)),
            idle_timeout_s=float(self.config.get("idle_timeout_s", 60.0)),
        )
        # provision min_workers up front (ray up initial bring-up), then the
        # monitor owns elasticity
        min_total = 0
        for nt in node_types.values():
            if nt.min_workers > 0:
                self.provider.create_nodes(nt, nt.min_workers)
                min_total += nt.min_workers
        self.monitor = Monitor(cluster, as_config, provider=self.provider).start()
        if wait_for_min_workers and min_total:
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline:
                live = sum(1 for n in cluster.nodes.values() if not n.dead) - 1
                if live >= min_total:
                    break
                time.sleep(0.25)
            else:
                raise TimeoutError(
                    f"cluster bring-up: {min_total} workers requested, "
                    f"{live} joined within {timeout_s}s"
                )
        return self

    def down(self) -> None:
        if self.monitor is not None:
            self.monitor.stop()
            self.monitor = None
        if self.provider is not None:
            for pid in list(self.provider.non_terminated_nodes()):
                self.provider.terminate_node(pid)
            self.provider = None


def up(config_path: str, **kw) -> ClusterLauncher:
    return ClusterLauncher(load_cluster_config(config_path)).up(**kw)
