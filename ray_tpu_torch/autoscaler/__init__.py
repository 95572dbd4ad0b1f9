"""Autoscaler: demand-driven cluster scaling.

TPU-native rebuild of the reference autoscaler
(``python/ray/autoscaler/_private/autoscaler.py:172`` StandardAutoscaler,
``resource_demand_scheduler.py`` bin-packing, ``monitor.py`` head-node loop,
``python/ray/autoscaler/node_provider.py`` provider plugins, and the v2
declarative rewrite under ``python/ray/autoscaler/v2/``).

Differences by design: node types are TPU-slice-aware (a "node type" can be a
whole slice, added or removed atomically so an ICI mesh is never fractured),
and providers materialize in-process nodes against the live ``Cluster``
fabric (the FakeMultiNodeProvider strategy,
``python/ray/autoscaler/_private/fake_multi_node/node_provider.py:237``,
promoted to the primary test path).

The port's copy of ``ray_tpu/autoscaler``: the same names, demand packing,
TPU slice catalog and semantics (the JAX package's custom resources).
``InProcessNodeProvider`` adds nodes through the port's ``Cluster.add_node``;
a node type with ``"GPU"`` resources is a node whose ``num_gpus`` work runs
on the card, in this process.  The providers whose nodes are node agents
(``SubprocessNodeProvider``, ``SSHNodeProvider``, the ``kubectl`` and
``gcloud`` backends, ``FakeGcloudTpuAPI(spawn=True)``) start the port's
agent (``python -m ray_tpu_torch.runtime.agent``), with a node type's
``"GPU"`` as its ``--num-gpus`` (``node_provider.split_gpus``; the JAX
package passes it in ``--resources``); the launcher's ``up`` provisions
them.
"""

from ray_tpu_torch.autoscaler.autoscaler import AutoscalerConfig, StandardAutoscaler
from ray_tpu_torch.autoscaler.demand import NodeTypeConfig, get_nodes_to_launch
from ray_tpu_torch.autoscaler import sdk
from ray_tpu_torch.autoscaler.monitor import Monitor
from ray_tpu_torch.autoscaler.kuberay import KubernetesNodeProvider
from ray_tpu_torch.autoscaler.node_provider import (
    InProcessNodeProvider,
    NodeProvider,
    TPU_SLICE_TOPOLOGIES,
    TPUSliceProvider,
)

__all__ = [
    "AutoscalerConfig",
    "StandardAutoscaler",
    "NodeTypeConfig",
    "get_nodes_to_launch",
    "Monitor",
    "NodeProvider",
    "InProcessNodeProvider",
    "KubernetesNodeProvider",
    "TPUSliceProvider",
    "TPU_SLICE_TOPOLOGIES",
    "sdk",
]
from ray_tpu_torch.autoscaler.v2 import (
    AutoscalerV2,
    AutoscalerV2Config,
    Instance,
    InstanceManager,
)

__all__ += ["AutoscalerV2", "AutoscalerV2Config", "Instance", "InstanceManager"]
