"""DAG API: lazy task graphs compiled to fast repeat-execution programs.

The port's copy of ``ray_tpu/dag/``.  Reference parity: ``python/ray/dag/``
(``dag_node.py``, ``input_node.py``, ``compiled_dag_node.py:278``):
``f.bind()`` builds the graph lazily, ``experimental_compile`` pre-resolves
everything so repeated executions skip the per-call scheduling path (a DAG
of tensor functions runs as one inline walk in the caller's thread), and
``compile_plan`` installs a DAG of actor-method stages once, with channels
for its edges (``dag/plan.py``).
"""

from ray_tpu_torch.dag.dag_node import (
    ClassMethodNode,
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
)
from ray_tpu_torch.dag.compiled import CompiledDAG
from ray_tpu_torch.dag.channel import Channel, ChannelClosed, DeviceChannel


def __getattr__(name):
    # Lazy: plan.py pulls in runtime.channel_manager, which imports
    # dag.channel (and thus this package __init__) — an eager import here
    # would be circular when channel_manager loads first (agent processes).
    if name in ("ExecutionPlan", "StageGroup", "StageGroupNode"):
        from ray_tpu_torch.dag import plan

        return getattr(plan, name)
    raise AttributeError(name)


__all__ = [
    "DAGNode",
    "FunctionNode",
    "ClassMethodNode",
    "InputNode",
    "InputAttributeNode",
    "MultiOutputNode",
    "CompiledDAG",
    "ExecutionPlan",
    "StageGroup",
    "StageGroupNode",
    "Channel",
    "ChannelClosed",
    "DeviceChannel",
]
