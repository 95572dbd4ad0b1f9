"""ray_tpu_torch.serve: online model serving.

The port's copy of ``ray_tpu/serve/__init__.py``: the same exports. A
controller actor reconciles deployment replicas with queue-depth
autoscaling; handles route with power-of-two-choices; an HTTP proxy (and a
gRPC one, where ``grpc`` is installed) fronts apps; ``@serve.batch`` shapes
concurrent requests into batches; ``@serve.multiplexed`` LRU-caches many
models per replica. ``LLMServer`` and ``OpenAICompatLLMServer`` deploy as
replicas; one that asks for ``ray_actor_options={"num_gpus": ...}`` is an
in-process GPU actor whose engine runs the CUDA kernels.
"""

from ray_tpu_torch.serve.api import (
    HTTPOptions,
    _run,
    delete,
    get_app_handle,
    get_deployment_handle,
    ingress,
    grpc_address,
    proxy_url,
    run,
    run_config,
    shutdown,
    start,
    status,
)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.deployment import Application, AutoscalingConfig, Deployment, deployment
from ray_tpu_torch.serve.llm import LLMEngine, LLMServer, OpenAICompatLLMServer
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed
from ray_tpu_torch.serve.replica import ReplicaContext, get_replica_context
from ray_tpu_torch.serve.router import DeploymentHandle, DeploymentResponse

__all__ = [
    "Application",
    "LLMEngine",
    "LLMServer",
    "OpenAICompatLLMServer",
    "AutoscalingConfig",
    "Deployment",
    "DeploymentHandle",
    "DeploymentResponse",
    "HTTPOptions",
    "ReplicaContext",
    "batch",
    "delete",
    "deployment",
    "get_app_handle",
    "get_deployment_handle",
    "get_replica_context",
    "ingress",
    "get_multiplexed_model_id",
    "grpc_address",
    "multiplexed",
    "proxy_url",
    "run",
    "run_config",
    "shutdown",
    "start",
    "status",
]
