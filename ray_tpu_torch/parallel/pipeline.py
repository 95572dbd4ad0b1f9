"""Pipeline parallelism: the GPipe microbatch schedule, SPMD.

Counterpart of ``ray_tpu/parallel/pipeline.py``: stage parameters are
sharded over the ``pp`` axis (each rank holds one stage), and activations
ride a ``ppermute`` hop to the next stage every tick. M microbatches over S
stages take M + S - 1 ticks; stage s idles for its first s ticks (the GPipe
bubble). A stage computes only on the ticks that carry one of its
microbatches (the reference computes on the bubble's zeros as well, whose
results no output reads).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ray_tpu_torch.parallel import collective
from ray_tpu_torch.parallel.mesh import Mesh


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` on every tensor leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def pipeline_apply(stage_fn: Callable, stage_params, microbatches: torch.Tensor,
                   axis_name: str = "pp", *, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Every rank of the axis (of ``mesh``, or of the current mesh) calls
    it, holding one stage's params.

    stage_fn(params, x) -> y with y.shape == x.shape (the inter-stage width
    must match for the ring transport). microbatches: [M, ...], the same on
    every stage. Returns [M, ...] outputs on every stage: produced on the
    last stage and summed over the axis. The output is replicated, so its
    cotangent is the one loss's on every rank (the ``shard_map`` output with
    ``P()`` of the reference)."""
    n = collective.axis_size(axis_name, mesh=mesh)
    stage = collective.axis_index(axis_name, mesh=mesh)
    M = microbatches.shape[0]
    right = [(i, (i + 1) % n) for i in range(n)]
    # every tick's hop hangs on the one before it on every stage (idle ticks
    # pass what they hold on; stage 0 ties its unused receive in), so the
    # hops' backwards run in the same order on every rank
    recv = torch.zeros_like(microbatches[0]).requires_grad_(torch.is_grad_enabled())
    outputs = []
    for t in range(M + n - 1):
        mb = t - stage  # the microbatch at this stage on tick t
        if 0 <= mb < M:
            x = collective.tie(microbatches[mb], recv) if stage == 0 else recv
            y = stage_fn(stage_params, x)
            if stage == n - 1:
                outputs.append(y)
        else:
            y = recv
        recv = collective.ppermute(y, axis_name, right, mesh=mesh)
    out = torch.stack(outputs) if outputs else torch.zeros_like(microbatches)
    return collective.replicated_sum(collective.tie(out, recv), axis_name, mesh=mesh)


def pipeline_sharded(stage_fn: Callable, stacked_params, microbatches: torch.Tensor,
                     mesh: Mesh, axis_name: str = "pp") -> torch.Tensor:
    """A pipeline on a mesh. stacked_params: a pytree whose leaves have a
    leading stage dimension of size ``mesh.shape[axis_name]``: leaf i goes
    to stage i. microbatches: [M, ...], the same on every rank."""
    stage = collective.axis_index(axis_name, mesh=mesh)
    params = tree_map(lambda p: p[stage], stacked_params)
    return pipeline_apply(stage_fn, params, microbatches, axis_name, mesh=mesh)
