"""Sequence parallelism: ring attention and Ulysses all-to-all.

Counterpart of ``ray_tpu/parallel/ring.py``. Two strategies over a mesh axis
holding sequence shards, each run by every rank on its own shard:

* **Ring attention**: K/V shards rotate around the axis (one ``ppermute``
  a step) while each rank runs the flash kernel
  (:func:`ray_tpu_torch.ops.attention.flash_attention_with_lse`: the CUDA
  forward, and in training its two backward kernels through the lse
  cotangent) on its local Q against the K/V shard it holds, and merges the
  partial outputs with the running-max log-sum-exp recurrence.
* **Ulysses**: ``all_to_all`` swaps the sharding from sequence to heads,
  runs the flash kernel on whole sequences of the local heads, and swaps
  back.

The ``*_sharded`` wrappers take full tensors (every rank holds the same
ones), run the SPMD function on this rank's block and return the local
output block; :func:`ray_tpu_torch.parallel.mesh.gather_array` reads it back
whole.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ray_tpu_torch.parallel import collective
from ray_tpu_torch.parallel.mesh import Mesh, P, shard_array

NEG_INF = -1e30


def merge_partials(parts):
    """The attention over the union of the key sets of ``parts``, each an
    (out [B,H,T,D], lse [B,H,T] f32) over a disjoint key set: accumulated
    unnormalised against the running max of the lse, one divide at the end
    (the ring's merge)."""
    o_acc, m_run, w_sum = 0.0, NEG_INF, 0.0
    for o_i, lse_i in parts:
        m_new = torch.maximum(torch.as_tensor(m_run, device=lse_i.device), lse_i)
        alpha = torch.exp(m_run - m_new)
        beta = torch.exp(lse_i - m_new)
        o_acc = o_acc * alpha[..., None] + o_i.float() * beta[..., None]
        w_sum = w_sum * alpha + beta
        m_run = m_new
    w_safe = torch.where(w_sum == 0, 1.0, w_sum)
    return o_acc / w_safe[..., None]


def ring_attention(
    q, k, v, axis_name: str, *, causal: bool = True, sm_scale: Optional[float] = None,
    block_q: Optional[int] = None, block_k: Optional[int] = None, mesh: Optional[Mesh] = None,
):
    """Blockwise ring attention over sequence shards (every rank of the
    axis calls it on its shard; ``axis_name`` is an axis of ``mesh``, or of
    the current mesh without one).

    q, k, v: [B, H, T_local, D], the local sequence shard; returns
    [B, H, T_local, D] in q's dtype. At step s the rank holds the K/V shard
    of block (my - s) mod n: under a causal mask it attends to an earlier
    block fully, to its own block causally (the diagonal) and skips a later
    one, so rank r of n launches the flash kernel r + 1 times. K and V
    rotate as one buffer, one ``ppermute`` a step (n - 1 in all: the
    reference's last rotation only brings the shards home), so each step's
    backward is one communication in one chain, run on every rank in the
    same order (the last shard is tied to the output where it is unused)."""
    from ray_tpu_torch.ops.attention import flash_attention_with_lse

    n = collective.axis_size(axis_name, mesh=mesh)
    me = collective.axis_index(axis_name, mesh=mesh)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    perm = [(i, (i + 1) % n) for i in range(n)]
    kv = torch.stack([k, v])
    parts = []
    for step in range(n):
        src = (me - step) % n  # the sequence block kv holds now
        if not causal or src <= me:
            out, lse = flash_attention_with_lse(q, kv[0], kv[1], scale, causal and src == me,
                                                block_q, block_k)
            parts.append((out, lse))
        if step < n - 1:
            kv = collective.ppermute(kv, axis_name, perm, mesh=mesh)
    # the last shard is unused where the causal ring skips it: its
    # rotation's backward must still run there
    return collective.tie(merge_partials(parts), kv).to(q.dtype)


def ring_attention_sharded(
    q, k, v, mesh: Mesh, axis_name: str = "sp", *, causal: bool = True,
    sm_scale: Optional[float] = None, block_q: Optional[int] = None,
    block_k: Optional[int] = None, batch_axis: Optional[str] = None,
    head_axis: Optional[str] = None,
):
    """Ring attention on full [B, H, T, D] tensors sharded on T over
    ``axis_name`` (and B over ``batch_axis``, H over ``head_axis``): this
    rank's output block [B/dp, H/tp, T/sp, D]."""
    spec = (batch_axis, head_axis, axis_name, None)
    ql, kl, vl = (shard_array(x, mesh, *spec) for x in (q, k, v))
    return ring_attention(ql, kl, vl, axis_name, causal=causal, sm_scale=sm_scale,
                          block_q=block_q, block_k=block_k, mesh=mesh)


# --------------------------------------------------------------------------
# Ulysses-style all-to-all sequence parallelism
# --------------------------------------------------------------------------
def ulysses_attention(q, k, v, axis_name: str, *, causal: bool = True,
                      sm_scale: Optional[float] = None, mesh: Optional[Mesh] = None):
    """Head/sequence all-to-all attention (every rank of the axis of
    ``mesh``, or of the current mesh). q, k, v: [B, H, T_local, D] with H
    divisible by the axis size; swaps to [B, H_local, T, D], runs the flash
    kernel, swaps back."""
    from ray_tpu_torch.ops.attention import flash_attention

    def swap_to_heads(x):
        return collective.all_to_all(x, axis_name, split_axis=1, concat_axis=2, mesh=mesh)

    qh, kh, vh = swap_to_heads(q), swap_to_heads(k), swap_to_heads(v)
    out = flash_attention(qh, kh, vh, sm_scale, causal)
    return collective.all_to_all(out, axis_name, split_axis=2, concat_axis=1, mesh=mesh)


def ulysses_attention_sharded(q, k, v, mesh: Mesh, axis_name: str = "sp", *,
                              causal: bool = True, sm_scale=None):
    """Ulysses on full [B, H, T, D] tensors sharded on T: this rank's
    output block."""
    spec = P(None, None, axis_name, None)
    ql, kl, vl = (shard_array(x, mesh, *spec) for x in (q, k, v))
    return ulysses_attention(ql, kl, vl, axis_name, causal=causal, sm_scale=sm_scale, mesh=mesh)
