"""Disaggregated prefill/decode serving: KV-block migration between engines.

The port's own copy of the engine-facing half of ``ray_tpu/serve/disagg.py``.
A ``role="prefill"`` engine runs chunked prefill into its paged KV pool and
parks the prompt's block set as a *staged migration*
(``LLMEngine.prefill_export``, which resolves to a header-only ticket from
:func:`make_ticket`); a ``role="decode"`` engine probes its own prefix cache,
pulls only the uncached blocks (:func:`pull_block`) and joins its
continuous batch from them (``LLMEngine.adopt_migration``).

Ladder per block, as the reference's: the in-process staged copy (engines
of one process: the prefill engine's registry entry in
``runtime/data_plane.py``, reported as the ``"host"`` rung, as the JAX
package reports it) → the device pull (``runtime/device_plane.py``, CUDA IPC
between processes of one host, the ``"device"`` rung).  The JAX package's
third rung, the host-staged ``kv_pull`` of its data server, needs the
runtime, which is not ported: a block no rung reaches raises
:class:`KVMigrationError` with ``stage == "staging"``.

Not ported yet: ``DisaggDispatcher`` (it needs the Serve router) and its
migration audit on the cluster.

Determinism: block uuids derive from the migration id
(:func:`migration_uuid`, bit-equal to the reference's), never at random.
"""

from __future__ import annotations

import zlib
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.config import get_config

#: the two pool roles a disaggregated deployment declares
ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"


class KVMigrationError(RuntimeError):
    """Typed failure of one KV-block migration attempt (the staged blocks
    were released or unreachable, or the decode side lost its prefix).
    ``stage`` names where it failed: ``staging``, ``pulled`` or
    ``prefill-done``."""

    def __init__(self, mig_id: str, stage: str, message: str):
        super().__init__(f"kv migration {mig_id!r} failed at {stage}: {message}")
        self.mig_id = mig_id
        self.stage = stage


def migration_uuid(mig_id: str, block_idx: int) -> int:
    """Deterministic transfer-server uuid for one staged block, derived from
    the ``(request, block)`` identity: crc32 of the tagged migration id in
    the high bits, the block index in the low 32 bits, never zero."""
    hi = zlib.crc32(f"kvmig:{mig_id}".encode()) & 0x7FFFFFFF
    return ((hi << 32) | (block_idx & 0xFFFFFFFF)) or 1


def validate_roles(roles: Optional[Dict[str, int]],
                   init_kwargs: Optional[dict] = None) -> None:
    """Deploy-time validation of a disaggregated deployment (a typed
    ValueError instead of a wedge at the first migration):

    - only the ``prefill`` / ``decode`` roles exist;
    - both pools need at least one replica;
    - a dense KV cache has no block table to migrate — roles require the
      paged cache.
    """
    if roles is None:
        return
    unknown = sorted(set(roles) - {ROLE_PREFILL, ROLE_DECODE})
    if unknown:
        raise ValueError(
            f"unknown deployment role(s) {unknown}: a disaggregated "
            f"deployment declares only {ROLE_PREFILL!r} and {ROLE_DECODE!r}"
        )
    for role in (ROLE_PREFILL, ROLE_DECODE):
        if int(roles.get(role, 0)) < 1:
            raise ValueError(
                f"roles={roles} needs at least one {role!r} replica: a "
                "disaggregated deployment admits into the prefill pool and "
                "decodes on the decode pool — an empty pool wedges every "
                "request at its first migration"
            )
    kind = (init_kwargs or {}).get("cache_kind")
    if kind is None:
        kind = get_config().llm_cache_kind
    if kind == "dense":
        raise ValueError(
            "roles= requires the paged KV cache (llm_cache_kind='paged'): "
            "a dense cache has no block table to migrate between replicas"
        )


def make_ticket(
    mig_id: str,
    *,
    prompt: List[int],
    tok0: int,
    n_blocks: int,
    block_size: int,
    block_shape: Tuple[int, ...],
    block_dtype: str,
    transfer_addr: Optional[str],
    data_addr: Optional[str],
    source: str,
) -> dict:
    """The migration's control header: block-table metadata only, JSON-
    serialisable (the KV payload never rides it).  ``block_dtype`` is the
    dtype's name as both packages spell it (``"float32"``, ``"bfloat16"``);
    ``source`` names the prefill engine."""
    return {
        "mig_id": mig_id,
        "prompt": list(prompt),
        "tok0": int(tok0),
        "n_blocks": int(n_blocks),
        "block_size": int(block_size),
        "block_shape": tuple(block_shape),
        "block_dtype": str(block_dtype),
        "transfer_addr": transfer_addr,
        "data_addr": data_addr,
        "source": source,
    }


def pull_block(ticket: dict, block_idx: int,
               timeout_s: Optional[float] = None) -> Tuple[Any, str]:
    """Fetch one staged block for ``ticket``: the in-process staged copy,
    else a device pull from the ticket's transfer server, each of whose
    reads waits at most ``timeout_s`` (default
    ``Config.kv_migration_pull_timeout_s``).  Returns ``(tensor, rung)``;
    raises :class:`KVMigrationError` when no rung reaches the block."""
    import torch

    from ray_tpu_torch.runtime import data_plane, device_plane

    mig_id = ticket["mig_id"]
    if timeout_s is None:
        timeout_s = get_config().kv_migration_pull_timeout_s
    # engines of one process short-circuit FIRST: a registry hit means the
    # prefill engine staged these very tensors here — the decode engine's
    # write into its own pages is the only copy
    fetch = data_plane.kv_block_source(mig_id)
    if fetch is not None:
        try:
            arr = fetch(block_idx)
        except Exception as exc:  # noqa: BLE001 — released mid-pull
            raise KVMigrationError(
                mig_id, "pulled", f"staged block {block_idx} lost: {exc!r}"
            ) from exc
        return arr, "host"
    addr = ticket.get("transfer_addr")
    if addr:
        template = torch.empty(
            tuple(ticket["block_shape"]), dtype=getattr(torch, ticket["block_dtype"]),
            device="meta",
        )
        arr = device_plane.device_pull(addr, migration_uuid(mig_id, block_idx), template,
                                       timeout_s=timeout_s)
        if arr is not None:
            return arr, "device"
    data_addr = ticket.get("data_addr")
    raise KVMigrationError(
        mig_id, "staging",
        f"block {block_idx}: no rung could reach the staged page "
        f"(transfer_addr={addr!r}, data_addr={data_addr!r})",
    )


def local_data_addr() -> Optional[str]:
    """Address of this node's data server (the host-staged rung a ticket
    advertises): None, because the port runs no data server."""
    return None
