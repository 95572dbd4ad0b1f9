"""Disaggregated prefill/decode serving: KV-block migration between engines.

The port's own copy of ``ray_tpu/serve/disagg.py``.
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
between processes of one host, the ``"device"`` rung) → the host-staged
``kv_pull`` of the data server at the ticket's ``data_addr``
(``runtime/data_plane.py``; a CPU tensor, the ``"host"`` rung).  A block no
rung reaches raises :class:`KVMigrationError` with ``stage == "staging"``.

:class:`DisaggDispatcher` is the router's half (the reference's, imports
renamed): prefill → migrate → decode through ``Router.call_replica``, the
re-prefill ladder over ``Config.kv_migration_attempts``, and one audit event
per staging and per release on ``cluster.kv_migration_audits``.  Serve's
replicas live in the process that started Serve, so their blocks move by
the in-process rung.

Determinism: block uuids derive from the migration id
(:func:`migration_uuid`, bit-equal to the reference's), never at random.
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.observability import metric_defs

#: the two pool roles a disaggregated deployment declares
ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"

_OUTCOME_TAGS = {
    "device": {"outcome": "device"},
    "host": {"outcome": "host"},
    "reprefill": {"outcome": "reprefill"},
    "failed": {"outcome": "failed"},
}


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
    else a device pull from the ticket's transfer server, else the
    host-staged ``kv_pull`` from the ticket's data server; each read waits
    at most ``timeout_s`` (default ``Config.kv_migration_pull_timeout_s``).  Returns ``(tensor, rung)``;
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
    if data_addr:
        # host-staged rung: the block's bytes from the producer's data
        # server (the kv_pull op), a CPU tensor
        arr = data_plane.pull_kv_block(data_addr, mig_id, block_idx, timeout=timeout_s)
        if arr is not None:
            return arr, "host"
    raise KVMigrationError(
        mig_id, "staging",
        f"block {block_idx}: no rung could reach the staged page "
        f"(transfer_addr={addr!r}, data_addr={data_addr!r})",
    )


def local_data_addr() -> Optional[str]:
    """Address of this node's data server (the host-staged rung a ticket
    advertises): the head service's, which the port does not run yet (the
    multi-node runtime), so None, as the reference returns without one."""
    return None


def _record_audit(event: dict) -> None:
    """Append one migration-lifecycle audit onto the cluster (the chaos
    invariant sweep asserts every staged block set reaches exactly one
    terminal).  Best-effort: engines driven without a runtime still work."""
    try:
        from ray_tpu_torch.runtime.worker import global_worker

        cluster = global_worker().cluster
        audits = getattr(cluster, "kv_migration_audits", None)
        if audits is not None:
            audits.append(event)
    except Exception:  # noqa: BLE001 — audits must never fail a request
        pass


class DisaggDispatcher:
    """Role-aware request flow for one disaggregated deployment.

    Owned by the router (one per deployment with ``roles``); uses the
    router's replica list + metadata and calls replicas through the same
    ``handle_request`` surface as ordinary dispatch, so admission bounds,
    tenant context, and the request trace all ride along unchanged.
    """

    def __init__(self, router, deployment: str):
        self._router = router
        self._deployment = deployment
        self._lock = threading.Lock()
        self._seq = 0
        # monotonic dispatch counters per role (rt llm / /api/overload)
        self.dispatched = {ROLE_PREFILL: 0, ROLE_DECODE: 0}
        self.migrations = {k: 0 for k in _OUTCOME_TAGS}

    # ------------------------------------------------------------ identity
    def _next_mig_id(self) -> str:
        """Derived, never random: ``<deployment>/m<seq>`` with the attempt
        suffix appended per ladder rung — byte-identical across same-seed
        chaos replays."""
        with self._lock:
            self._seq += 1
            return f"{self._deployment}/m{self._seq}"

    # ------------------------------------------------------------ dispatch
    def route(self, request: dict, tenant=None, trace=None):
        """Full disaggregated flow for one request: prefill → migrate →
        decode, with the re-prefill fallback ladder."""
        from ray_tpu_torch.runtime import failpoints

        attempts = max(1, int(get_config().kv_migration_attempts))
        base_id = self._next_mig_id()
        last_exc: Optional[BaseException] = None
        for attempt in range(attempts):
            mig_id = base_id if attempt == 0 else f"{base_id}#a{attempt}"
            t0 = time.perf_counter()
            # prefill-pool failures raise as ordinary request errors, not
            # migration failures: no staged state exists yet
            p_index, ticket = self._prefill(request, mig_id, tenant, trace)
            _record_audit({
                "mig_id": mig_id,
                "event": "staged",
                "deployment": self._deployment,
                "blocks": ticket["n_blocks"],
                "attempt": attempt,
            })
            try:
                hit = failpoints.fp("disagg.decode_call")
                if hit == "raise":  # pragma: no cover — fp() raises itself
                    raise KVMigrationError(mig_id, "staging", "failpoint")
                result, rung = self._decode(request, ticket, tenant, trace)
            except BaseException as exc:  # noqa: BLE001 — ladder catches all
                self._release(p_index, mig_id,
                              "reprefill" if attempt + 1 < attempts
                              else "failed", tenant)
                last_exc = exc
                if attempt + 1 < attempts:
                    outcome = "reprefill"
                    self.migrations[outcome] += 1
                    metric_defs.LLM_KV_MIGRATIONS.inc(tags=_OUTCOME_TAGS[outcome])
                    continue
                self.migrations["failed"] += 1
                metric_defs.LLM_KV_MIGRATIONS.inc(tags=_OUTCOME_TAGS["failed"])
                raise KVMigrationError(
                    mig_id, "pulled",
                    f"fallback ladder exhausted after {attempts} attempt(s): "
                    f"{exc!r}",
                ) from exc
            # decode replica owns its copies now: drop the staged set on
            # the prefill side (its pages already retired into the prefill
            # replica's prefix cache at export)
            self._release(p_index, mig_id, "adopted", tenant)
            self.migrations[rung] += 1
            metric_defs.LLM_KV_MIGRATIONS.inc(tags=_OUTCOME_TAGS[rung])
            metric_defs.LLM_KV_MIGRATION_SECONDS.observe(time.perf_counter() - t0)
            if isinstance(result, dict) and "_stream" in result:
                # streaming decode: hand the per-token event generator
                # straight to the proxy, like the homogeneous path does
                return result["_stream"]
            return result
        raise last_exc  # pragma: no cover — loop always returns or raises

    # ------------------------------------------------------------ replicas
    def _call(self, index: int, method: str, args: tuple, tenant, trace,
              timeout: Optional[float] = None):
        return self._router.call_replica(
            self._deployment, index, method, args, tenant, trace,
            timeout=timeout,
        )

    def _prefill(self, request: dict, mig_id: str, tenant,
                 trace) -> Tuple[int, dict]:
        index = self._router.pick_role_replica(
            self._deployment, ROLE_PREFILL, signal="queue"
        )
        self.dispatched[ROLE_PREFILL] += 1
        ticket = self._call(
            index, "disagg_prefill", (dict(request), mig_id), tenant, trace
        )
        if not isinstance(ticket, dict) or "mig_id" not in ticket:
            raise KVMigrationError(
                mig_id, "prefill-done",
                f"prefill replica returned no ticket: {type(ticket)}",
            )
        return index, ticket

    def _decode(self, request: dict, ticket: dict, tenant, trace):
        index = self._router.pick_role_replica(
            self._deployment, ROLE_DECODE, signal="kv_free"
        )
        self.dispatched[ROLE_DECODE] += 1
        out = self._call(
            index, "disagg_decode", (dict(request), ticket), tenant, trace
        )
        if isinstance(out, dict) and out.pop("_kv_migration_error", None):
            raise KVMigrationError(
                ticket["mig_id"], out.get("stage", "pulled"),
                out.get("message", "decode replica refused the migration"),
            )
        rung = "device"
        if isinstance(out, dict):
            rung = out.pop("_migration_rung", "device")
        return out, rung

    def _release(self, p_index: int, mig_id: str, outcome: str,
                 tenant) -> None:
        """Drop the staged block set on the prefill side — exactly once
        per migration, whatever the outcome.  Best-effort: if the prefill
        replica itself died, the transfer server's TTL reaps its offers
        and the process-global source registry entry dies with it."""
        try:
            self._call(p_index, "disagg_release", (mig_id,), tenant, None)
        except Exception:  # noqa: BLE001 — TTL reaps stragglers
            pass
        _record_audit({
            "mig_id": mig_id,
            "event": "released",
            "deployment": self._deployment,
            "outcome": outcome,
        })

    # --------------------------------------------------------------- stats
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "dispatched": dict(self.dispatched),
                "migrations": dict(self.migrations),
            }
