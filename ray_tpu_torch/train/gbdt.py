"""Shared plumbing for the gradient-boosting trainers (XGBoost / LightGBM).

Parity: ``python/ray/train/xgboost/xgboost_trainer.py:74`` and
``python/ray/train/lightgbm/lightgbm_trainer.py`` — both reference trainers
are DataParallelTrainers whose per-worker loop trains the framework's
booster on the worker's dataset shard, reporting eval metrics every boosting
round and checkpointing the model through the train session.  The
distributed rendezvous differs per framework (xgboost: rabit-style tracker;
lightgbm: a ``machines`` host list) — the reference wires both through its
backend config classes (``train/xgboost/config.py``,
``train/lightgbm/config.py``); here both ride the cluster's internal KV
store instead of a side channel.

The frameworks themselves are not bundled with ray_tpu_torch: the trainers work
when ``xgboost`` / ``lightgbm`` import, and raise an actionable error
otherwise (same gating style as the Tune external searchers).

The port's copy of ``ray_tpu/train/gbdt.py``, whole.  A framework is
resolved when a rank calls :func:`require_module`, never when a module is
imported, so an in-process stand-in (``sys.modules``) reaches the ranks.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional


def require_module(name: str):
    """Import a GBDT framework or raise an actionable error."""
    try:
        return __import__(name)
    except ImportError as exc:  # pragma: no cover - exercised via stub test
        raise ImportError(
            f"{name} is required for this trainer but is not installed. "
            f"Run `pip install {name}` (any recent version works; the "
            f"trainer only drives the public train()/Booster APIs)."
        ) from exc


def shard_to_xy(shard, label_column: str):
    """Materialize a dataset shard into (features_df, label_series)."""
    df = shard.to_pandas()
    if label_column not in df.columns:
        raise ValueError(
            f"label_column={label_column!r} not in dataset columns {list(df.columns)}"
        )
    return df.drop(columns=[label_column]), df[label_column]


def host_ip() -> str:
    """This host's address as reachable by gang peers on other nodes.

    Routed-UDP-connect lookup (``util.misc.get_node_ip_address``) — NOT
    ``gethostbyname(hostname)``, which resolves to the unroutable 127.0.1.1
    on Debian-family images."""
    from ray_tpu_torch.util.misc import get_node_ip_address

    return get_node_ip_address()


def default_rendezvous_timeout() -> float:
    """Gang-rendezvous deadline (seconds).  Env-overridable because the
    slowest rank may be separated from the fastest by data-load skew."""
    import os

    return float(os.environ.get("RAY_TPU_GBDT_RENDEZVOUS_TIMEOUT_S", "300"))


def kv_rendezvous(
    key_prefix: str,
    rank: int,
    world_size: int,
    payload: Dict[str, Any],
    timeout: Optional[float] = None,
) -> List[Dict[str, Any]]:
    """All-gather small JSON payloads across a training gang via internal KV.

    Every rank publishes ``{key_prefix}/{rank}`` and blocks until all
    ``world_size`` entries exist; returns the payloads in rank order.  Used
    for the GBDT collective bootstraps (tracker address, machines list) the
    reference passes through its backend configs.
    """
    from ray_tpu_torch.experimental import internal_kv

    if timeout is None:
        timeout = default_rendezvous_timeout()

    def _gather(prefix: str, what: str) -> List[bytes]:
        deadline = time.monotonic() + timeout
        while True:
            vals = []
            for r in range(world_size):
                raw = internal_kv._internal_kv_get(f"{prefix}/{r}".encode())
                if raw is None:
                    break
                vals.append(raw)
            if len(vals) == world_size:
                return vals
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"GBDT rendezvous {prefix!r} ({what}): {len(vals)}/"
                    f"{world_size} ranks reported within {timeout}s"
                )
            time.sleep(0.02)

    internal_kv._internal_kv_put(
        f"{key_prefix}/{rank}".encode(), json.dumps(payload).encode()
    )
    out = [json.loads(raw) for raw in _gather(key_prefix, "payloads")]
    # Cleanup must not race slower readers: every rank acks its read, rank 0
    # deletes after all acks.  Best-effort only — a rank that dies before
    # acking must not wedge the survivors, and stale keys are harmless
    # because callers scope key_prefix by the gang's per-attempt token.
    internal_kv._internal_kv_put(f"{key_prefix}/ack/{rank}".encode(), b"1")
    if rank == 0:
        try:
            _gather(f"{key_prefix}/ack", "acks")
        except TimeoutError:
            return out
        for r in range(world_size):
            internal_kv._internal_kv_del(f"{key_prefix}/{r}".encode())
            internal_kv._internal_kv_del(f"{key_prefix}/ack/{r}".encode())
    return out


def eval_shards(dataset_keys, label_column: str, train_key: str):
    """Yield ``(name, X, y)`` for every non-train dataset shard of the
    session, in sorted order — the shared eval-set loop of both trainers."""
    from ray_tpu_torch.train import session as train_session

    for name in sorted(dataset_keys):
        if name == train_key:
            continue
        X, y = shard_to_xy(train_session.get_dataset_shard(name), label_column)
        yield name, X, y
