"""Internal KV: direct access to the control service's key-value store.

The port's copy of ``ray_tpu/experimental/internal_kv.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Parity: ``python/ray/experimental/internal_kv.py`` — the same
``_internal_kv_get/put/del/list/exists`` surface over the control store
(GCS InternalKV, ``gcs_kv_manager.h``).
"""

from __future__ import annotations

from typing import List, Optional


def _kv():
    import ray_tpu_torch as rt

    return rt.get_cluster().control.kv


def _internal_kv_initialized() -> bool:
    import ray_tpu_torch as rt

    return rt.is_initialized()


def _internal_kv_put(key: bytes, value: bytes, overwrite: bool = True, namespace: str = "default") -> bool:
    """Returns True if the key already existed (reference semantics)."""
    key, value = _b(key), _b(value)
    existed = _kv().exists(key, namespace)
    _kv().put(key, value, namespace, overwrite=overwrite)
    return existed


def _internal_kv_get(key: bytes, namespace: str = "default") -> Optional[bytes]:
    return _kv().get(_b(key), namespace)


def _internal_kv_exists(key: bytes, namespace: str = "default") -> bool:
    return _kv().exists(_b(key), namespace)


def _internal_kv_del(key: bytes, namespace: str = "default") -> int:
    return int(_kv().delete(_b(key), namespace))


def _internal_kv_list(prefix: bytes, namespace: str = "default") -> List[bytes]:
    return _kv().keys(_b(prefix), namespace)


def _b(v) -> bytes:
    return v.encode() if isinstance(v, str) else v
