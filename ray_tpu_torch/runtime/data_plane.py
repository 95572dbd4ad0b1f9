"""KV-block migration sources (disaggregated serving, ``serve/disagg.py``).

The port's own copy of the registry in ``ray_tpu/runtime/data_plane.py``: a
prefill engine registers its staged block set here under the migration id,
and a pull in the same process resolves through it (the in-process rung of
``disagg.pull_block``).  Process-global: engines of one process share it.
The data server and its host-staged ``kv_pull`` op are not ported.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

_kv_sources_lock = threading.Lock()
_kv_sources: Dict[str, Callable[[int], Any]] = {}


def register_kv_block_source(mig_id: str, fetch: Callable[[int], Any]) -> None:
    """``fetch(block_idx) -> tensor`` for one staged migration."""
    with _kv_sources_lock:
        _kv_sources[mig_id] = fetch


def unregister_kv_block_source(mig_id: str) -> None:
    with _kv_sources_lock:
        _kv_sources.pop(mig_id, None)


def kv_block_source(mig_id: str) -> Optional[Callable[[int], Any]]:
    with _kv_sources_lock:
        return _kv_sources.get(mig_id)
