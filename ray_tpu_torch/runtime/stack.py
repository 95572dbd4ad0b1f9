"""Cluster-wide live stack dumps (`rt stack`).

The port's copy of ``ray_tpu/runtime/stack.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Reference role: ``ray stack`` (python/ray/scripts/scripts.py:1830), which
shells out to py-spy for every worker pid on the node.  Here every process
answers over its existing control channel instead: pool workers reply on
their reader thread (so a wedged exec thread still answers — exactly when
a stack dump is needed), agents aggregate their own threads plus their
pool's, and the head merges everything.  py-spy needs ptrace and an extra
binary; ``sys._current_frames`` needs nothing and sees every Python thread.
"""

from __future__ import annotations

import sys
import threading
import traceback
from typing import Dict


def format_thread_stacks() -> str:
    """Every thread's current stack in this process, faulthandler-style."""
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in frames.items():
        out.append(f"Thread {names.get(ident, '?')} (ident {ident}):")
        out.extend(line.rstrip() for line in traceback.format_stack(frame))
    return "\n".join(out)


def node_stacks(node, timeout: float = 5.0) -> Dict[str, object]:
    """This process's threads plus every pool worker's, for one node."""
    workers: Dict[int, str] = {}
    pool = getattr(node, "worker_pool", None)
    if pool is not None:
        try:
            workers = pool.dump_worker_stacks(timeout=timeout)
        except Exception as exc:  # noqa: BLE001 — a dump must never fail hard
            workers = {-1: f"<worker dump failed: {exc}>"}
    return {"process": format_thread_stacks(), "workers": {str(k): v for k, v in workers.items()}}
