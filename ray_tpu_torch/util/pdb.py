"""Breakpoint helper for tasks/actors (parity role: ray.util.pdb
set_trace + the ray debugger, python/ray/util/debugpy.py).

The port's copy of ``ray_tpu/util/pdb.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

The reference attaches a remote debugpy session to the worker process.
Here the common execution tiers (inproc/thread) share the driver's
terminal, so a plain pdb attaches directly when stdin is a TTY; in a
process worker (no usable TTY) the breakpoint is skipped with a logged
warning instead of hanging the worker forever on an unreadable stdin.
"""

from __future__ import annotations

import pdb as _pdb
import sys


def set_trace(breakpoint_uuid=None):
    """Drop into pdb if this process can actually interact; no-op (with a
    warning) in non-interactive workers."""
    if sys.stdin is not None and sys.stdin.isatty():
        debugger = _pdb.Pdb()
        debugger.set_trace(sys._getframe().f_back)
        return
    print(
        "ray_tpu_torch.util.pdb.set_trace(): skipped — this worker has no "
        "interactive stdin (run the task with execution='inproc' to debug "
        "on the driver's terminal)",
        file=sys.stderr,
        flush=True,
    )
