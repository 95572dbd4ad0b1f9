"""Start one process a rank and collect what each returns.

The reference is single controller: one process drives every device of a
mesh. Here every rank is a process, so a caller that holds the whole job
(a test, ``chip_smoke.py``) starts them with :func:`run_ranks`: each child
joins the process group (:func:`ray_tpu_torch.parallel.distributed.initialize`),
runs ``fn(*args)`` and sends back its return value. The children are
started by ``spawn`` (CUDA cannot be used after a ``fork``), so ``fn`` must
be importable by name from a module that does not import JAX. The parent
joins them within a deadline and kills them when it passes or when one
fails, so a collective that hangs ends as an error, not a wait.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional


def _child(call_path, rank, world_size, address, device, backend, timeout_s, results):
    import torch

    from ray_tpu_torch.parallel import distributed

    if device == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        distributed.initialize(address, world_size, rank, timeout_s=timeout_s,
                               backend=backend, device=device)
        out = fn(*args)
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - the parent re-raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        distributed.shutdown()


def run_ranks(fn: Callable, world_size: int, *args, timeout_s: float = 120.0,
              device: str = "cpu", backend: Optional[str] = None,
              address: Optional[str] = None) -> List[Any]:
    """Run ``fn(*args)`` on ``world_size`` spawned ranks; returns their
    return values in rank order. ``address``: the rendezvous (a
    ``file://`` path or ``host:port``; by default a file store in a
    directory of its own under the temporary directory, which no other run
    can take, as it could a port between its probe and its bind).
    ``timeout_s`` is the deadline of the whole run and of each collective.
    Raises ``RuntimeError`` with a failing rank's traceback, or
    ``TimeoutError``; every child is gone when it returns or raises."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    workdir = tempfile.mkdtemp(prefix="run_ranks-")
    address = address or f"file://{os.path.join(workdir, 'store')}"
    # the call goes by a file: a child reads its start-up pipe only once
    # its interpreter is up, so large arguments there start the ranks one
    # after another
    call_path = os.path.join(workdir, "call.pkl")
    with open(call_path, "wb") as f:
        pickle.dump((fn, args), f)
    procs = [ctx.Process(target=_child, daemon=True, args=(
        call_path, r, world_size, address, device, backend, timeout_s, results))
        for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    got = {}
    try:
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world_size - len(got)} of {world_size} ranks gave no "
                                   f"result within {timeout_s} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        results.close()
        shutil.rmtree(workdir, ignore_errors=True)
    return [got[r] for r in range(world_size)]

