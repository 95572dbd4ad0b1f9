"""Compiled DAG execution.

The port's copy of ``ray_tpu/dag/compiled.py``.  Reference parity:
``python/ray/dag/compiled_dag_node.py:278`` (CompiledDAG): compile once,
then repeated ``execute()`` calls skip per-call scheduling.  Compilation
picks one of two strategies:

- **Inline tensor walk** (``fuse='jit'|'auto'``): a DAG of pure function
  nodes runs in the caller's thread, node after node, with no task, no
  scheduler hop and no object per node; on CUDA tensors each node's
  kernels queue on the caller's stream back to back.  It is the port's
  counterpart of the JAX package's one ``jax.jit`` program, without the
  whole-graph compilation: a walk requires every input leaf and every
  node's result to be a ``torch.Tensor``, a Python number, or a list,
  tuple or dict of these (the values ``jax.jit`` traces), and raises
  ``TypeError`` otherwise, as tracing a string does.  Under ``auto`` only
  the FIRST walk may fall back to the direct schedule; once a walk has
  passed, later errors re-raise.  ``torch.compile`` is not used: the port's
  device work is hand-written kernels, and the graph of an arbitrary user
  function is not captured.
- **Direct schedule** (``fuse='none'`` or fallback): a pre-resolved
  topological schedule runs function nodes in the driver, and pushes
  in-proc actor-method calls straight onto the actor's call queue: the
  actor thread still executes them (single-threaded actor guarantee is
  preserved, serialized with concurrent ``.remote()`` calls) but with no
  TaskSpec, no scheduler hop, and no ObjectRef per call.
"""

from __future__ import annotations

import sys
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Optional

from ray_tpu_torch.dag.dag_node import (
    ClassMethodNode,
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
    _DagInput,
)
from ray_tpu_torch.exceptions import ActorDiedError


def _check_leaves(value: Any, what: str) -> None:
    """The trace check of the inline walk: tensors, numbers (bool
    included) and containers of them pass; anything else raises
    ``TypeError`` naming it."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(value, torch.Tensor):
        return
    if isinstance(value, (int, float, complex)):
        return
    if isinstance(value, (list, tuple)):
        for v in value:
            _check_leaves(v, what)
        return
    if isinstance(value, dict):
        for v in value.values():
            _check_leaves(v, what)
        return
    raise TypeError(
        f"{what} of type {type(value).__name__} is not a tensor, a number or "
        "a container of these: the inline walk (fuse='jit') takes only those"
    )


class CompiledDAG:
    def __init__(self, root: DAGNode, *, fuse: str = "auto"):
        if fuse not in ("auto", "jit", "none"):
            raise ValueError(f"fuse must be auto|jit|none, got {fuse!r}")
        self._root = root
        self._order = root.topological()
        self._lock = threading.Lock()
        self._executor: Optional[ThreadPoolExecutor] = None
        self._torn_down = False
        self._traced_ok = False  # an inline walk has passed at least once

        fuseable = all(
            isinstance(n, (InputNode, InputAttributeNode, FunctionNode, MultiOutputNode))
            for n in self._order
        )
        if fuse == "jit" and not fuseable:
            offenders = [type(n).__name__ for n in self._order if isinstance(n, ClassMethodNode)]
            raise ValueError(f"fuse='jit' requires a pure function DAG; found {offenders}")
        self._mode = "jit" if (fuse in ("auto", "jit") and fuseable) else "direct"
        self._allow_fallback = fuse == "auto"
        if self._mode == "direct":
            self._prepare_direct()

    # ------------------------------------------------------------------
    # the single graph walker, parameterized by call strategy
    # ------------------------------------------------------------------
    def _walk(self, args, kwargs, call_function, call_actor_method):
        cache: Dict[int, Any] = {}
        for node in self._order:
            if isinstance(node, InputNode):
                cache[id(node)] = _DagInput(args, kwargs) if (kwargs or len(args) != 1) else args[0]
            elif isinstance(node, InputAttributeNode):
                cache[id(node)] = cache[id(node._bound_args[0])].select(node._key)
            else:
                a = tuple(node._resolve(x, cache) for x in node._bound_args)
                kw = {k: node._resolve(v, cache) for k, v in node._bound_kwargs.items()}
                if isinstance(node, FunctionNode):
                    cache[id(node)] = call_function(node, a, kw)
                elif isinstance(node, ClassMethodNode):
                    cache[id(node)] = call_actor_method(node, a, kw)
                elif isinstance(node, MultiOutputNode):
                    cache[id(node)] = list(a)
        return cache[id(self._root)]

    @staticmethod
    def _call_function_inline(node: FunctionNode, args, kwargs):
        return node.func(*args, **kwargs)

    @staticmethod
    def _call_function_checked(node: FunctionNode, args, kwargs):
        out = node.func(*args, **kwargs)
        _check_leaves(out, f"the result of {getattr(node.func, '__name__', 'a node')}")
        return out

    def _inline(self, args, kwargs):
        _check_leaves(list(args), "a DAG input")
        _check_leaves(kwargs, "a DAG input")
        return self._walk(args, kwargs, self._call_function_checked, None)

    # ------------------------------------------------------------------
    # direct-schedule path
    # ------------------------------------------------------------------
    def _prepare_direct(self) -> None:
        """Pre-resolve in-proc actor instances so execute() does no lookups."""
        from ray_tpu_torch.api import get_cluster

        self._direct_actors: Dict[int, Any] = {}
        cluster = get_cluster()
        for node in self._order:
            if not isinstance(node, ClassMethodNode):
                continue
            actor_id = node.actor_handle._actor_id
            info = cluster.control.actors.get(actor_id)
            if info is None or info.node_id is None:
                continue
            raylet = cluster.nodes.get(info.node_id)
            if raylet is None:
                continue
            inst = getattr(raylet, "actors", {}).get(actor_id)
            if inst is not None and inst.mode == "inproc":
                self._direct_actors[id(node)] = inst
            # else: process actor: node falls back to the queued call path

    def _call_actor_direct(self, node: ClassMethodNode, args, kwargs):
        from ray_tpu_torch.api import get

        inst = self._direct_actors.get(id(node))
        if inst is None or inst.instance is None:
            # process actor (or not yet alive): normal submit path
            return get(node._actor_method.remote(*args, **kwargs))
        if inst.dead:
            raise ActorDiedError(node.actor_handle._actor_id)
        # ride the actor's own call queue: executes on the actor thread in
        # program order with queued .remote() calls, minus TaskSpec/ObjectRef.
        # The future registers with the actor's death notification, so a
        # kill with the call still queued surfaces ActorDiedError the
        # instant the death sweep runs, not at the next poll tick.
        fut: Future = Future()

        def on_death() -> None:
            try:
                fut.set_exception(ActorDiedError(node.actor_handle._actor_id))
            except BaseException:  # noqa: BLE001 — call already resolved
                pass

        inst.on_death(on_death)
        try:
            inst.call_queue.put(("__direct__", (node.method_name, args, kwargs, fut)))
            return fut.result()
        finally:
            inst.remove_death_callback(on_death)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def execute(self, *args, **kwargs):
        """Run one invocation; returns the raw result value(s): compiled
        DAGs skip the ObjectRef layer entirely (use put() if a ref is
        needed downstream)."""
        if self._torn_down:
            raise RuntimeError("CompiledDAG was torn down")
        if self._mode == "jit":
            try:
                out = self._inline(args, kwargs)
                self._traced_ok = True
                return out
            except Exception:
                # only the FIRST walk may fall back (a node that is not a
                # tensor function discovered); later errors are user errors
                if not self._allow_fallback or self._traced_ok:
                    raise
                self._mode = "direct"
                self._prepare_direct()
        with self._lock:
            return self._walk(args, kwargs, self._call_function_inline, self._call_actor_direct)

    def execute_async(self, *args, **kwargs) -> Future:
        if self._executor is None:
            self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="compiled-dag")
        return self._executor.submit(self.execute, *args, **kwargs)

    @property
    def mode(self) -> str:
        return self._mode

    def teardown(self) -> None:
        self._torn_down = True
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None
