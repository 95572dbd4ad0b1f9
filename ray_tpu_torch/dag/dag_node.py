"""DAG node types and interpreted execution.

The port's copy of ``ray_tpu/dag/dag_node.py``.  Reference parity: ``python/ray/dag/dag_node.py`` (DAGNode base),
``input_node.py`` (InputNode/InputAttributeNode), ``output_node.py``
(MultiOutputNode). ``.execute()`` without compilation walks the graph and
submits each node as a normal task/actor call — identical semantics to the
reference's non-compiled DAG execution.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

_input_context = threading.local()


class DAGNode:
    """Base: a lazily-bound computation with upstream DAGNode args."""

    def __init__(self, args: Tuple = (), kwargs: Optional[dict] = None):
        self._bound_args = args
        self._bound_kwargs = kwargs or {}

    # -- traversal ---------------------------------------------------------
    def _upstream(self) -> List["DAGNode"]:
        ups = [a for a in self._bound_args if isinstance(a, DAGNode)]
        ups += [v for v in self._bound_kwargs.values() if isinstance(v, DAGNode)]
        return ups

    def topological(self) -> List["DAGNode"]:
        # iterative DFS: bind() chains can exceed Python's recursion limit
        order: List[DAGNode] = []
        seen: set = set()
        stack: List[Tuple[DAGNode, bool]] = [(self, False)]
        while stack:
            node, expanded = stack.pop()
            if expanded:
                order.append(node)
                continue
            if id(node) in seen:
                continue
            seen.add(id(node))
            stack.append((node, True))
            for up in node._upstream():
                if id(up) not in seen:
                    stack.append((up, False))
        return order

    # -- execution ---------------------------------------------------------
    def execute(self, *input_args, **input_kwargs):
        """Interpreted execution: one task/actor call per node; returns the
        terminal ObjectRef (or list for MultiOutputNode)."""
        from ray_tpu_torch.api import _auto_init

        _auto_init()
        cache: Dict[int, Any] = {}
        for node in self.topological():
            cache[id(node)] = node._submit(cache, input_args, input_kwargs)
        return cache[id(self)]

    def experimental_compile(self, *, fuse: str = "auto") -> "CompiledDAG":
        """fuse: 'auto' tries the inline tensor walk and falls back to the
        direct-call schedule; 'jit' requires it; 'none' always direct-call
        (``dag/compiled.py``)."""
        from ray_tpu_torch.dag.compiled import CompiledDAG

        return CompiledDAG(self, fuse=fuse)

    def compile_plan(self, name: str = "", auto_repair: bool = False) -> "ExecutionPlan":
        """Compile an actor-method DAG into an execution plan: stage
        programs installed ONCE on every participating node, edges as
        persistent channels, zero TaskSpecs/ObjectRefs per execute().
        ``auto_repair=True`` opts the plan into self-healing: when a stage
        actor/node death flips it BROKEN, a background repair waits for the
        restart FSM to bring the dead actors back and reinstalls onto the
        replacements instead of staying broken forever."""
        from ray_tpu_torch.dag.plan import ExecutionPlan

        return ExecutionPlan(self, name=name, auto_repair=auto_repair)

    def _resolve(self, value, cache):
        return cache[id(value)] if isinstance(value, DAGNode) else value

    def _submit(self, cache, input_args, input_kwargs):
        raise NotImplementedError


class InputNode(DAGNode):
    """The DAG's runtime input placeholder (``with InputNode() as inp:``)."""

    def __init__(self):
        super().__init__()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return InputAttributeNode(self, name)

    def __getitem__(self, key):
        return InputAttributeNode(self, key)

    def _submit(self, cache, input_args, input_kwargs):
        if input_kwargs or len(input_args) != 1:
            return _DagInput(input_args, input_kwargs)
        return input_args[0]


class _DagInput:
    """Multi-arg input bundle addressed by InputAttributeNode."""

    def __init__(self, args: Tuple, kwargs: dict):
        self.args = args
        self.kwargs = kwargs

    def select(self, key):
        if isinstance(key, int):
            return self.args[key]
        return self.kwargs[key]


class InputAttributeNode(DAGNode):
    """``inp[0]`` / ``inp.x`` — selects one field of the DAG input."""

    def __init__(self, upstream: InputNode, key):
        super().__init__(args=(upstream,))
        self._key = key

    def _submit(self, cache, input_args, input_kwargs):
        bundle = self._resolve(self._bound_args[0], cache)
        if isinstance(bundle, _DagInput):
            return bundle.select(self._key)
        raise ValueError(
            f"DAG input selector {self._key!r} used but execute() got a single argument"
        )


class FunctionNode(DAGNode):
    """A bound remote-function call (``f.bind(...)``)."""

    def __init__(self, remote_function, args: Tuple, kwargs: dict):
        super().__init__(args, kwargs)
        self._remote_function = remote_function

    @property
    def func(self):
        return self._remote_function._function

    def _submit(self, cache, input_args, input_kwargs):
        args = tuple(self._resolve(a, cache) for a in self._bound_args)
        kwargs = {k: self._resolve(v, cache) for k, v in self._bound_kwargs.items()}
        return self._remote_function.remote(*args, **kwargs)


class ClassMethodNode(DAGNode):
    """A bound actor-method call (``actor.method.bind(...)``)."""

    def __init__(self, actor_method, args: Tuple, kwargs: dict):
        super().__init__(args, kwargs)
        self._actor_method = actor_method

    @property
    def actor_handle(self):
        return self._actor_method._handle

    @property
    def method_name(self) -> str:
        return self._actor_method._method_name

    def _submit(self, cache, input_args, input_kwargs):
        args = tuple(self._resolve(a, cache) for a in self._bound_args)
        kwargs = {k: self._resolve(v, cache) for k, v in self._bound_kwargs.items()}
        return self._actor_method.remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    """Terminal node returning multiple leaves."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__(args=tuple(outputs))

    def _submit(self, cache, input_args, input_kwargs):
        return [self._resolve(o, cache) for o in self._bound_args]
