"""Workflow exception types (parity: python/ray/workflow/exceptions.py);
the port's copy of ``ray_tpu/workflow/exceptions.py``.

``WorkflowCancellationError`` subclasses RuntimeError as well — cancellation
surfaced as a bare RuntimeError before these types existed, and callers
catching that must keep working.
"""

from ray_tpu_torch.exceptions import RayTpuError


class WorkflowError(RayTpuError):
    """Base for workflow-layer failures."""


class WorkflowExecutionError(WorkflowError):
    """The workflow ran and ended in a failed/canceled terminal state."""


class WorkflowCancellationError(WorkflowError, RuntimeError):
    """The workflow was canceled while executing."""
