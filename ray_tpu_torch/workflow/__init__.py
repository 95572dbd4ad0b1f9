"""ray_tpu_torch.workflow: durable DAG execution.

The port's copy of ``ray_tpu/workflow/`` (the same ``__all__``).

TPU-native rebuild of the reference's Ray Workflows
(``python/ray/workflow/``, SURVEY §2.4): a DAG of tasks executed with every
step result checkpointed to storage (``workflow_storage.py:229``), so a
crashed/resumed workflow replays only incomplete steps — exactly-once-ish
semantics over the task fabric.
"""

from ray_tpu_torch.workflow.api import (
    cancel,
    continuation,
    delete,
    get_metadata,
    get_output,
    get_output_async,
    get_status,
    init,
    list_all,
    options,
    resume,
    resume_all,
    resume_async,
    run,
    run_async,
    sleep,
)
from ray_tpu_torch.workflow.exceptions import (
    WorkflowCancellationError,
    WorkflowError,
    WorkflowExecutionError,
)
from ray_tpu_torch.workflow.events import (
    EventListener,
    QueueEventListener,
    TimerListener,
    deliver_event,
    wait_for_event,
)
from ray_tpu_torch.workflow.storage import WorkflowStorage

__all__ = [
    "EventListener",
    "WorkflowCancellationError",
    "WorkflowError",
    "WorkflowExecutionError",
    "continuation",
    "get_metadata",
    "get_output_async",
    "options",
    "resume_all",
    "resume_async",
    "sleep",
    "QueueEventListener",
    "TimerListener",
    "WorkflowStorage",
    "cancel",
    "deliver_event",
    "wait_for_event",
    "delete",
    "get_output",
    "get_status",
    "init",
    "list_all",
    "resume",
    "run",
    "run_async",
]
