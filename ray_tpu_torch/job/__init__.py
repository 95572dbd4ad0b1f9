"""Job submission: manager, supervisor processes, and the HTTP SDK.

The port's copy of ``ray_tpu/job/__init__.py``.

Parity with the reference's ``dashboard/modules/job/``: ``JobManager``
(``job_manager.py:56``) drives one supervisor per submitted job;
``JobSubmissionClient`` (``sdk.py:39``) is the REST client; the CLI front
end is ``rt job submit/status/logs/stop/list``.
"""

from ray_tpu_torch.job.manager import JobManager, JobStatus
from ray_tpu_torch.job.models import DriverInfo, JobDetails, JobInfo, JobType
from ray_tpu_torch.job.sdk import JobSubmissionClient

__all__ = [
    "JobManager",
    "JobStatus",
    "JobSubmissionClient",
    "JobInfo",
    "JobDetails",
    "JobType",
    "DriverInfo",
]
