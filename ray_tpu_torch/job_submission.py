"""``ray_tpu_torch.job_submission`` — the port's copy of
``ray_tpu/job_submission.py``, the reference's import path for the job SDK
(``python/ray/job_submission/__init__.py``). Canonical home:
``ray_tpu_torch.job``."""

from ray_tpu_torch.job.manager import JobStatus
from ray_tpu_torch.job.models import DriverInfo, JobDetails, JobInfo, JobType
from ray_tpu_torch.job.sdk import JobSubmissionClient

__all__ = [
    "JobSubmissionClient",
    "JobStatus",
    "JobInfo",
    "JobDetails",
    "JobType",
    "DriverInfo",
]
