"""Job data models (parity: ``python/ray/dashboard/modules/job/pydantic_models.py``
— JobDetails/JobType/DriverInfo — and ``common.py`` JobInfo).

The port's copy of ``ray_tpu/job/models.py``."""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Any, Dict, Optional

from ray_tpu_torch.job.manager import JobStatus


class JobType(str, Enum):
    """How the job entered the cluster (parity: JobType)."""

    SUBMISSION = "SUBMISSION"  # via the job SDK/CLI/REST
    DRIVER = "DRIVER"  # a bare driver that called init() itself


@dataclasses.dataclass
class DriverInfo:
    """The driver process behind a job (parity: DriverInfo)."""

    id: str
    node_ip_address: str = "127.0.0.1"
    pid: Optional[int] = None


@dataclasses.dataclass
class JobInfo:
    """One job's state snapshot (parity: JobInfo)."""

    status: JobStatus
    entrypoint: str
    submission_id: Optional[str] = None
    message: Optional[str] = None
    metadata: Optional[Dict[str, str]] = None
    start_time: Optional[float] = None
    end_time: Optional[float] = None
    runtime_env: Optional[Dict[str, Any]] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "JobInfo":
        return cls(
            status=JobStatus(d["status"]),
            entrypoint=d.get("entrypoint", ""),
            submission_id=d.get("submission_id"),
            message=d.get("message"),
            metadata=d.get("metadata"),
            start_time=d.get("start_time"),
            end_time=d.get("end_time"),
            runtime_env=d.get("runtime_env"),
        )


@dataclasses.dataclass
class JobDetails(JobInfo):
    """JobInfo plus identity fields (parity: JobDetails)."""

    type: JobType = JobType.SUBMISSION
    job_id: Optional[str] = None
    driver_info: Optional[DriverInfo] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "JobDetails":
        base = JobInfo.from_dict(d)
        drv = d.get("driver_info")
        return cls(
            **dataclasses.asdict(base),
            type=JobType(d.get("type", "SUBMISSION")),
            job_id=d.get("job_id") or d.get("submission_id"),
            driver_info=DriverInfo(**drv) if isinstance(drv, dict) else drv,
        )
