"""JobSubmissionClient: HTTP client for the dashboard's job endpoints.

The port's copy of ``ray_tpu/job/sdk.py``.

Parity with ``dashboard/modules/job/sdk.py:39`` (``submit_job`` :129) over
stdlib urllib — no requests dependency.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import List, Optional


class JobSubmissionClient:
    def __init__(self, address: str):
        """``address`` is the dashboard URL, e.g. ``http://127.0.0.1:8265``."""
        self.address = address.rstrip("/")

    def _request(self, method: str, path: str, body: Optional[dict] = None) -> dict:
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.address + path,
            data=data,
            method=method,
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            try:
                detail = json.loads(exc.read()).get("error", "")
            except Exception:
                detail = ""
            raise RuntimeError(f"{method} {path} -> {exc.code}: {detail}") from None

    # ------------------------------------------------------------------
    def submit_job(
        self,
        *,
        entrypoint: str,
        runtime_env: Optional[dict] = None,
        metadata: Optional[dict] = None,
        submission_id: Optional[str] = None,
    ) -> str:
        body = {"entrypoint": entrypoint}
        if runtime_env:
            body["runtime_env"] = runtime_env
        if metadata:
            body["metadata"] = metadata
        if submission_id:
            body["submission_id"] = submission_id
        return self._request("POST", "/api/jobs/", body)["submission_id"]

    def get_job_info(self, submission_id: str) -> dict:
        return self._request("GET", f"/api/jobs/{submission_id}")

    def get_job_status(self, submission_id: str) -> str:
        return self.get_job_info(submission_id)["status"]

    def get_job_logs(self, submission_id: str) -> str:
        return self._request("GET", f"/api/jobs/{submission_id}/logs")["logs"]

    def stop_job(self, submission_id: str) -> bool:
        try:
            return self._request("POST", f"/api/jobs/{submission_id}/stop")["stopped"]
        except RuntimeError as exc:
            if "-> 404" in str(exc):  # unknown submission id
                return False
            raise

    def list_jobs(self) -> List[dict]:
        return self._request("GET", "/api/jobs/")["jobs"]

    def wait_until_finished(self, submission_id: str, timeout: float = 120.0) -> dict:
        deadline = time.time() + timeout
        while time.time() < deadline:
            info = self.get_job_info(submission_id)
            if info["status"] in ("SUCCEEDED", "FAILED", "STOPPED"):
                return info
            time.sleep(0.2)
        raise TimeoutError(f"job {submission_id} still {self.get_job_status(submission_id)} after {timeout}s")
