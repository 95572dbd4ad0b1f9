"""Job manager: runs submitted entrypoints as supervised subprocesses.

The port's copy of ``ray_tpu/job/manager.py``.  Two differences, both on
purpose: a job's ``PYTHONPATH`` starts with this package's root (its driver
imports ``ray_tpu_torch``), and :meth:`JobManager.shutdown` waits for the
process groups it signalled (then kills what is left), so no job's child
still holds the card once the head is down.

Parity with ``dashboard/modules/job/job_manager.py:56``: each submitted job
gets a supervisor that exec's the entrypoint shell command, captures its
output to a per-job log file in the session directory, tracks the status
FSM (PENDING → RUNNING → SUCCEEDED/FAILED/STOPPED), and applies the job's
``runtime_env`` (env_vars / working_dir) to the subprocess.  The reference's
supervisor is a detached actor; here a watcher thread per job suffices
because the manager lives in the head process.
"""

from __future__ import annotations

import os
import signal
import subprocess
import threading
import time
import uuid
from enum import Enum
from typing import Dict, List, Optional


#: seconds ``JobManager.shutdown`` waits for SIGTERMed jobs before SIGKILL
SHUTDOWN_WAIT_S = 10.0


class JobStatus(str, Enum):
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"


class _JobEntry:
    def __init__(self, submission_id: str, entrypoint: str, metadata: Optional[dict]):
        self.submission_id = submission_id
        self.entrypoint = entrypoint
        self.metadata = metadata or {}
        self.status = JobStatus.PENDING
        self.message = ""
        self.start_time = time.time()
        self.end_time: Optional[float] = None
        self.proc: Optional[subprocess.Popen] = None
        self.log_path: Optional[str] = None
        self.env_uris: list = []

    def to_dict(self) -> dict:
        return {
            "submission_id": self.submission_id,
            "entrypoint": self.entrypoint,
            "status": self.status.value,
            "message": self.message,
            "metadata": self.metadata,
            "start_time": self.start_time,
            "end_time": self.end_time,
        }


class JobManager:
    def __init__(self, cluster):
        self.cluster = cluster
        self._lock = threading.Lock()
        self._jobs: Dict[str, _JobEntry] = {}
        self._log_dir = os.path.join(cluster.session_dir, "logs")
        os.makedirs(self._log_dir, exist_ok=True)

    # ------------------------------------------------------------------
    def submit_job(
        self,
        entrypoint: str,
        runtime_env: Optional[dict] = None,
        metadata: Optional[dict] = None,
        submission_id: Optional[str] = None,
    ) -> str:
        sub_id = submission_id or f"rtjob_{uuid.uuid4().hex[:16]}"
        with self._lock:
            if sub_id in self._jobs:
                raise ValueError(f"submission_id {sub_id!r} already exists")
            entry = _JobEntry(sub_id, entrypoint, metadata)
            self._jobs[sub_id] = entry

        env = dict(os.environ)
        env["RAY_TPU_SUBMISSION_ID"] = sub_id
        # Make the framework importable in the driver regardless of cwd.
        import ray_tpu_torch

        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(ray_tpu_torch.__file__)))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        cwd = None
        env_uris: list = []
        if runtime_env:
            from ray_tpu_torch.runtime_env.plugin import apply_to_process_env, remove_references

            try:
                # plugins pin each staged artifact (refcount) as they stage it;
                # released in _watch when the process exits.
                env, cwd = apply_to_process_env(runtime_env, env, uris_out=env_uris)
                # command-wrapping plugins (mpi -> mpirun, container ->
                # podman/docker run) rewrite the entrypoint itself
                from ray_tpu_torch.runtime_env.plugin import wrap_entrypoint

                entrypoint = wrap_entrypoint(runtime_env, entrypoint, env, cwd)
            except Exception as exc:
                with self._lock:
                    entry.status = JobStatus.FAILED
                    entry.message = f"runtime_env setup failed: {exc}"
                    entry.end_time = time.time()
                remove_references(env_uris)
                return sub_id
        entry.env_uris = env_uris

        with self._lock:
            if entry.status == JobStatus.STOPPED:  # stop raced env staging
                self._release_env(entry)
                return sub_id

        entry.log_path = os.path.join(self._log_dir, f"job-{sub_id}.log")
        log_file = open(entry.log_path, "wb")
        try:
            proc = subprocess.Popen(
                entrypoint,
                shell=True,
                stdout=log_file,
                stderr=subprocess.STDOUT,
                env=env,
                cwd=cwd,
                start_new_session=True,  # own process group so stop_job can kill the tree
            )
        except OSError as exc:
            entry.status = JobStatus.FAILED
            entry.message = f"failed to start: {exc}"
            entry.end_time = time.time()
            log_file.close()
            self._release_env(entry)
            return sub_id
        with self._lock:
            entry.proc = proc
            stopped_mid_start = entry.status == JobStatus.STOPPED
            if not stopped_mid_start:
                entry.status = JobStatus.RUNNING
        if stopped_mid_start:
            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass
        threading.Thread(
            target=self._watch, args=(entry, log_file), name=f"job-{sub_id}", daemon=True
        ).start()
        return sub_id

    def _release_env(self, entry: _JobEntry) -> None:
        if entry.env_uris:
            from ray_tpu_torch.runtime_env.plugin import remove_references

            remove_references(entry.env_uris)
            entry.env_uris = []

    def _watch(self, entry: _JobEntry, log_file) -> None:
        code = entry.proc.wait()
        log_file.close()
        with self._lock:
            if entry.status == JobStatus.RUNNING:
                entry.status = JobStatus.SUCCEEDED if code == 0 else JobStatus.FAILED
                entry.message = f"exit code {code}"
            entry.end_time = time.time()
        self._release_env(entry)

    # ------------------------------------------------------------------
    def get_job(self, submission_id: str) -> Optional[dict]:
        with self._lock:
            entry = self._jobs.get(submission_id)
            return entry.to_dict() if entry else None

    def list_jobs(self) -> List[dict]:
        with self._lock:
            return [e.to_dict() for e in self._jobs.values()]

    def get_logs(self, submission_id: str) -> Optional[str]:
        with self._lock:
            entry = self._jobs.get(submission_id)
        if entry is None or entry.log_path is None:
            return None
        try:
            with open(entry.log_path, "rb") as f:
                return f.read().decode(errors="replace")
        except OSError:
            return ""

    def stop_job(self, submission_id: str) -> bool:
        with self._lock:
            entry = self._jobs.get(submission_id)
            if entry is None:
                return False
            if entry.status in (JobStatus.SUCCEEDED, JobStatus.FAILED, JobStatus.STOPPED):
                return True
            # PENDING (still staging) or RUNNING: record the stop; the
            # submit path honors it if the process hasn't launched yet.
            entry.status = JobStatus.STOPPED
            entry.message = "stopped by user"
            proc = entry.proc
            if proc is None:
                entry.end_time = time.time()
                return True
        try:
            os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            pass
        return True

    def wait_job(self, submission_id: str, timeout: float = 60.0) -> Optional[dict]:
        """Block until the job reaches a terminal state (test/CLI helper)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            info = self.get_job(submission_id)
            if info is None:
                return None
            if info["status"] in ("SUCCEEDED", "FAILED", "STOPPED"):
                return info
            time.sleep(0.05)
        return self.get_job(submission_id)

    def shutdown(self) -> None:
        """SIGTERM every running job's process group, wait up to
        ``SHUTDOWN_WAIT_S`` for the groups to empty, then SIGKILL what is
        left."""
        with self._lock:
            entries = list(self._jobs.values())
        groups = []
        for e in entries:
            if e.status == JobStatus.RUNNING and e.proc is not None:
                try:
                    pgid = os.getpgid(e.proc.pid)
                    os.killpg(pgid, signal.SIGTERM)
                    groups.append(pgid)
                except (ProcessLookupError, PermissionError):
                    pass
        deadline = time.monotonic() + SHUTDOWN_WAIT_S
        while groups and time.monotonic() < deadline:
            groups = [g for g in groups if group_members(g)]
            if groups:
                time.sleep(0.05)
        for g in groups:
            try:
                os.killpg(g, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass



def group_members(pgid: int) -> List[int]:
    """Live (not zombie) pids of process group ``pgid``, read from ``/proc``
    (a reaped-late zombie still answers ``killpg(pgid, 0)``)."""
    out = []
    try:
        pids = [int(p) for p in os.listdir("/proc") if p.isdigit()]
    except OSError:
        return out
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # "pid (comm) state ppid pgrp ...": comm may hold spaces
        fields = stat[stat.rfind(")") + 2:].split()
        if len(fields) > 2 and int(fields[2]) == pgid and fields[0] not in ("Z", "X"):
            out.append(pid)
    return out
