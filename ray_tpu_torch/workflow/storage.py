"""Workflow storage: durable per-step results.

The port's copy of ``ray_tpu/workflow/storage.py``; its default base is
``<tmp>/ray_tpu_torch_workflows``, apart from the JAX package's.

Parity: ``python/ray/workflow/workflow_storage.py:229`` — a filesystem
layout of ``<base>/<workflow_id>/steps/<step_key>.pkl`` plus a status file;
fsspec-style remote paths collapse to local dirs here (the reference uses
fsspec for S3/GCS; same layout, pluggable base).
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import tempfile
from typing import Any, Dict, List, Optional

_DEFAULT_BASE = os.path.join(tempfile.gettempdir(), "ray_tpu_torch_workflows")


class WorkflowStorage:
    def __init__(self, base_dir: Optional[str] = None):
        self.base = base_dir or _DEFAULT_BASE
        os.makedirs(self.base, exist_ok=True)

    # ------------------------------------------------------------- layout
    def _wf_dir(self, workflow_id: str) -> str:
        return os.path.join(self.base, workflow_id)

    def _step_path(self, workflow_id: str, step_key: str) -> str:
        return os.path.join(self._wf_dir(workflow_id), "steps", f"{step_key}.pkl")

    # -------------------------------------------------------------- steps
    def has_step(self, workflow_id: str, step_key: str) -> bool:
        return os.path.exists(self._step_path(workflow_id, step_key))

    def save_step(self, workflow_id: str, step_key: str, result: Any) -> None:
        path = self._step_path(workflow_id, step_key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(result, f, protocol=5)
        os.replace(tmp, path)  # atomic commit — half-written steps never count

    def load_step(self, workflow_id: str, step_key: str) -> Any:
        with open(self._step_path(workflow_id, step_key), "rb") as f:
            return pickle.load(f)

    def list_steps(self, workflow_id: str) -> list:
        """Durably-recorded step keys (continuation sub-steps included —
        their keys carry the parent-step prefix path)."""
        root = os.path.join(self._wf_dir(workflow_id), "steps")
        out = []
        for dirpath, _dirs, files in os.walk(root):
            rel = os.path.relpath(dirpath, root)
            for f in files:
                if f.endswith(".pkl"):
                    key = f[: -len(".pkl")]
                    out.append(key if rel == "." else f"{rel}/{key}")
        return sorted(out)

    def clear_steps(self, workflow_id: str) -> None:
        """Drop every durable step for a fresh run() of a reused id —
        replaying another DAG's checkpoints (step keys are topological
        indices) would silently serve its results as this run's."""
        root = os.path.join(self._wf_dir(workflow_id), "steps")
        shutil.rmtree(root, ignore_errors=True)

    # ------------------------------------------------------------- status
    def set_status(self, workflow_id: str, status: str, extra: Optional[dict] = None) -> None:
        os.makedirs(self._wf_dir(workflow_id), exist_ok=True)
        with open(os.path.join(self._wf_dir(workflow_id), "status.json"), "w") as f:
            json.dump({"status": status, **(extra or {})}, f)

    def get_status(self, workflow_id: str) -> Optional[str]:
        path = os.path.join(self._wf_dir(workflow_id), "status.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f).get("status")

    def save_dag(self, workflow_id: str, dag_blob: bytes) -> None:
        os.makedirs(self._wf_dir(workflow_id), exist_ok=True)
        path = os.path.join(self._wf_dir(workflow_id), "dag.pkl")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(dag_blob)
        os.replace(tmp, path)  # atomic — a concurrent load_dag never sees a half-write

    def load_dag(self, workflow_id: str) -> bytes:
        with open(os.path.join(self._wf_dir(workflow_id), "dag.pkl"), "rb") as f:
            return f.read()

    # --------------------------------------------------------------- admin
    def list_workflows(self) -> List[Dict[str, Any]]:
        out = []
        for wid in sorted(os.listdir(self.base)):
            status = self.get_status(wid)
            if status is not None:
                out.append({"workflow_id": wid, "status": status})
        return out

    def delete(self, workflow_id: str) -> None:
        shutil.rmtree(self._wf_dir(workflow_id), ignore_errors=True)
