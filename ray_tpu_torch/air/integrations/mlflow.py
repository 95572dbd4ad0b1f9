"""MLflow logger callback.

The port's copy of ``ray_tpu/air/integrations/mlflow.py``, over the port's
``tune/callback.py``; the default experiment or project name stays the
reference's.

Parity: ``python/ray/air/integrations/mlflow.py`` (``MLflowLoggerCallback``,
``setup_mlflow``). Uses a file-store tracking URI by default (works with
zero egress); without the ``mlflow`` package the callback writes the same
params/metrics layout as a plain file store.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from ray_tpu_torch.tune.callback import Callback


def _mlflow_or_none():
    try:
        import mlflow  # type: ignore

        return mlflow
    except ImportError:
        return None


class MLflowLoggerCallback(Callback):
    def __init__(
        self,
        tracking_uri: Optional[str] = None,
        experiment_name: str = "ray_tpu",
        save_artifact: bool = False,
    ):
        self.tracking_uri = tracking_uri
        self.experiment_name = experiment_name
        self.save_artifact = save_artifact
        self._mlflow = _mlflow_or_none()
        self._runs: dict = {}

    def _store_dir(self, trial) -> str:
        base = (self.tracking_uri or "").removeprefix("file:") or trial.trial_dir
        d = os.path.join(base, "mlruns", self.experiment_name, trial.trial_id)
        os.makedirs(d, exist_ok=True)
        return d

    def on_trial_start(self, trial) -> None:
        if self._mlflow is not None:
            if self.tracking_uri:
                self._mlflow.set_tracking_uri(self.tracking_uri)
            self._mlflow.set_experiment(self.experiment_name)
            run = self._mlflow.start_run(run_name=trial.trial_id, nested=True)
            self._mlflow.log_params(
                {k: v for k, v in trial.config.items() if isinstance(v, (int, float, str, bool))}
            )
            self._runs[trial.trial_id] = run
        else:
            d = self._store_dir(trial)
            with open(os.path.join(d, "params.json"), "w") as f:
                json.dump(trial.config, f, default=str)
            self._runs[trial.trial_id] = d

    def on_trial_result(self, trial, result: dict) -> None:
        run = self._runs.get(trial.trial_id)
        if run is None:
            return
        metrics = {k: float(v) for k, v in result.items() if isinstance(v, (int, float))}
        if self._mlflow is not None:
            self._mlflow.log_metrics(metrics, step=int(result.get("training_iteration", 0)))
        else:
            with open(os.path.join(run, "metrics.jsonl"), "a") as f:
                f.write(json.dumps({"ts": time.time(), **metrics}) + "\n")

    def on_trial_complete(self, trial) -> None:
        self._finish(trial, "FINISHED")

    def on_trial_error(self, trial, error) -> None:
        self._finish(trial, "FAILED")

    def _finish(self, trial, status: str) -> None:
        run = self._runs.pop(trial.trial_id, None)
        if run is None:
            return
        if self._mlflow is not None:
            self._mlflow.end_run(status=status)
        else:
            with open(os.path.join(run, "status"), "w") as f:
                f.write(status)


def setup_mlflow(config: Optional[dict] = None, *, experiment_name: str = "ray_tpu", tracking_uri: Optional[str] = None, **_kw):
    """Per-worker mlflow setup inside a train loop (reference setup_mlflow)."""
    mlflow = _mlflow_or_none()
    if mlflow is None:
        return None
    if tracking_uri:
        mlflow.set_tracking_uri(tracking_uri)
    mlflow.set_experiment(experiment_name)
    if config:
        mlflow.log_params({k: v for k, v in config.items() if isinstance(v, (int, float, str, bool))})
    return mlflow
