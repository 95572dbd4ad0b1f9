"""Weights & Biases logger callback.

The port's copy of ``ray_tpu/air/integrations/wandb.py``, over the port's
``tune/callback.py``; the default experiment or project name stays the
reference's.

Parity: ``python/ray/air/integrations/wandb.py`` (``WandbLoggerCallback``,
``setup_wandb``). With no ``wandb`` package or no network (a host with
zero egress), the callback degrades to wandb's own offline layout: one run
dir per trial with config + history JSONL — uploadable later with
``wandb sync``-style tooling.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from ray_tpu_torch.tune.callback import Callback


def _wandb_or_none():
    try:
        import wandb  # type: ignore

        return wandb
    except ImportError:
        return None


class WandbLoggerCallback(Callback):
    def __init__(self, project: str = "ray_tpu", group: Optional[str] = None, dir: Optional[str] = None, **init_kwargs):
        self.project = project
        self.group = group
        self.dir = dir
        self.init_kwargs = init_kwargs
        self._runs: dict = {}
        self._wandb = _wandb_or_none()

    # ------------------------------------------------------------------
    def _offline_dir(self, trial) -> str:
        base = self.dir or trial.trial_dir
        d = os.path.join(base, "wandb")
        os.makedirs(d, exist_ok=True)
        return d

    def on_trial_start(self, trial) -> None:
        if self._wandb is not None:
            self._runs[trial.trial_id] = self._wandb.init(
                project=self.project,
                group=self.group,
                name=trial.trial_id,
                config=trial.config,
                dir=self.dir,
                mode=os.environ.get("WANDB_MODE", "offline"),
                reinit=True,
                **self.init_kwargs,
            )
        else:
            d = self._offline_dir(trial)
            with open(os.path.join(d, "config.json"), "w") as f:
                json.dump({"project": self.project, "trial": trial.trial_id, "config": trial.config}, f)
            self._runs[trial.trial_id] = open(os.path.join(d, "history.jsonl"), "a")

    def on_trial_result(self, trial, result: dict) -> None:
        run = self._runs.get(trial.trial_id)
        if run is None:
            return
        clean = {k: v for k, v in result.items() if isinstance(v, (int, float, str, bool))}
        if self._wandb is not None:
            run.log(clean)
        else:
            run.write(json.dumps(clean) + "\n")
            run.flush()

    def on_trial_complete(self, trial) -> None:
        self._finish(trial)

    def on_trial_error(self, trial, error) -> None:
        self._finish(trial)

    def _finish(self, trial) -> None:
        run = self._runs.pop(trial.trial_id, None)
        if run is None:
            return
        if self._wandb is not None:
            run.finish()
        else:
            run.close()


def setup_wandb(config: Optional[dict] = None, *, project: str = "ray_tpu", **kwargs):
    """Per-worker wandb init inside a train loop (reference setup_wandb)."""
    wandb = _wandb_or_none()
    if wandb is None:
        return None
    return wandb.init(project=project, config=config, mode=os.environ.get("WANDB_MODE", "offline"), **kwargs)
