"""Tune experiment callbacks.

The port's copy of ``ray_tpu/tune/callback.py``, whole.

Parity: ``python/ray/tune/callback.py`` — hooks invoked by the controller at
trial lifecycle points; ``air/integrations`` loggers (wandb/mlflow/comet)
plug in here.
"""

from __future__ import annotations

from typing import List


class Callback:
    def on_trial_start(self, trial) -> None:
        pass

    def on_trial_result(self, trial, result: dict) -> None:
        pass

    def on_trial_complete(self, trial) -> None:
        pass

    def on_trial_error(self, trial, error: BaseException) -> None:
        pass

    def on_checkpoint(self, trial, checkpoint) -> None:
        pass

    def on_experiment_end(self, trials: List) -> None:
        pass


class CallbackList:
    """Fan-out wrapper; one misbehaving callback never kills the experiment
    loop (reference: tune's callback errors are logged, not raised)."""

    def __init__(self, callbacks):
        self._callbacks = list(callbacks or [])

    def __iter__(self):
        return iter(self._callbacks)

    def _fire(self, method: str, *args) -> None:
        import logging

        for cb in self._callbacks:
            try:
                getattr(cb, method)(*args)
            except Exception:
                logging.getLogger(__name__).exception(
                    "tune callback %s.%s failed", type(cb).__name__, method
                )

    def on_trial_start(self, trial):
        self._fire("on_trial_start", trial)

    def on_trial_result(self, trial, result):
        self._fire("on_trial_result", trial, result)

    def on_trial_complete(self, trial):
        self._fire("on_trial_complete", trial)

    def on_trial_error(self, trial, error):
        self._fire("on_trial_error", trial, error)

    def on_checkpoint(self, trial, checkpoint):
        self._fire("on_checkpoint", trial, checkpoint)

    def on_experiment_end(self, trials):
        self._fire("on_experiment_end", trials)
