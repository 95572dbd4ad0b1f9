"""ray_tpu_torch.tune: the Tune session only.

The port has ``tune/session.py`` (``report``, ``get_checkpoint``,
``in_tune_session``), which the trainers report through; the controller,
searchers and schedulers of ``ray_tpu/tune/`` wait for a later slice
(ROADMAP.md, Queue 1).
"""

from ray_tpu_torch.tune.session import get_checkpoint, get_trial_id, in_tune_session, report

__all__ = ["get_checkpoint", "get_trial_id", "in_tune_session", "report"]
