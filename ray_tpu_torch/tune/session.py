"""Per-trial Tune session (function-trainable API).

The port's copy of ``ray_tpu/tune/session.py``, whole: the rest of
``tune/`` waits for a later slice; ``train.trainer`` reaches this module's
``report`` and ``in_tune_session``.

Parity: ``python/ray/tune`` session — ``tune.report(metrics, checkpoint=)``
inside a function trainable, cooperative early-stopping (the reference stops
function trainables between reports), and resume via ``get_checkpoint``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

_trial_local = threading.local()


class TrialInterrupt(BaseException):
    """Raised inside a trainable when the scheduler stops the trial early.

    BaseException so user ``except Exception`` blocks don't swallow it
    (same trick as the reference's cooperative stop)."""


class _TuneSession:
    def __init__(self, trial_id: str, reporter, latest_checkpoint=None):
        self.trial_id = trial_id
        self.reporter = reporter          # callable(metrics, checkpoint)
        self.latest_checkpoint = latest_checkpoint
        self.stop_requested = False


def init_trial_session(session: _TuneSession) -> None:
    _trial_local.session = session


def shutdown_trial_session() -> None:
    _trial_local.session = None


def get_trial_session() -> Optional[_TuneSession]:
    return getattr(_trial_local, "session", None)


def in_tune_session() -> bool:
    return get_trial_session() is not None


def report(metrics: Dict[str, Any], *, checkpoint=None) -> None:
    s = get_trial_session()
    if s is None:
        raise RuntimeError("tune.report() called outside a Tune trial")
    s.reporter(dict(metrics), checkpoint)
    if s.stop_requested:
        raise TrialInterrupt()


def get_checkpoint():
    s = get_trial_session()
    return s.latest_checkpoint if s else None


def get_trial_id() -> Optional[str]:
    s = get_trial_session()
    return s.trial_id if s else None
