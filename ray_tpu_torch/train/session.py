"""Per-worker training session: context, report channel, dataset shards.

The port's copy of ``ray_tpu/train/session.py``. Every in-process rank is
a thread, so the session stays thread-local. ``get_devices()`` gives the
rank's torch devices (one CUDA device on a card, or the CPU when the
trainer was given ``device="cpu"``) and ``get_mesh()`` a layout-only
:class:`~ray_tpu_torch.parallel.mesh.Mesh` over them, axis ``"data"``.

Parity: ``python/ray/train/_internal/session.py`` — ``train.report(metrics,
checkpoint)`` streams results from workers to the driver;
``train.get_context()`` exposes rank/world-size/etc.;
``train.get_dataset_shard(name)`` hands each worker its Data shard
(``_internal/data_config.py``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

_session_local = threading.local()


@dataclass
class TrainContext:
    world_rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    local_world_size: int = 1
    node_rank: int = 0
    experiment_name: str = "train"
    trial_dir: str = "/tmp"
    devices: List[Any] = field(default_factory=list)
    mesh: Any = None
    # unique per worker-gang attempt; scopes cross-rank rendezvous keys so
    # retries / concurrent same-name runs can never read each other's state
    group_token: str = ""
    # how many times the gang has been rebuilt after a failure (0 on the
    # first attempt): repair-and-resume loops use this to distinguish a
    # fresh run from a restart resuming off train.get_checkpoint()
    restart_count: int = 0

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_world_size(self) -> int:
        return self.world_size

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_local_world_size(self) -> int:
        return self.local_world_size

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_trial_dir(self) -> str:
        return self.trial_dir

    def get_experiment_name(self) -> str:
        return self.experiment_name

    def get_devices(self) -> List[Any]:
        """The torch devices assigned to this worker (its mesh slice)."""
        return self.devices

    def get_mesh(self):
        """This worker's layout-only ``Mesh`` over its assigned devices."""
        return self.mesh

    def get_group_token(self) -> str:
        """Opaque id shared by all ranks of one gang attempt."""
        return self.group_token

    def get_restart_count(self) -> int:
        """0 on the first gang attempt, incremented per repair restart."""
        return self.restart_count


class _Session:
    def __init__(
        self,
        context: TrainContext,
        reporter,
        dataset_shards: Optional[Dict[str, Any]] = None,
        latest_checkpoint=None,
    ):
        self.context = context
        self.reporter = reporter  # callable(rank, metrics, checkpoint)
        self.dataset_shards = dataset_shards or {}
        self.latest_checkpoint = latest_checkpoint


def init_session(session: _Session) -> None:
    _session_local.session = session


def shutdown_session() -> None:
    _session_local.session = None


def get_session() -> Optional[_Session]:
    return getattr(_session_local, "session", None)


def _require_session() -> _Session:
    s = get_session()
    if s is None:
        raise RuntimeError("Not inside a train worker; train.* session APIs require a running Trainer.")
    return s


# ------------------------------------------------------------ public API
def report(metrics: Dict[str, Any], *, checkpoint=None) -> None:
    """Stream metrics (and optionally a checkpoint) to the driver
    (parity: train.report)."""
    s = _require_session()
    s.reporter(s.context.world_rank, dict(metrics), checkpoint)


def get_context() -> TrainContext:
    return _require_session().context


def get_dataset_shard(name: str = "train"):
    s = _require_session()
    if name not in s.dataset_shards:
        raise KeyError(f"no dataset shard named {name!r}; available: {list(s.dataset_shards)}")
    return s.dataset_shards[name]


def get_checkpoint():
    """The checkpoint to resume from, if the trainer was restored
    (parity: train.get_checkpoint)."""
    return _require_session().latest_checkpoint
