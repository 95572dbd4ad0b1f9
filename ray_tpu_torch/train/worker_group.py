"""WorkerGroup: the gang of training-worker actors.

The port's copy of ``ray_tpu/train/worker_group.py``. Parity:
``python/ray/train/_internal/worker_group.py:102`` (actor group with
``execute``/``execute_async``) + ``_internal/backend_executor.py:66``
(start, rendezvous, start_training, fault handling).

The device seam: the JAX package pins each rank to a slice of
``jax.devices()`` and builds its mesh there. Here a rank computes on
``cuda:(rank × devices_per_worker) % device_count`` (every rank shares
``cuda:0`` on one card) or, when the trainer was given ``device="cpu"``, on
the CPU; its context holds that torch device and a layout-only
:class:`~ray_tpu_torch.parallel.mesh.Mesh` over it, axis ``"data"``. Ranks
are in-process actors (threads of the driver) unless the trainer asks for
processes (``TorchTrainer``: one gloo world of spawned processes, which see
the card when the ranks ask for a GPU).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.train.config import ScalingConfig
from ray_tpu_torch.train.session import TrainContext, _Session, init_session, shutdown_session


def rank_devices(rank: int, devices_per_worker: float, device_type: str) -> list:
    """The torch devices of ``rank``: ``max(1, int(devices_per_worker))``
    CUDA devices from ``(rank × that) % device_count``, wrapping around the
    cards (a fractional share and an oversubscribed gang share them), or
    the CPU."""
    import torch

    if device_type != "cuda":
        return [torch.device(device_type)]
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("a CUDA train rank on a process that sees no CUDA device")
    n = max(1, int(devices_per_worker))
    lo = (rank * n) % count
    return [torch.device("cuda", (lo + i) % count) for i in range(n)]


@ray_tpu_torch.remote
class TrainWorkerActor:
    """One rank of the training gang (parity: worker_group.py RayTrainWorker)."""

    def __init__(
        self,
        rank: int,
        world_size: int,
        devices_per_worker: float,
        experiment_name: str,
        trial_dir: str,
        device_type: str = "cuda",
        group_token: str = "",
        restart_count: int = 0,
    ):
        import numpy as np

        from ray_tpu_torch.parallel.mesh import Mesh

        self.rank = rank
        self.world_size = world_size
        self.experiment_name = experiment_name
        self.trial_dir = trial_dir
        self._reports: List[Tuple[dict, Any]] = []
        self._reports_lock = threading.Lock()
        self._done = False
        self._error: Optional[BaseException] = None
        self._result: Any = None

        self.devices = rank_devices(rank, devices_per_worker, device_type)
        # a layout only: the rank's device indices (a process group, where
        # the loop joins one, comes later than the actor)
        mesh = Mesh(np.asarray([d.index or 0 for d in self.devices]), ("data",))
        self.context = TrainContext(
            world_rank=rank,
            world_size=world_size,
            local_rank=rank,
            local_world_size=world_size,
            experiment_name=experiment_name,
            trial_dir=trial_dir,
            devices=list(self.devices),
            mesh=mesh,
            group_token=group_token,
            restart_count=restart_count,
        )

    # ------------------------------------------------------------ running
    def run(self, fn: Callable, config: dict, dataset_shards: dict, latest_checkpoint) -> Any:
        def reporter(rank, metrics, checkpoint):
            with self._reports_lock:
                self._reports.append((metrics, checkpoint))

        init_session(_Session(self.context, reporter, dataset_shards, latest_checkpoint))
        try:
            import inspect

            import torch

            if self.devices[0].type == "cuda":
                # the rank's kernels and allocations land on its card
                torch.cuda.set_device(self.devices[0])
            takes_config = bool(inspect.signature(fn).parameters)
            result = fn(config or {}) if takes_config else fn()
            self._result = result
            return result
        except BaseException as exc:  # noqa: BLE001
            self._error = exc
            raise
        finally:
            self._done = True
            shutdown_session()

    # ------------------------------------------------------------ polling
    def poll(self) -> Tuple[List[Tuple[dict, Any]], bool]:
        """Drain buffered (metrics, checkpoint) reports; returns (reports, done)."""
        with self._reports_lock:
            out, self._reports = self._reports, []
        return out, self._done

    def ping(self) -> str:
        return "ok"


class WorkerGroup:
    def __init__(
        self,
        scaling: ScalingConfig,
        experiment_name: str,
        trial_dir: str,
        execution: str = "inproc",
        restart_count: int = 0,
        device_type: str = "cuda",
    ):
        self.scaling = scaling
        self.experiment_name = experiment_name
        self.trial_dir = trial_dir
        self.execution = execution  # "inproc": threads of this process;
                                    # "process": one spawned process a rank
        self.device_type = device_type
        import uuid

        # fresh per group (= per fit attempt): scopes rank rendezvous keys
        self.group_token = uuid.uuid4().hex
        self.restart_count = restart_count
        self.workers: List[Any] = []

    def worker_resources(self) -> dict:
        """The scaling config's demand; a CUDA rank that names no GPU asks
        for ``min(devices_per_worker, cards / workers)`` of them, rounded
        down to the scheduler's milli-units, so the whole gang fits the
        node's cards (a share of one on one card)."""
        from ray_tpu_torch.core.resources import SCALE

        res = self.scaling.worker_resources()
        if self.device_type == "cuda" and "GPU" not in res:
            cards = ray_tpu_torch.cluster_resources().get("GPU", 0) or 1
            res["GPU"] = min(self.scaling.num_devices_per_worker,
                             (SCALE * cards // max(1, self.scaling.num_workers)) / SCALE)
        return res

    def start(self) -> None:
        n = self.scaling.num_workers
        resources = self.worker_resources()
        self.workers = [
            TrainWorkerActor.options(
                resources=resources,
                execution=self.execution,
                max_concurrency=4,
            ).remote(
                rank,
                n,
                self.scaling.num_devices_per_worker,
                self.experiment_name,
                self.trial_dir,
                device_type=self.device_type,
                group_token=self.group_token,
                restart_count=self.restart_count,
            )
            for rank in range(n)
        ]
        ray_tpu_torch.get([w.ping.remote() for w in self.workers])

    def run_async(self, fn: Callable, config: dict, dataset_shards: List[dict], latest_checkpoint) -> List[Any]:
        return [
            w.run.remote(fn, config, dataset_shards[i] if dataset_shards else {}, latest_checkpoint)
            for i, w in enumerate(self.workers)
        ]

    def dead_workers(self) -> List[Tuple[int, BaseException]]:
        """Ranks the control plane declares DEAD, with the typed error a
        caller should surface.  The liveness guard of the rank-0 drain
        path: a ``kill -9``'d rank whose run future has not resolved yet
        must become a typed :class:`ActorDiedError`, never a hang."""
        from ray_tpu_torch.exceptions import ActorDiedError
        from ray_tpu_torch.runtime.control import ActorState

        cluster = ray_tpu_torch.get_cluster()
        out: List[Tuple[int, BaseException]] = []
        for rank, w in enumerate(self.workers):
            info = cluster.control.actors.get(w._actor_id)
            if info is not None and info.state is ActorState.DEAD:
                out.append(
                    (
                        rank,
                        ActorDiedError(
                            w._actor_id,
                            info.death_cause
                            or f"train worker rank {rank} died mid-run",
                        ),
                    )
                )
        return out

    def poll_all(self) -> Tuple[List[Tuple[int, dict, Any]], bool]:
        """Gather new reports from every rank; done only when all ranks done."""
        reports: List[Tuple[int, dict, Any]] = []
        all_done = True
        for rank, w in enumerate(self.workers):
            worker_reports, done = ray_tpu_torch.get(w.poll.remote())
            for metrics, ckpt in worker_reports:
                reports.append((rank, metrics, ckpt))
            all_done = all_done and done
        return reports, all_done

    def shutdown(self) -> None:
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []
