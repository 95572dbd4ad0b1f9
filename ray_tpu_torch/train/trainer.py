"""Trainers: BaseTrainer → DataParallelTrainer → DeviceTrainer.

The port's copy of ``ray_tpu/train/trainer.py``. Parity:
``python/ray/train/base_trainer.py`` + ``data_parallel_trainer.py:25``
(worker-group orchestration, per-framework backends, result/checkpoint
plumbing, FailureConfig restarts) and the Train↔Data wiring of
``_internal/data_config.py``.

The flagship trainer, the JAX package's ``JaxTrainer``, is
:class:`DeviceTrainer` here (``JaxTrainer`` raises ``NotPortedError`` that
names it, as ``iter_jax_batches`` names ``iter_device_batches``): its ranks
are in-process actors, each on its own CUDA device (``cuda:0`` for all on
one card), and its gang mode drives a
:class:`~ray_tpu_torch.train.controller.TrainController`. Entry points run
on the card: a trainer given no ``device`` raises without CUDA, and CPU
callers pass ``device="cpu"``.
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.exceptions import RayActorError, RayTaskError, WorkerCrashedError
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.worker_group import WorkerGroup


@dataclass
class Result:
    """What ``Trainer.fit()`` returns (parity: ray.train.Result)."""

    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint]
    path: str
    metrics_dataframe: List[Dict[str, Any]] = field(default_factory=list)
    error: Optional[BaseException] = None
    # the hyperparameter config that produced this result (parity:
    # ray.air.Result.config — Tune fills it; bare Trainer.fit leaves None)
    config: Optional[Dict[str, Any]] = None

    @property
    def best_checkpoints(self) -> List[Checkpoint]:
        return [self.checkpoint] if self.checkpoint else []


class DataConfig:
    """How Datasets are sharded across workers (parity: data_config.py).

    Default: every dataset in ``datasets`` is materialized and split into
    ``num_workers`` row-balanced shards; each worker sees its shard via
    ``train.get_dataset_shard(name)``.
    """

    def __init__(self, datasets_to_split: Optional[List[str]] = None):
        self._datasets_to_split = datasets_to_split

    def configure(self, datasets: Dict[str, Any], num_workers: int) -> List[Dict[str, Any]]:
        shards: List[Dict[str, Any]] = [{} for _ in range(num_workers)]
        for name, ds in (datasets or {}).items():
            split = self._datasets_to_split is None or name in self._datasets_to_split
            if split and num_workers > 1:
                # Row-balanced, not block-greedy: reference Train shards via
                # streaming_split(equal=True), which splits *blocks* when
                # needed — a single-block dataset must not shard [all, 0].
                mat = ds.materialize() if hasattr(ds, "materialize") else ds
                total = mat.count()
                cuts = [(i * total) // num_workers for i in range(1, num_workers)]
                parts = mat.split_at_indices(cuts)
                for i in range(num_workers):
                    shards[i][name] = parts[i]
            else:
                for i in range(num_workers):
                    shards[i][name] = ds
        return shards


class BaseTrainer:
    _worker_execution = "inproc"  # subclass hook (torch gangs need processes)

    def __init__(
        self,
        *,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self.resume_from_checkpoint = resume_from_checkpoint

    def fit(self) -> Result:
        raise NotImplementedError

    def as_trainable(self):
        """Adapt this trainer into a Tune trainable (parity: Trainer→Tune).

        Returns a function trainable: Tune merges the search-space config
        into ``train_loop_config`` and the trainer reports through the Tune
        session.
        """
        trainer = self

        def trainable(config: dict):
            import copy

            t = copy.copy(trainer)
            base = dict(getattr(t, "train_loop_config", None) or {})
            base.update(config)
            t.train_loop_config = base
            result = t.fit()
            # Re-report the terminal metrics into the Tune session if active.
            from ray_tpu_torch.tune.session import report as tune_report, in_tune_session

            if in_tune_session() and result.metrics:
                tune_report(result.metrics, checkpoint=result.checkpoint)
            if result.error is not None:
                raise result.error
            return result.metrics

        trainable.__name__ = type(self).__name__
        return trainable


def release_frames(exc: Optional[BaseException]) -> None:
    """Drop the local variables of the frames a failed attempt's error
    holds, through its causes (``RayTaskError.cause``); the traceback text
    stays in the error.  Without this a rank's device state (a train
    state's params and moments on the card) lives on in the error's
    traceback, through the restart, until the error itself is dropped."""
    import traceback

    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if exc.__traceback__ is not None:
            traceback.clear_frames(exc.__traceback__)
        exc = getattr(exc, "cause", None) or exc.__cause__ or exc.__context__


class DataParallelTrainer(BaseTrainer):
    """Runs ``train_loop_per_worker`` on a gang of workers
    (parity: data_parallel_trainer.py:25). ``device``: where the ranks
    compute, ``"cuda"`` (the default) or ``"cpu"``."""

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[dict] = None,
        dataset_config: Optional[DataConfig] = None,
        device=None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.dataset_config = dataset_config or DataConfig()
        self.device = device
        from ray_tpu_torch.models.common import default_device

        self._device_type = default_device(device, type(self).__name__).type

    def training_iterator(self, *, auto_repair: bool = False) -> "TrainingIterator":
        """Stream rank-0 reports while the gang trains (caller-owned loop);
        ``fit()`` remains the batch path.  ``auto_repair=True`` restarts the
        gang from the best checkpoint on a worker death instead of raising."""
        return TrainingIterator(self, auto_repair=auto_repair)

    # ------------------------------------------------------------------
    def fit(self) -> Result:
        name = self.run_config.name or f"{type(self).__name__}_{int(time.time())}"
        storage = self.run_config.storage_path or os.path.join(tempfile.gettempdir(), "ray_tpu_torch_results")
        trial_dir = os.path.join(storage, name)
        os.makedirs(trial_dir, exist_ok=True)

        max_failures = self.run_config.failure_config.max_failures
        attempt = 0
        latest_checkpoint = self.resume_from_checkpoint
        history: List[Dict[str, Any]] = []
        last_metrics: Dict[str, Any] = {}
        best_checkpoint = latest_checkpoint
        error: Optional[BaseException] = None

        while True:
            group = WorkerGroup(
                self.scaling_config,
                name,
                trial_dir,
                execution=self._worker_execution,
                restart_count=attempt,
                device_type=self._device_type,
            )
            try:
                # a rank that dies while the gang starts is a failure of
                # this attempt, like one that dies mid-run
                group.start()
                shards = self.dataset_config.configure(self.datasets, self.scaling_config.num_workers)
                futures = group.run_async(
                    self.train_loop_per_worker, self.train_loop_config, shards, latest_checkpoint
                )
                # Poll for streamed reports until the gang finishes.
                done_refs: list = []
                pending = list(futures)
                while pending:
                    finished, pending = ray_tpu_torch.wait(pending, num_returns=len(pending), timeout=0.2)
                    # Surface a rank's failure immediately — sibling ranks
                    # blocked in a collective on the dead rank never finish,
                    # so waiting for the full gang would hang fit() forever.
                    if not finished:
                        dead = group.dead_workers()
                        if dead:
                            raise dead[0][1]
                    ray_tpu_torch.get(finished)
                    done_refs.extend(finished)
                    reports, _ = group.poll_all()
                    for rank, metrics, ckpt in reports:
                        if rank == 0:
                            row = dict(metrics)
                            history.append(row)
                            last_metrics = row
                        if ckpt is not None and rank == 0:
                            best_checkpoint = ckpt
                            latest_checkpoint = ckpt
                # surface worker exceptions
                ray_tpu_torch.get(done_refs)
                reports, _ = group.poll_all()
                for rank, metrics, ckpt in reports:
                    if rank == 0:
                        history.append(dict(metrics))
                        last_metrics = dict(metrics)
                        if ckpt is not None:
                            best_checkpoint = ckpt
                            latest_checkpoint = ckpt
                error = None
                break
            except (RayTaskError, RayActorError, WorkerCrashedError) as exc:
                release_frames(exc)
                attempt += 1
                error = exc
                if max_failures != -1 and attempt > max_failures:
                    break
                # restart the gang from the latest checkpoint
            finally:
                group.shutdown()

        return Result(
            metrics=last_metrics,
            checkpoint=best_checkpoint,
            path=trial_dir,
            metrics_dataframe=history,
            error=error,
        )


class TrainingIterator:
    """Streamed per-report iteration over a training-gang run
    (reference: train/trainer.py TrainingIterator — the internal iterator
    fit() drains).  Yields rank-0 report rows as they arrive; ``result()``
    afterwards returns the terminal :class:`Result`.

    Fault contract: a gang member that dies mid-step (``kill -9`` included)
    surfaces as the **typed** error — ``ActorDiedError`` /
    ``WorkerCrashedError`` — never a hang.  The rank-0 drain loop probes the
    control plane's actor table between waits, so a rank whose run future
    can no longer resolve is converted to its typed death immediately.
    With ``auto_repair=True`` the death instead restarts the gang from the
    best checkpoint seen so far (repair budget:
    ``run_config.failure_config.max_failures``, 0 meaning a small default);
    otherwise the typed error is raised to the caller."""

    def __init__(self, trainer: "DataParallelTrainer", *, auto_repair: bool = False):
        self._trainer = trainer
        self._auto_repair = auto_repair
        self._result: Optional[Result] = None

    def __iter__(self):
        t = self._trainer
        name = t.run_config.name or f"{type(t).__name__}_{int(time.time())}"
        storage = t.run_config.storage_path or os.path.join(tempfile.gettempdir(), "ray_tpu_torch_results")
        trial_dir = os.path.join(storage, name)
        os.makedirs(trial_dir, exist_ok=True)
        history: List[Dict[str, Any]] = []
        last_metrics: Dict[str, Any] = {}
        best_checkpoint = t.resume_from_checkpoint
        error: Optional[BaseException] = None
        max_failures = t.run_config.failure_config.max_failures
        repairs_left = (max_failures if max_failures > 0 else 3) if max_failures != -1 else -1

        attempt = 0
        try:
            while True:
                group = WorkerGroup(
                    t.scaling_config,
                    name,
                    trial_dir,
                    execution=t._worker_execution,
                    restart_count=attempt,
                    device_type=t._device_type,
                )

                def drain_rank0(group=group):
                    # one drain of the group's buffered reports -> rank-0 rows
                    reports, _ = group.poll_all()
                    for rank, metrics, ckpt in reports:
                        if rank != 0:
                            continue
                        row = dict(metrics)
                        history.append(row)
                        nonlocal last_metrics, best_checkpoint
                        last_metrics = row
                        if ckpt is not None:
                            best_checkpoint = ckpt
                        yield row

                try:
                    # a rank that dies while the gang starts is this
                    # attempt's typed error, recorded in the result
                    group.start()
                    shards = t.dataset_config.configure(
                        t.datasets, t.scaling_config.num_workers
                    )
                    futures = group.run_async(
                        t.train_loop_per_worker, t.train_loop_config, shards, best_checkpoint
                    )
                    pending = list(futures)
                    done_refs: list = []
                    while pending:
                        finished, pending = ray_tpu_torch.wait(
                            pending, num_returns=len(pending), timeout=0.2
                        )
                        if not finished:
                            # Liveness guard: a DEAD rank whose future is
                            # still pending (siblings blocked on it in a
                            # collective) must raise typed, not hang.
                            dead = group.dead_workers()
                            if dead:
                                raise dead[0][1]
                        ray_tpu_torch.get(finished)
                        done_refs.extend(finished)
                        yield from drain_rank0()
                    ray_tpu_torch.get(done_refs)
                    yield from drain_rank0()
                    error = None
                    break
                except (RayTaskError, RayActorError, WorkerCrashedError) as exc:
                    release_frames(exc)
                    error = exc
                    if not self._auto_repair:
                        break
                    if repairs_left == 0:
                        break
                    if repairs_left > 0:
                        repairs_left -= 1
                    attempt += 1
                    # repair: restart the gang from the best checkpoint
                finally:
                    group.shutdown()
        finally:
            self._result = Result(
                metrics=last_metrics,
                checkpoint=best_checkpoint,
                path=trial_dir,
                metrics_dataframe=history,
                error=error,
            )
        if error is not None:
            raise error

    def result(self) -> Result:
        if self._result is None:
            raise RuntimeError("iterate the TrainingIterator to completion first")
        return self._result


class DeviceTrainer(DataParallelTrainer):
    """The flagship trainer (the JAX package's ``JaxTrainer``): the worker
    gang shares the node's cards, each rank on its own CUDA device
    (``train.get_context().get_devices()``); the user loop builds its step
    there, e.g. ``make_train_step(cfg, device=ctx.get_devices()[0])``.

    Two modes:

    * **user-loop mode** (``train_loop_per_worker`` given): the classic
      DataParallelTrainer path — the loop runs on every rank of a
      :class:`WorkerGroup` gang.
    * **gang mode** (``train_loop_per_worker=None`` and ``gang=dict(...)``):
      the data-parallel step compiles to a plan whose training stage is a
      ``StageGroup`` gang driven by a
      :class:`~ray_tpu_torch.train.controller.TrainController` — repairable
      (member death → BROKEN → repair, bit-exact resume from the latest
      step checkpoint), elastic (autoscaler grow/shrink), and preemptible
      by serving bursts.  ``gang`` keys are TrainController kwargs
      (``world_size``, ``batch_size``, ``feature_dim``, ``seed``, ...;
      the trainer's ``device`` unless they name one)
      plus an optional ``num_steps``; a ``datasets={"train": ds}`` entry
      feeds the gang from the streaming Dataset executor.  Whether a
      mid-run member death auto-repairs follows
      ``run_config.failure_config.max_failures`` (0 → the typed error
      propagates into ``Result.error``).  The controller stays alive after
      ``fit()`` as ``self.controller`` for status/resize/shutdown.
    """

    def __init__(
        self,
        train_loop_per_worker: Optional[Callable] = None,
        *,
        gang: Optional[dict] = None,
        num_steps: Optional[int] = None,
        **kwargs,
    ):
        if train_loop_per_worker is None and gang is None:
            raise ValueError(
                "DeviceTrainer needs either train_loop_per_worker (user-loop "
                "mode) or gang=dict(...) (compiled StageGroup gang mode)"
            )
        self.gang = dict(gang) if gang is not None else None
        self.num_steps = num_steps
        self.controller = None  # set by gang-mode fit()
        super().__init__(train_loop_per_worker, **kwargs)

    def fit(self) -> Result:
        if self.train_loop_per_worker is not None:
            return super().fit()
        from ray_tpu_torch.train.controller import TrainController

        name = self.run_config.name or f"DeviceTrainer_{int(time.time())}"
        spec = dict(self.gang or {})
        spec.setdefault("device", self.device)
        num_steps = int(
            self.num_steps
            if self.num_steps is not None
            else spec.pop("num_steps", 10)
        )
        spec.pop("num_steps", None)
        if self.datasets and "dataset" not in spec:
            spec["dataset"] = self.datasets.get("train")
        ctl = self.controller = TrainController(name, **spec)
        auto_repair = self.run_config.failure_config.max_failures != 0
        error: Optional[BaseException] = None
        try:
            ctl.run(num_steps, auto_repair=auto_repair)
            ctl.save_checkpoint()
        except (RayTaskError, RayActorError, WorkerCrashedError) as exc:
            error = exc
        losses = ctl.losses()
        ckpt_dir = os.path.dirname(ctl.checkpoint_path)
        return Result(
            metrics={
                "step": ctl.step_count,
                "loss": losses[-1] if losses else None,
                "world_size": ctl.world_size,
            },
            checkpoint=Checkpoint(ckpt_dir) if ctl.last_checkpoint else None,
            path=ckpt_dir,
            metrics_dataframe=[
                {"step": i + 1, "loss": loss} for i, loss in enumerate(losses)
            ],
            error=error,
        )


class JaxTrainer:
    """The JAX package's trainer: JAX is not in the port, whose trainer
    is :class:`DeviceTrainer` (the same two modes, ranks on CUDA)."""

    def __init__(self, *args, **kwargs):
        from ray_tpu_torch.exceptions import NotPortedError

        raise NotPortedError("JaxTrainer (use DeviceTrainer: its ranks train on CUDA)",
                             "ray_tpu/train/trainer.py:350")


# TorchTrainer lives in ray_tpu_torch.train.torch (full gloo process-group
# backend over process-actor gangs); imported at the bottom for the
# historical `ray_tpu_torch.train.trainer.TorchTrainer` path.


from ray_tpu_torch.train.torch import TorchTrainer  # noqa: E402
