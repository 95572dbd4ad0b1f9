"""Trial + TuneController: the experiment event loop.

The port's copy of ``ray_tpu/tune/controller.py``.  One divergence, at the
device seam (ROADMAP.md, Queue 3): a trial's ``"GPU"`` resource makes its
runner an in-process GPU actor (``num_gpus``), and a trial that asks for a
GPU on a cluster without one raises at its start instead of waiting; a
``"TPU"`` resource keeps the JAX package's meaning (``num_tpus``).  One
repair (F18): the loop does not wait for a new trial's runner to exist,
and drains a runner only once it does.  The JAX package waits
(``ray_tpu/tune/controller.py:244``), and a trial whose share is held by a
stopped trial's runner, which only this loop reaps, then waits for ever.

Parity: ``python/ray/tune/execution/tune_controller.py:68`` (controller
managing ``Trial`` actors, stepping schedulers/searchers on every result)
and ``python/ray/tune/experiment/trial.py:247`` (trial state machine).

Trials run as **in-process actors** (threads) so nested submissions work —
a trial that is itself a Trainer spawns its worker gang through the same
fabric (Train-on-Tune, exactly how the reference layers them).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.exceptions import RayActorError, RayTaskError, WorkerCrashedError
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.tune import schedulers as sched_mod
from ray_tpu_torch.tune.schedulers import CONTINUE, STOP, FIFOScheduler, TrialScheduler
from ray_tpu_torch.tune.search import BasicVariantGenerator, Searcher
from ray_tpu_torch.tune.session import TrialInterrupt, _TuneSession, init_trial_session, shutdown_trial_session

PENDING = "PENDING"
RUNNING = "RUNNING"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


class Trial:
    def __init__(self, trial_id: str, config: dict, trial_dir: str):
        self.trial_id = trial_id
        self.config = config
        self.trial_dir = trial_dir
        self.status = PENDING
        self.last_result: Dict[str, Any] = {}
        self.history: List[Dict[str, Any]] = []
        self.latest_checkpoint: Optional[Checkpoint] = None
        self.error: Optional[BaseException] = None
        self.actor = None
        self.future = None
        self.ready = None  # the runner's first call: done once the runner exists
        self.num_restarts = 0

    def __repr__(self) -> str:
        return f"Trial({self.trial_id}, {self.status}, result={self.last_result})"


@ray_tpu_torch.remote
class TrialRunnerActor:
    """Hosts one trial's function trainable; buffers its reports."""

    def __init__(self, trial_id: str):
        self.trial_id = trial_id
        self._reports: List = []
        self._lock = threading.Lock()
        self._session: Optional[_TuneSession] = None
        self._done = False

    def run(self, fn: Callable, config: dict, latest_checkpoint) -> Optional[dict]:
        def reporter(metrics, checkpoint):
            with self._lock:
                self._reports.append((metrics, checkpoint))

        session = _TuneSession(self.trial_id, reporter, latest_checkpoint)
        self._session = session
        init_trial_session(session)
        try:
            final = fn(config)
            if isinstance(final, dict):
                reporter(final, None)
            return final if isinstance(final, dict) else None
        except TrialInterrupt:
            return None
        finally:
            self._done = True
            shutdown_trial_session()

    def poll(self):
        with self._lock:
            out, self._reports = self._reports, []
        return out, self._done

    def request_stop(self) -> None:
        if self._session is not None:
            self._session.stop_requested = True

    def ping(self) -> str:
        return "ok"


class TuneController:
    def __init__(
        self,
        trainable: Callable,
        *,
        searcher: Searcher,
        scheduler: Optional[TrialScheduler] = None,
        metric: Optional[str] = None,
        mode: str = "max",
        max_concurrent_trials: int = 4,
        experiment_dir: Optional[str] = None,
        max_failures_per_trial: int = 0,
        callbacks=None,
        num_samples: Optional[int] = None,
        stop=None,
    ):
        # stop criteria: {"metric": threshold} dict or a tune.Stopper
        # (checked per result, before the scheduler's own decision)
        self.stop = stop
        self.trainable = trainable
        self.searcher = searcher
        self.scheduler = scheduler or FIFOScheduler()
        self.scheduler.set_search_properties(metric, mode)
        if hasattr(self.scheduler, "_controller"):
            # ResourceChangingScheduler's allocation fn reads trial states
            self.scheduler._controller = self
        if getattr(self.scheduler, "metric", None) is None:
            self.scheduler.metric = metric
        self.metric = metric
        self.mode = mode
        self.max_concurrent = max_concurrent_trials
        self.experiment_dir = experiment_dir or os.path.join(tempfile.gettempdir(), f"tune_{uuid.uuid4().hex[:8]}")
        os.makedirs(self.experiment_dir, exist_ok=True)
        self.trials: List[Trial] = []
        self.max_failures_per_trial = max_failures_per_trial
        # Trial budget for suggesting searchers (a TPE-style searcher never
        # exhausts on its own; BasicVariantGenerator self-limits, so the
        # tuner passes None for it).
        self.num_samples = num_samples
        from ray_tpu_torch.tune.callback import CallbackList

        self.callbacks = CallbackList(callbacks)

    # ---------------------------------------------------- resume support
    STATE_FILE = "experiment_state.pkl"

    def _save_experiment_state(self) -> None:
        """Persist per-trial progress for Tuner.restore (parity role:
        the reference's experiment-state snapshots in the experiment dir).
        Atomic replace so an interrupt mid-write never corrupts the file."""
        import pickle

        rows = []
        for t in self.trials:
            rows.append(
                {
                    "trial_id": t.trial_id,
                    "config": t.config,
                    "status": t.status,
                    "last_result": t.last_result,
                    "history": t.history,
                    "checkpoint_path": (
                        t.latest_checkpoint.path if t.latest_checkpoint else None
                    ),
                    "error": repr(t.error) if t.error is not None else None,
                }
            )
        path = os.path.join(self.experiment_dir, self.STATE_FILE)
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                pickle.dump({"trials": rows}, f)
            os.replace(tmp, path)
        except Exception:  # noqa: BLE001 — incl. unpicklable configs/results
            # state saving must never kill the experiment
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def preseed(self, rows: List[dict]) -> None:
        """Seed restored trials before run(): finished ones keep their
        results (and feed the searcher's history); unfinished ones are
        rescheduled PENDING, resuming from their latest checkpoint."""
        for row in rows:
            trial = Trial(
                row["trial_id"], row["config"],
                os.path.join(self.experiment_dir, row["trial_id"]),
            )
            os.makedirs(trial.trial_dir, exist_ok=True)
            if row.get("checkpoint_path"):
                trial.latest_checkpoint = Checkpoint(row["checkpoint_path"])
            trial.last_result = row.get("last_result") or {}
            trial.history = row.get("history") or []
            if row["status"] == TERMINATED:
                trial.status = TERMINATED
            elif row["status"] == ERROR:
                # errored trials stay errored (reference semantics without
                # resume_errored): re-running a deterministic failure on
                # every restore would silently burn retries
                trial.status = ERROR
                if row.get("error"):
                    trial.error = RuntimeError(row["error"])
            else:
                trial.status = PENDING
            # the restore hook advances deterministic cursors (grids resume
            # at the next point) and feeds completed (config, result) pairs
            # to model-based searchers — see Searcher.on_restore
            restore = getattr(self.searcher, "on_restore", None)
            if restore is not None:
                restore(
                    trial.trial_id,
                    trial.config,
                    trial.last_result,
                    completed=trial.status == TERMINATED,
                )
            self.trials.append(trial)

    # ------------------------------------------------------------------
    def _make_trial(self) -> Optional[Trial]:
        if self.num_samples is not None and len(self.trials) >= self.num_samples:
            return None
        trial_id = f"trial_{len(self.trials):05d}"
        config = self.searcher.suggest(trial_id)
        if config is None:
            return None
        trial = Trial(trial_id, config, os.path.join(self.experiment_dir, trial_id))
        os.makedirs(trial.trial_dir, exist_ok=True)
        self.trials.append(trial)
        return trial

    def _start_trial(self, trial: Trial, checkpoint: Optional[Checkpoint] = None) -> None:
        # with_resources() attaches per-trial requirements to the trainable
        # (parity: tune.with_resources -> PlacementGroupFactory head bundle);
        # a per-TRIAL override (ResourceChangingScheduler) wins over it
        res = dict(getattr(self.trainable, "_tune_resources", None) or {})
        # merge, don't replace: a CPU-only reallocation must not drop the
        # trainable's accelerator reservations
        res.update(getattr(trial, "resources", None) or {})
        opts: dict = {"execution": "inproc", "max_concurrency": 4}
        if res:
            opts["num_cpus"] = res.pop("CPU", 1)
            if "TPU" in res:
                opts["num_tpus"] = res.pop("TPU")
            if "GPU" in res:
                opts["num_gpus"] = _gpu_share(res.pop("GPU"))
            if res:
                opts["resources"] = res
        trial.actor = TrialRunnerActor.options(**opts).remote(trial.trial_id)
        # no wait for the runner here, nor in the drain below: it may wait
        # for resources that a stopped trial's runner holds until this loop
        # reaps it (F18)
        trial.ready = trial.actor.ping.remote()
        trial.future = trial.actor.run.remote(self.trainable, trial.config, checkpoint or trial.latest_checkpoint)
        trial.status = RUNNING
        self.callbacks.on_trial_start(trial)

    def _stop_trial(self, trial: Trial, status: str = TERMINATED) -> None:
        if trial.actor is not None:
            try:
                ray_tpu_torch.get(trial.actor.request_stop.remote())
            except Exception:
                pass
        trial.status = status

    def _finalize_trial(self, trial: Trial) -> None:
        try:
            ray_tpu_torch.get(trial.future)
            trial.status = TERMINATED
        except (RayTaskError, RayActorError, WorkerCrashedError) as exc:
            if trial.num_restarts < self.max_failures_per_trial:
                trial.num_restarts += 1
                if trial.actor is not None:
                    try:
                        ray_tpu_torch.kill(trial.actor)
                    except Exception:
                        pass
                self._start_trial(trial)
                return
            trial.status = ERROR
            trial.error = exc
        finally:
            if trial.status != RUNNING and trial.actor is not None:
                try:
                    ray_tpu_torch.kill(trial.actor)
                except Exception:
                    pass
                trial.actor = None
        self.searcher.on_trial_complete(trial.trial_id, trial.last_result, error=trial.status == ERROR)
        self.scheduler.on_trial_complete(trial, trial.last_result)
        if trial.status == ERROR:
            self.callbacks.on_trial_error(trial, trial.error)
        else:
            self.callbacks.on_trial_complete(trial)
        self._write_trial_state(trial)
        self._save_experiment_state()

    def _stop_criteria_met(self, trial: Trial, metrics: dict) -> bool:
        if self.stop is None:
            return False
        if isinstance(self.stop, dict):
            return any(k in metrics and metrics[k] >= v for k, v in self.stop.items())
        if callable(self.stop):  # tune.Stopper (or bare callable)
            if bool(getattr(self.stop, "stop_all", lambda: False)()):
                # experiment-wide stop: every trial, not just the reporter
                self._stop_all = True
                return True
            return self.stop(trial.trial_id, metrics)
        return False

    def _drain_reports(self, trials: List[Trial]) -> None:
        """Collect buffered reports from every running trial, then feed the
        scheduler in global iteration order — otherwise whichever trial is
        drained first reaches every ASHA rung unopposed and async halving
        never prunes (drain-order bias)."""
        merged: List[tuple] = []
        for trial in trials:
            if trial.actor is None:
                continue
            if not ray_tpu_torch.wait([trial.ready, trial.future], num_returns=1, timeout=0)[0]:
                continue  # its runner waits for resources: nothing to drain yet
            reports, _ = ray_tpu_torch.get(trial.actor.poll.remote())
            for metrics, ckpt in reports:
                metrics.setdefault("training_iteration", len(trial.history) + 1)
                metrics["trial_id"] = trial.trial_id
                trial.history.append(metrics)
                merged.append((trial, metrics, ckpt))
        merged.sort(key=lambda r: r[1].get("training_iteration", 0))
        for trial, metrics, ckpt in merged:
            trial.last_result = metrics
            if ckpt is not None:
                trial.latest_checkpoint = ckpt
                self.callbacks.on_checkpoint(trial, ckpt)
            self.callbacks.on_trial_result(trial, metrics)
            self.searcher.on_trial_result(trial.trial_id, metrics)
            if trial.status != RUNNING:
                continue
            if self._stop_criteria_met(trial, metrics):
                self._stop_trial(trial)
                continue
            decision = self.scheduler.on_trial_result(trial, metrics)
            if decision == STOP:
                self._stop_trial(trial)
            elif hasattr(self.scheduler, "at_perturbation_boundary") and self.scheduler.at_perturbation_boundary(metrics):
                target = self.scheduler.exploit_target(trial)
                if target is not None:
                    new_cfg, donor_ckpt = target
                    self._stop_trial(trial, status=RUNNING)  # request stop; restart below
                    # Bounded wait: the interrupt lands at the trial's next
                    # report — never stall the whole controller on a slow one.
                    done, _ = ray_tpu_torch.wait([trial.future], num_returns=1, timeout=2.0)
                    if done:
                        try:
                            ray_tpu_torch.get(trial.future)
                        except Exception:
                            pass
                    try:
                        ray_tpu_torch.kill(trial.actor)
                    except Exception:
                        pass
                    trial.config = new_cfg
                    self._start_trial(trial, checkpoint=donor_ckpt)

    # ------------------------------------------------------------------
    def run(self) -> List[Trial]:
        """The experiment loop (parity: TuneController.step cycle).

        State is snapshotted in a finally block so an interrupt — the very
        scenario Tuner.restore exists for — still leaves a resumable
        experiment_state.pkl behind."""
        try:
            return self._run()
        finally:
            self._save_experiment_state()

    def _run(self) -> List[Trial]:
        self._stop_all = False
        while True:
            running = [t for t in self.trials if t.status == RUNNING]
            if self._stop_all:
                # a Stopper.stop_all() fired: stop every running trial and
                # start nothing further — pending trials never launch
                for t in running:
                    self._stop_trial(t)
                break
            # launch new trials up to the concurrency cap — restored
            # PENDING trials (Tuner.restore preseeds) go first, resuming
            # from their latest checkpoint
            while len(running) < self.max_concurrent:
                trial = next(
                    (t for t in self.trials if t.status == PENDING and t.actor is None),
                    None,
                )
                if trial is None:
                    trial = self._make_trial()
                if trial is None:
                    break
                self._start_trial(trial)
                running.append(trial)
            if not running:
                break
            # poll running trials
            futures = {t.future: t for t in running if t.future is not None}
            ready, _ = ray_tpu_torch.wait(list(futures.keys()), num_returns=1, timeout=0.1)
            self._drain_reports(running)
            for ref in ready:
                trial = futures[ref]
                if trial.future is ref and trial.status == RUNNING:
                    self._drain_reports([trial])
                    self._finalize_trial(trial)
            # Scheduler-stopped trials: reap their (promptly-interrupting)
            # futures so actors die and completion hooks fire.
            for t in self.trials:
                if t.status != RUNNING and t.actor is not None:
                    done, _ = ray_tpu_torch.wait([t.future], num_returns=1, timeout=0)
                    if done:
                        self._cleanup_stopped(t)
        for t in self.trials:
            if t.actor is not None:
                done, _ = ray_tpu_torch.wait([t.future], num_returns=1, timeout=10.0)
                # A stopped trainable that never reports again can't see the
                # cooperative interrupt — reap the actor without blocking.
                self._cleanup_stopped(t, reap_future=bool(done))
        self.callbacks.on_experiment_end(self.trials)
        return self.trials

    def _cleanup_stopped(self, trial: Trial, reap_future: bool = True) -> None:
        if reap_future:
            try:
                ray_tpu_torch.get(trial.future)
            except Exception:
                pass
        if trial.actor is not None:
            try:
                ray_tpu_torch.kill(trial.actor)
            except Exception:
                pass
            trial.actor = None
        self.searcher.on_trial_complete(trial.trial_id, trial.last_result, error=trial.status == ERROR)
        self.scheduler.on_trial_complete(trial, trial.last_result)
        if trial.status == ERROR:
            self.callbacks.on_trial_error(trial, trial.error)
        else:
            self.callbacks.on_trial_complete(trial)
        self._write_trial_state(trial)

    def _write_trial_state(self, trial: Trial) -> None:
        """Experiment checkpointing (parity: experiment_state.py) — one JSON
        per trial so a crashed experiment can be inspected/resumed."""
        state = {
            "trial_id": trial.trial_id,
            "status": trial.status,
            "config": {k: repr(v) for k, v in trial.config.items()},
            "last_result": {k: v for k, v in trial.last_result.items() if _jsonable(v)},
            "checkpoint": trial.latest_checkpoint.path if trial.latest_checkpoint else None,
            "error": repr(trial.error) if trial.error else None,
        }
        with open(os.path.join(trial.trial_dir, "trial_state.json"), "w") as f:
            json.dump(state, f, indent=2)


def _gpu_share(share: float) -> float:
    """A trial's GPU share, refused when the cluster has no GPU: an
    entry point never waits on a card that is not there (or runs on the
    CPU in its place)."""
    total = ray_tpu_torch.cluster_resources().get("GPU", 0)
    if share and not total:
        raise RuntimeError(
            f"a trial asks for {share} GPU and the cluster has none; "
            "drop the GPU from with_resources() to run the trial on the CPU"
        )
    return share


def _jsonable(v) -> bool:
    return isinstance(v, (int, float, str, bool, type(None)))
