"""XGBoost data-parallel trainer.

Parity: ``python/ray/train/xgboost/xgboost_trainer.py:74`` (per-worker
``xgboost.train`` on the worker's dataset shard, train dataset included in
the eval set so ``train-*`` metrics report), ``train/xgboost/config.py``
(rabit tracker bootstrap — here rank 0 starts the tracker and publishes the
worker args over the cluster KV instead of a backend side channel), and
``train/xgboost/_xgboost_utils.py`` (``RayTrainReportCallback``: per-round
metric reports + model checkpoints through the train session).

Gated on the ``xgboost`` import; everything this module drives is public
xgboost API (``train``, ``DMatrix``, ``Booster``, ``callback
.TrainingCallback``, ``collective.CommunicatorContext``).

The port's copy of ``ray_tpu/train/xgboost/__init__.py``.  The booster trains
on the host, so the trainer's ranks are host ranks (``device="cpu"``)
unless the caller names a device for them to hold.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Any, Dict, List, Optional

from ray_tpu_torch.train import session as train_session
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.predictor import Predictor, wrap_predictions_column
from ray_tpu_torch.train.config import TRAIN_DATASET_KEY
from ray_tpu_torch.train.gbdt import (
    eval_shards,
    host_ip,
    kv_rendezvous,
    require_module,
    shard_to_xy,
)
from ray_tpu_torch.train.trainer import DataParallelTrainer

__all__ = ["XGBoostTrainer", "XGBoostCheckpoint", "RayTrainReportCallback", "XGBoostPredictor"]


class XGBoostCheckpoint(Checkpoint):
    """A checkpoint holding one serialized xgboost Booster."""

    MODEL_FILENAME = "model.json"

    @classmethod
    def from_model(cls, booster, base_dir: Optional[str] = None) -> "XGBoostCheckpoint":
        d = base_dir or tempfile.mkdtemp(prefix="xgb_ckpt_")
        os.makedirs(d, exist_ok=True)
        booster.save_model(os.path.join(d, cls.MODEL_FILENAME))
        return cls(d)

    def get_model(self):
        xgboost = require_module("xgboost")
        booster = xgboost.Booster()
        booster.load_model(os.path.join(self.path, self.MODEL_FILENAME))
        return booster


class RayTrainReportCallback:
    """Per-boosting-round bridge from xgboost into the train session.

    Reports the latest value of every eval metric each round (flattened as
    ``{dataset}-{metric}``) and checkpoints the booster every ``frequency``
    rounds (0 = never mid-train) plus once at the end of training.  Only the
    rank-0 worker writes checkpoints — sibling ranks hold replicas of the
    same boosted model after each allreduce round.
    """

    def __init__(
        self,
        metrics: Optional[List[str]] = None,
        frequency: int = 0,
        checkpoint_at_end: bool = True,
    ):
        self._metrics = metrics
        self._frequency = frequency
        self._checkpoint_at_end = checkpoint_at_end
        self._last_report: Dict[str, Any] = {}

    # -- xgboost TrainingCallback protocol (duck-typed; `_adapt_callback`
    # wraps this in a real TrainingCallback subclass when xgboost is live) --
    def after_iteration(self, model, epoch: int, evals_log) -> bool:
        report: Dict[str, Any] = {"training_iteration": epoch + 1}
        for ds_name, metric_hist in (evals_log or {}).items():
            for metric_name, values in metric_hist.items():
                key = f"{ds_name}-{metric_name}"
                if self._metrics is not None and key not in self._metrics and metric_name not in self._metrics:
                    continue
                report[key] = values[-1]
        self._last_report = report
        ckpt = None
        if self._frequency and (epoch + 1) % self._frequency == 0:
            ckpt = self._maybe_checkpoint(model)
        train_session.report(report, checkpoint=ckpt)
        return False  # never early-stop on the report path

    def after_training(self, model):
        if self._checkpoint_at_end:
            ckpt = self._maybe_checkpoint(model)
            if ckpt is not None:
                train_session.report(dict(self._last_report), checkpoint=ckpt)
        return model

    def before_training(self, model):
        return model

    def before_iteration(self, model, epoch, evals_log) -> bool:
        return False

    def _maybe_checkpoint(self, model) -> Optional[Checkpoint]:
        ctx = train_session.get_context()
        if ctx.get_world_rank() != 0:
            return None
        return XGBoostCheckpoint.from_model(model)

    @classmethod
    def get_model(cls, checkpoint: Checkpoint):
        """Load the booster out of a checkpoint produced by this callback."""
        return XGBoostCheckpoint(checkpoint.path).get_model()


def _adapt_callback(cb: RayTrainReportCallback, xgboost):
    """Wrap our duck-typed callback in a real TrainingCallback subclass —
    xgboost rejects callbacks that don't inherit its base class."""
    base = getattr(getattr(xgboost, "callback", None), "TrainingCallback", None)
    if base is None or isinstance(cb, base):
        return cb

    class _Adapter(base):
        def after_iteration(self, model, epoch, evals_log):
            return cb.after_iteration(model, epoch, evals_log)

        def after_training(self, model):
            return cb.after_training(model)

    return _Adapter()


@contextlib.contextmanager
def _communicator(xgboost, world_size: int, rank: int, run_key: str):
    """Enter xgboost's collective for a multi-worker gang.

    Rank 0 starts the tracker and publishes its worker args over the
    cluster KV; all ranks join a CommunicatorContext so xgboost's histogram
    allreduce spans the gang (reference: ``train/xgboost/config.py``).
    Degrades to per-shard independent training when the installed xgboost
    predates the collective API.
    """
    coll = getattr(xgboost, "collective", None)
    tracker_mod = getattr(xgboost, "tracker", None)
    ctx_cls = getattr(coll, "CommunicatorContext", None) if coll else None
    tracker_cls = getattr(tracker_mod, "RabitTracker", None) if tracker_mod else None
    if world_size <= 1 or ctx_cls is None or tracker_cls is None:
        if world_size > 1:
            import warnings

            warnings.warn(
                "xgboost has no collective API (xgboost.collective / "
                "xgboost.tracker missing): each of the "
                f"{world_size} workers is training INDEPENDENTLY on its "
                "1/{0} row shard — the checkpointed model sees a fraction "
                "of the data. Upgrade xgboost (>=1.7) for distributed "
                "training.".format(world_size),
                RuntimeWarning,
                stacklevel=2,
            )
        yield
        return
    tracker = None
    if rank == 0:
        tracker = tracker_cls(host_ip=host_ip(), n_workers=world_size)
        tracker.start()
        args = {k: v for k, v in tracker.worker_args().items()}
        kv_rendezvous(run_key, rank, world_size, args)
    else:
        payloads = kv_rendezvous(run_key, rank, world_size, {})
        args = payloads[0]
    try:
        with ctx_cls(**args):
            yield
    finally:
        if tracker is not None:
            with contextlib.suppress(Exception):
                tracker.free()


class XGBoostTrainer(DataParallelTrainer):
    """Distributed XGBoost over the train worker gang.

    Each worker trains on its row shard of the ``train`` dataset inside the
    xgboost collective, so the boosted model is identical on every rank;
    every non-train dataset becomes a named eval set (the train set itself
    is always evaluated too, giving the reference's ``train-*`` rows).
    """

    def __init__(
        self,
        *,
        params: Optional[Dict[str, Any]] = None,
        label_column: str,
        num_boost_round: int = 10,
        dmatrix_params: Optional[Dict[str, Dict[str, Any]]] = None,
        xgboost_train_kwargs: Optional[Dict[str, Any]] = None,
        report_callback: Optional[RayTrainReportCallback] = None,
        **kwargs,
    ):
        params = dict(params or {})
        dmatrix_params = dmatrix_params or {}
        train_kwargs = dict(xgboost_train_kwargs or {})
        dataset_keys = set((kwargs.get("datasets") or {}).keys())
        rc = kwargs.get("run_config")
        run_name = (rc.name if rc is not None and rc.name else None) or f"xgb_{os.getpid()}"

        def _train_fn(config: dict):
            xgboost = require_module("xgboost")
            merged = dict(params)
            merged.update(config or {})
            ctx = train_session.get_context()
            world, rank = ctx.get_world_size(), ctx.get_world_rank()

            ckpt = train_session.get_checkpoint()
            starting_model = None
            remaining = num_boost_round
            if ckpt is not None:
                starting_model = XGBoostCheckpoint(ckpt.path).get_model()
                done = int(starting_model.num_boosted_rounds()) if hasattr(
                    starting_model, "num_boosted_rounds"
                ) else 0
                remaining = max(num_boost_round - done, 0)

            cb = report_callback or RayTrainReportCallback()
            callbacks = list(train_kwargs.get("callbacks", []))
            callbacks.append(_adapt_callback(cb, xgboost))
            extra = {k: v for k, v in train_kwargs.items() if k != "callbacks"}
            evals_result: Dict[str, Any] = {}
            rdv_key = f"xgb_tracker/{run_name}/{ctx.get_group_token()}"
            # the communicator spans shard loading too: ranks rendezvous on
            # the tracker BEFORE the (possibly minutes-long, skewed) data
            # materialization, so load skew can't eat the rendezvous timeout
            with _communicator(xgboost, world, rank, rdv_key):
                train_X, train_y = shard_to_xy(
                    train_session.get_dataset_shard(TRAIN_DATASET_KEY), label_column
                )
                dtrain = xgboost.DMatrix(
                    train_X, label=train_y, **dmatrix_params.get(TRAIN_DATASET_KEY, {})
                )
                evals = [(dtrain, TRAIN_DATASET_KEY)]
                for name, X, y in eval_shards(dataset_keys, label_column, TRAIN_DATASET_KEY):
                    evals.append(
                        (xgboost.DMatrix(X, label=y, **dmatrix_params.get(name, {})), name)
                    )
                xgboost.train(
                    merged,
                    dtrain=dtrain,
                    evals=evals,
                    evals_result=evals_result,
                    num_boost_round=remaining,
                    xgb_model=starting_model,
                    callbacks=callbacks,
                    **extra,
                )

        kwargs.setdefault("device", "cpu")  # the booster trains on the host
        super().__init__(_train_fn, train_loop_config={}, **kwargs)


class XGBoostPredictor(Predictor):
    """Batch inference with a trained booster (parity:
    ``train/xgboost/xgboost_predictor.py:18``)."""

    def __init__(self, model, preprocessor=None):
        super().__init__(preprocessor)
        self.model = model

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, preprocessor=None) -> "XGBoostPredictor":
        return cls(XGBoostCheckpoint(checkpoint.path).get_model(), preprocessor)

    def _predict_pandas(self, df, **kwargs):
        import pandas as pd

        xgboost = require_module("xgboost")
        preds = self.model.predict(xgboost.DMatrix(df), **kwargs)
        return pd.DataFrame({"predictions": wrap_predictions_column(preds)})
