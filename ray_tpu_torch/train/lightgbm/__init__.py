"""LightGBM data-parallel trainer.

Parity: ``python/ray/train/lightgbm/lightgbm_trainer.py`` (per-worker
``lightgbm.train`` on the worker's shard, train set always in the valid
sets) and ``train/lightgbm/config.py`` (the distributed bootstrap: LightGBM
rendezvous is a ``machines`` host:port list + ``local_listen_port`` +
``num_machines`` params with the data-parallel tree learner — negotiated
here over the cluster KV instead of the reference's backend side channel),
plus ``RayTrainReportCallback`` from ``train/lightgbm/_lightgbm_utils.py``.

Gated on the ``lightgbm`` import; drives only public lightgbm API
(``train``, ``Dataset``, ``Booster``, plain-callable callbacks).

The port's copy of ``ray_tpu/train/lightgbm/__init__.py``.  The booster trains
on the host, so the trainer's ranks are host ranks (``device="cpu"``)
unless the caller names a device for them to hold.
"""

from __future__ import annotations

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
from ray_tpu_torch.util.misc import reserve_port
from ray_tpu_torch.train.trainer import DataParallelTrainer

__all__ = ["LightGBMTrainer", "LightGBMCheckpoint", "RayTrainReportCallback", "LightGBMPredictor"]


class LightGBMCheckpoint(Checkpoint):
    """A checkpoint holding one serialized lightgbm Booster."""

    MODEL_FILENAME = "model.txt"

    @classmethod
    def from_model(cls, booster, base_dir: Optional[str] = None) -> "LightGBMCheckpoint":
        d = base_dir or tempfile.mkdtemp(prefix="lgbm_ckpt_")
        os.makedirs(d, exist_ok=True)
        booster.save_model(os.path.join(d, cls.MODEL_FILENAME))
        return cls(d)

    def get_model(self):
        lightgbm = require_module("lightgbm")
        return lightgbm.Booster(model_file=os.path.join(self.path, self.MODEL_FILENAME))


class RayTrainReportCallback:
    """LightGBM-callback bridge into the train session.

    LightGBM callbacks are plain callables invoked each round with a
    ``CallbackEnv`` namedtuple; this one reports every
    ``(data_name, eval_name)`` pair and checkpoints the booster every
    ``frequency`` rounds plus on the final round (``env.end_iteration``
    marks it — LightGBM has no after-training hook).
    """

    order = 25  # run after lightgbm's own eval-recording callbacks

    def __init__(
        self,
        metrics: Optional[List[str]] = None,
        frequency: int = 0,
        checkpoint_at_end: bool = True,
    ):
        self._metrics = metrics
        self._frequency = frequency
        self._checkpoint_at_end = checkpoint_at_end

    def __call__(self, env) -> None:
        it = env.iteration + 1
        report: Dict[str, Any] = {"training_iteration": it}
        for entry in env.evaluation_result_list or []:
            data_name, eval_name, result = entry[0], entry[1], entry[2]
            key = f"{data_name}-{eval_name}"
            if self._metrics is not None and key not in self._metrics and eval_name not in self._metrics:
                continue
            report[key] = result
        last_round = it >= getattr(env, "end_iteration", it)
        ckpt = None
        if (self._frequency and it % self._frequency == 0) or (
            last_round and self._checkpoint_at_end
        ):
            ckpt = self._maybe_checkpoint(env.model)
        train_session.report(report, checkpoint=ckpt)

    def _maybe_checkpoint(self, model) -> Optional[Checkpoint]:
        ctx = train_session.get_context()
        if ctx.get_world_rank() != 0:
            return None
        return LightGBMCheckpoint.from_model(model)

    @classmethod
    def get_model(cls, checkpoint: Checkpoint):
        """Load the booster out of a checkpoint produced by this callback."""
        return LightGBMCheckpoint(checkpoint.path).get_model()


def _network_params(world: int, rank: int, run_key: str) -> Dict[str, Any]:
    """Negotiate LightGBM's distributed params across the gang.

    Every rank binds a port and publishes ``ip:port`` over the cluster KV;
    the gathered list becomes the ``machines`` param on every rank
    (reference: ``train/lightgbm/config.py`` builds the same list from its
    worker group).  Single-worker gangs return no params.
    """
    if world <= 1:
        return {}
    ip = host_ip()
    # hold the reservation socket OPEN through the rendezvous so the kernel
    # cannot hand a sibling rank on this host the same ephemeral port
    sock = reserve_port()
    port = sock.getsockname()[1]
    try:
        payloads = kv_rendezvous(run_key, rank, world, {"ip": ip, "port": port})
    finally:
        sock.close()  # LightGBM binds it next
    machines = ",".join(f"{p['ip']}:{p['port']}" for p in payloads)
    if len({(p["ip"], p["port"]) for p in payloads}) != world:
        raise RuntimeError(
            f"LightGBM machines negotiation collided: {machines!r} — "
            "two ranks advertised the same endpoint"
        )
    return {
        "machines": machines,
        "local_listen_port": port,
        "num_machines": world,
        "tree_learner": "data",
    }


class LightGBMTrainer(DataParallelTrainer):
    """Distributed LightGBM over the train worker gang.

    Each worker trains on its row shard with the data-parallel tree
    learner; feature histograms allreduce over LightGBM's own socket mesh
    (the ``machines`` list), so every rank ends with the same model.
    """

    def __init__(
        self,
        *,
        params: Optional[Dict[str, Any]] = None,
        label_column: str,
        num_boost_round: int = 10,
        lightgbm_train_kwargs: Optional[Dict[str, Any]] = None,
        report_callback: Optional[RayTrainReportCallback] = None,
        **kwargs,
    ):
        params = dict(params or {})
        train_kwargs = dict(lightgbm_train_kwargs or {})
        dataset_keys = set((kwargs.get("datasets") or {}).keys())
        rc = kwargs.get("run_config")
        run_name = (rc.name if rc is not None and rc.name else None) or f"lgbm_{os.getpid()}"

        def _train_fn(config: dict):
            lightgbm = require_module("lightgbm")
            merged = dict(params)
            merged.update(config or {})
            ctx = train_session.get_context()
            world, rank = ctx.get_world_size(), ctx.get_world_rank()

            ckpt = train_session.get_checkpoint()
            init_model = None
            remaining = num_boost_round
            if ckpt is not None:
                init_model = LightGBMCheckpoint(ckpt.path).get_model()
                done = (
                    int(init_model.current_iteration())
                    if hasattr(init_model, "current_iteration")
                    else 0
                )
                remaining = max(num_boost_round - done, 0)
            if remaining == 0:
                # Already at (or past) the target round count.  LightGBM
                # would run zero iterations and the per-iteration callback
                # would never fire, so re-report the restored model
                # explicitly — otherwise fit() returns no metrics and no
                # checkpoint and the trained model is lost to the caller.
                out_ckpt = (
                    LightGBMCheckpoint.from_model(init_model) if rank == 0 else None
                )
                train_session.report(
                    {"training_iteration": num_boost_round}, checkpoint=out_ckpt
                )
                return

            train_X, train_y = shard_to_xy(
                train_session.get_dataset_shard(TRAIN_DATASET_KEY), label_column
            )
            dtrain = lightgbm.Dataset(train_X, label=train_y)
            valid_sets, valid_names = [dtrain], [TRAIN_DATASET_KEY]
            for name, X, y in eval_shards(dataset_keys, label_column, TRAIN_DATASET_KEY):
                valid_sets.append(lightgbm.Dataset(X, label=y, reference=dtrain))
                valid_names.append(name)

            cb = report_callback or RayTrainReportCallback()
            callbacks = list(train_kwargs.get("callbacks", []))
            callbacks.append(cb)
            extra = {k: v for k, v in train_kwargs.items() if k != "callbacks"}
            # negotiate the socket mesh LAST — data loading above can take
            # minutes, and the advertised port is only reserved, not bound,
            # until lightgbm.train below actually listens on it
            merged.update(
                _network_params(
                    world, rank, f"lgbm_machines/{run_name}/{ctx.get_group_token()}"
                )
            )
            lightgbm.train(
                merged,
                dtrain,
                num_boost_round=remaining,
                valid_sets=valid_sets,
                valid_names=valid_names,
                init_model=init_model,
                callbacks=callbacks,
                **extra,
            )

        kwargs.setdefault("device", "cpu")  # the booster trains on the host
        super().__init__(_train_fn, train_loop_config={}, **kwargs)


class LightGBMPredictor(Predictor):
    """Batch inference with a trained booster (parity:
    ``train/lightgbm/lightgbm_predictor.py``)."""

    def __init__(self, model, preprocessor=None):
        super().__init__(preprocessor)
        self.model = model

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, preprocessor=None) -> "LightGBMPredictor":
        return cls(LightGBMCheckpoint(checkpoint.path).get_model(), preprocessor)

    def _predict_pandas(self, df, **kwargs):
        import pandas as pd

        preds = self.model.predict(df, **kwargs)
        return pd.DataFrame({"predictions": wrap_predictions_column(preds)})
