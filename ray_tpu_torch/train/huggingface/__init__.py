"""HuggingFace integrations: Accelerate and Transformers trainers.

Parity: the reference's ``train/huggingface/`` + the Accelerate/DeepSpeed
examples (``train/examples/deepspeed/deepspeed_torch_trainer.py``,
``train/tests/test_torch_accelerate.py``) — a worker gang where each rank
runs under an ``accelerate.Accelerator`` (or a ``transformers.Trainer``),
with the process group and Accelerate's env contract wired by the
framework instead of `accelerate launch`.

The port's copy of ``ray_tpu/train/huggingface/__init__.py``, with two
divergences at the device seam (ROADMAP.md, Queue 3): ``AccelerateTrainer``
moves Accelerate to the CPU only for a trainer given ``device="cpu"`` (the
JAX package's always does), and ``TransformersPredictor`` runs its model on
``device`` (CUDA unless ``"cpu"`` is asked for, raising without CUDA), as
``TorchPredictor`` does.  ``transformers`` and ``accelerate`` are imported
only where they are used.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.predictor import Predictor
from ray_tpu_torch.train.torch import TorchConfig, TorchTrainer


class AccelerateTrainer(TorchTrainer):
    """Runs the user loop under HF Accelerate (parity: AccelerateTrainer).

    The gang's torch process group comes up first (gloo); each worker then
    sets Accelerate's launcher env so ``accelerate.Accelerator()`` adopts
    the existing group instead of spawning its own.  Ranks sit on the card
    unless the trainer is given ``device="cpu"``; only then is Accelerate
    told to use the CPU.
    """

    def __init__(self, train_loop_per_worker, **kwargs):
        on_cpu = False

        def loop(config):
            # rank/world/master env comes from the torch process-group
            # wrapper (_with_process_group); Accelerator() then adopts the
            # already-initialized gloo group — no launcher flag needed.
            if on_cpu:
                os.environ.setdefault("ACCELERATE_USE_CPU", "true")
            return train_loop_per_worker(config)

        super().__init__(loop, **kwargs)
        on_cpu = self._device_type == "cpu"


_report_callback_cls = None


def _get_report_callback_cls():
    """Build the TrainerCallback subclass once (lazy: transformers import
    stays off the module-import path). A single cached class keeps
    add_callback/remove_callback(RayTrainReportCallback-style) type
    comparisons working."""
    global _report_callback_cls
    if _report_callback_cls is None:
        from transformers import TrainerCallback

        class RayTrainReportCallbackImpl(TrainerCallback):
            def on_log(self, args, state, control, logs=None, **kwargs):
                from ray_tpu_torch import train

                if logs:
                    metrics = {k: v for k, v in logs.items() if isinstance(v, (int, float))}
                    metrics["step"] = state.global_step
                    metrics["epoch"] = float(state.epoch or 0)
                    train.report(metrics)

        _report_callback_cls = RayTrainReportCallbackImpl
    return _report_callback_cls


def RayTrainReportCallback():
    """transformers.TrainerCallback bridging HF logs to train.report
    (parity: ray.train.huggingface.transformers.RayTrainReportCallback)."""
    return _get_report_callback_cls()()


def prepare_trainer(trainer):
    """Attach the report bridge to a transformers.Trainer (parity:
    transformers.prepare_trainer)."""
    trainer.add_callback(RayTrainReportCallback())
    return trainer


class TransformersTrainer(TorchTrainer):
    """Gang-runs a user-built ``transformers.Trainer`` per worker (parity:
    the legacy TransformersTrainer): ``trainer_init_per_worker(config)``
    returns a Trainer; the framework wires the process group, attaches the
    report callback, and calls ``.train()``."""

    def __init__(self, trainer_init_per_worker: Callable, **kwargs):
        def loop(config):
            hf_trainer = trainer_init_per_worker(config)
            prepare_trainer(hf_trainer)
            hf_trainer.train()

        super().__init__(loop, **kwargs)


class TransformersCheckpoint(Checkpoint):
    """A checkpoint holding a ``save_pretrained`` HF model directory
    (parity: ``train/huggingface/transformers/transformers_checkpoint.py``)."""

    @classmethod
    def from_model(cls, model, tokenizer=None, base_dir: Optional[str] = None) -> "TransformersCheckpoint":
        import tempfile

        d = base_dir or tempfile.mkdtemp(prefix="hf_ckpt_")
        os.makedirs(d, exist_ok=True)
        model.save_pretrained(d)
        if tokenizer is not None:
            tokenizer.save_pretrained(d)
        return cls(d)

    def get_model(self, model_cls=None):
        """Reload with ``model_cls.from_pretrained`` (AutoModel default)."""
        if model_cls is None:
            from transformers import AutoModel as model_cls  # noqa: N813
        return model_cls.from_pretrained(self.path)


class TransformersPredictor(Predictor):
    """Batch inference with a HF model or pipeline (parity:
    ``train/huggingface/transformers/transformers_predictor.py``).

    Two modes: a ``transformers.pipeline`` (rows in, list-of-dicts out —
    one DataFrame column per output key), or a bare model whose forward
    consumes ``input_ids`` and yields ``.logits``.  The model and its
    inputs sit on ``device`` (CUDA unless ``"cpu"`` is asked for; without
    CUDA and without a device this raises); predictions come back as numpy.
    """

    def __init__(self, model=None, pipeline=None, preprocessor=None, device=None):
        super().__init__(preprocessor)
        if model is None and pipeline is None:
            raise ValueError("TransformersPredictor needs a model or a pipeline")
        from ray_tpu_torch.models.common import default_device

        self.device = default_device(device, "TransformersPredictor")
        self.model = model
        self.pipeline = pipeline
        if self.model is not None:
            self.model = self.model.to(self.device)
            self.model.eval()

    @classmethod
    def from_checkpoint(
        cls,
        checkpoint: Checkpoint,
        *,
        model_cls=None,
        pipeline_task: Optional[str] = None,
        preprocessor=None,
        device=None,
        **pipeline_kwargs,
    ) -> "TransformersPredictor":
        ckpt = TransformersCheckpoint(checkpoint.path)
        if pipeline_task is not None:
            from transformers import pipeline as hf_pipeline

            from ray_tpu_torch.models.common import default_device

            device = default_device(device, "TransformersPredictor")
            return cls(
                pipeline=hf_pipeline(pipeline_task, model=ckpt.path, device=device,
                                     **pipeline_kwargs),
                preprocessor=preprocessor,
                device=device,
            )
        if model_cls is None:
            # AutoModel would load the HEADLESS base model and silently hand
            # back hidden states as "predictions"; the logits contract needs
            # a headed class by default
            from transformers import AutoModelForCausalLM as model_cls  # noqa: N813
        return cls(model=ckpt.get_model(model_cls), preprocessor=preprocessor, device=device)

    def _predict_pandas(self, df, **kwargs):
        import pandas as pd

        if self.pipeline is not None:
            rows = self.pipeline(list(df[df.columns[0]]), **kwargs)
            return pd.DataFrame(rows)
        arrays = {c: df[c].to_numpy() for c in df.columns}
        out = self._predict_numpy(arrays, **kwargs)
        from ray_tpu_torch.train.predictor import wrap_predictions_column

        return pd.DataFrame({k: wrap_predictions_column(v) for k, v in out.items()})

    def _predict_numpy(self, data, **kwargs):
        import numpy as np
        import torch

        if self.pipeline is not None:
            # route dict/array batches through the pandas path's pipeline call
            raise TypeError(
                "pipeline-mode TransformersPredictor takes DataFrame batches "
                "(one text column); pass a model for tensor batches"
            )
        if isinstance(data, dict):
            if "input_ids" in data:
                x = data["input_ids"]
            elif len(data) == 1:
                x = next(iter(data.values()))  # sole column = the token ids
            else:
                raise KeyError(
                    "model-mode TransformersPredictor expects an 'input_ids' "
                    f"column (or a single-column batch); got {sorted(data)}"
                )
        else:
            x = data
        ids = torch.from_numpy(np.asarray(x, dtype=np.int64)).to(self.device)
        with torch.no_grad():
            out = self.model(input_ids=ids, **kwargs)
        logits = out.logits if hasattr(out, "logits") else out[0]
        return {"predictions": logits.detach().cpu().numpy()}
