"""Predictors: load a trained model from a checkpoint and predict batches.

The port's copy of ``ray_tpu/train/predictor.py``. Parity:
``python/ray/train/predictor.py:40`` (abstract ``Predictor`` with
``from_checkpoint`` / ``from_pandas_udf`` / preprocessor plumbing /
format-dispatching ``predict``, and the deliberate non-serializability that
pushes batch inference through ``Dataset.map_batches`` with a callable
class) — plus :class:`DevicePredictor`, the port's counterpart of the JAX
package's ``JaxPredictor`` (which raises ``NotPortedError`` here): an
``apply_fn(params, batch)`` on tensors on a device, params restored from a
tree checkpoint.  The torch module predictor is
``ray_tpu_torch.train.torch.TorchPredictor``.

pandas is imported only for a DataFrame batch (or a DataFrame-only
predictor): numpy batches never load it.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np

from ray_tpu_torch.train.checkpoint import Checkpoint

__all__ = ["Predictor", "DevicePredictor", "JaxPredictor", "PredictorNotSerializableException"]


def wrap_predictions_column(arr) -> "Any":
    """A model-output array as one DataFrame column: 1-D stays a column,
    N-D becomes a column of row-arrays (pandas rejects 2-D column values)."""
    arr = np.asarray(arr)
    return arr if arr.ndim == 1 else list(arr)


class PredictorNotSerializableException(RuntimeError):
    """Predictors are driver-side objects; ship the checkpoint to tasks and
    ``from_checkpoint`` there (reference: predictor.py:33)."""


class Predictor:
    """Base predictor (parity: predictor.py:40).

    Subclasses implement ``_predict_pandas`` or ``_predict_numpy``;
    ``predict`` dispatches on the input batch type (DataFrame, dict of
    arrays, or bare ndarray) and applies the fitted preprocessor first.
    """

    def __init__(self, preprocessor: Optional[Any] = None):
        self._preprocessor = preprocessor

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, **kwargs) -> "Predictor":
        raise NotImplementedError

    @classmethod
    def from_pandas_udf(cls, pandas_udf: Callable) -> "Predictor":
        """Wrap a ``df -> df`` function as a Predictor (parity:
        predictor.py:99)."""

        class PandasUDFPredictor(Predictor):
            @classmethod
            def from_checkpoint(cls, checkpoint, **kwargs):
                return cls()

            def _predict_pandas(self, df, **kwargs):
                return pandas_udf(df, **kwargs)

        return PandasUDFPredictor()

    def get_preprocessor(self) -> Optional[Any]:
        return self._preprocessor

    def set_preprocessor(self, preprocessor: Optional[Any]) -> None:
        self._preprocessor = preprocessor

    # ------------------------------------------------------------- predict
    def predict(self, data: Any, **kwargs) -> Any:
        """Predict one batch: DataFrame in → DataFrame out; dict/ndarray in
        → dict/ndarray out."""
        import sys

        if self._preprocessor is not None:
            data = self._preprocessor.transform_batch(data)
        pd = sys.modules.get("pandas")  # a DataFrame batch has loaded it
        if pd is not None and isinstance(data, pd.DataFrame):
            return self._predict_pandas(data, **kwargs)
        if isinstance(data, dict):
            out = self._predict_numpy(data, **kwargs)
            return out
        if isinstance(data, np.ndarray):
            return self._predict_numpy(data, **kwargs)
        raise TypeError(
            f"Unsupported batch type {type(data).__name__}; expected "
            "pandas.DataFrame, dict of ndarrays, or ndarray"
        )

    def _require_impl(self, have: str) -> None:
        # the two base hooks cross-convert through each other; a subclass
        # overriding neither must get NotImplementedError, not RecursionError
        other = "_predict_numpy" if have == "_predict_pandas" else "_predict_pandas"
        if getattr(type(self), other) is getattr(Predictor, other):
            raise NotImplementedError(
                f"{type(self).__name__} implements neither _predict_pandas "
                "nor _predict_numpy"
            )

    # subclasses implement at least one of these; the base cross-converts
    def _predict_pandas(self, df, **kwargs):
        import pandas as pd

        self._require_impl("_predict_pandas")
        arrays = {c: df[c].to_numpy() for c in df.columns}
        out = self._predict_numpy(arrays, **kwargs)
        if isinstance(out, dict):
            return pd.DataFrame({k: wrap_predictions_column(v) for k, v in out.items()})
        return pd.DataFrame({"predictions": wrap_predictions_column(out)})

    def _predict_numpy(self, data, **kwargs):
        import pandas as pd

        self._require_impl("_predict_numpy")
        if isinstance(data, dict):
            df = pd.DataFrame({k: list(v) for k, v in data.items()})
        else:
            df = pd.DataFrame({"__value__": list(data)})
        out = self._predict_pandas(df, **kwargs)
        return {c: out[c].to_numpy() for c in out.columns}

    def __reduce__(self):
        raise PredictorNotSerializableException(
            f"{type(self).__name__} is not serializable — pass the Checkpoint "
            "to your tasks/actors and call from_checkpoint() there (this is "
            "what Dataset.map_batches with a callable class does)."
        )


def _on_device(tree, device):
    """A checkpoint tree with every array leaf a tensor on ``device`` (the
    JAX package's restore gives device arrays; a numpy leaf saved from the
    host comes back as numpy here)."""
    import torch

    if isinstance(tree, dict):
        return {k: _on_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on_device(v, device) for v in tree)
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.as_tensor(np.asarray(tree)).to(device)
    return tree


class DevicePredictor(Predictor):
    """Predict with a tensor apply function on a device (the JAX package's
    ``JaxPredictor``, without jit).

    ``apply_fn(params, batch_tensor) -> tensor``; params come from a tree
    checkpoint (``Checkpoint.from_pytree``/``to_pytree``).  Inputs are
    stacked feature columns (dict batches) or a raw ndarray, put on
    ``device`` (CUDA unless ``"cpu"`` is asked for); outputs come back as
    numpy.
    """

    def __init__(self, apply_fn: Callable, params: Any, preprocessor=None, device=None):
        super().__init__(preprocessor)
        from ray_tpu_torch.models.common import default_device

        self.device = default_device(device, "DevicePredictor")
        self.params = params
        self.apply_fn = apply_fn

    @classmethod
    def from_checkpoint(
        cls, checkpoint: Checkpoint, apply_fn: Callable, preprocessor=None, device=None,
        **kwargs
    ) -> "DevicePredictor":
        from ray_tpu_torch.models.common import default_device

        dev = default_device(device, "DevicePredictor")
        return cls(apply_fn, _on_device(checkpoint.to_pytree(device=dev), dev),
                   preprocessor=preprocessor, device=dev, **kwargs)

    def _predict_numpy(self, data, **kwargs):
        import torch

        if isinstance(data, dict):
            x = np.stack([np.asarray(v) for v in data.values()], axis=-1)
        else:
            x = np.asarray(data)
        with torch.no_grad():
            out = self.apply_fn(self.params, torch.from_numpy(np.ascontiguousarray(x)).to(self.device))
        return {"predictions": out.detach().cpu().numpy()}


class JaxPredictor:
    """The JAX package's predictor: JAX is not in the port, whose
    counterpart is :class:`DevicePredictor` (tensors on a device)."""

    def __init__(self, *args, **kwargs):
        from ray_tpu_torch.exceptions import NotPortedError

        raise NotPortedError("JaxPredictor (use DevicePredictor: tensors on CUDA)",
                             "ray_tpu/train/predictor.py:135")

    @classmethod
    def from_checkpoint(cls, *args, **kwargs):
        return cls(*args, **kwargs)
