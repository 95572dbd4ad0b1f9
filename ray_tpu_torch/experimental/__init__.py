"""Experimental APIs (parity with ``python/ray/experimental/``).

The port's copy of ``ray_tpu/experimental/__init__.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.
"""

from ray_tpu_torch.experimental import internal_kv, tqdm_ray

__all__ = ["internal_kv", "tqdm_ray"]
