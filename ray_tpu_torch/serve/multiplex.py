"""Model multiplexing: many models per replica, LRU-resident.

The port's copy of ``ray_tpu/serve/multiplex.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Parity: ``python/ray/serve/multiplex.py`` — ``@serve.multiplexed`` wraps an
async/sync model loader; per-model instances are cached per replica with an
LRU cap (``max_num_models_per_replica``): the many-LoRA / many-finetune
pattern, models sharing the replica's card and swapping in its memory.
"""

from __future__ import annotations

import functools
import threading
from collections import OrderedDict
from typing import Any, Callable, Optional

_current_model_id = threading.local()


def get_multiplexed_model_id() -> str:
    """Inside a replica call: the model id of the current request."""
    return getattr(_current_model_id, "value", "")


def set_multiplexed_model_id(model_id: str) -> None:
    _current_model_id.value = model_id


def multiplexed(_fn: Optional[Callable] = None, *, max_num_models_per_replica: int = 3):
    def wrap(loader):
        cache_holder: dict = {}
        lock = threading.Lock()

        @functools.wraps(loader)
        def get_model(self_or_id, model_id: Optional[str] = None):
            if model_id is None:
                instance, model_id = None, self_or_id
            else:
                instance = self_or_id
            key = id(instance)
            with lock:
                cache = cache_holder.setdefault(key, OrderedDict())
                if model_id in cache:
                    cache.move_to_end(model_id)
                    return cache[model_id]
            model = loader(instance, model_id) if instance is not None else loader(model_id)
            with lock:
                cache = cache_holder[key]
                cache[model_id] = model
                cache.move_to_end(model_id)
                while len(cache) > max_num_models_per_replica:
                    cache.popitem(last=False)
            return model

        return get_model

    if _fn is not None:
        return wrap(_fn)
    return wrap
