"""Usage stats (the port's copy of ``ray_tpu/usage/``; parity:
``python/ray/_private/usage/``)."""

from ray_tpu_torch.usage.usage_lib import (
    record_extra_usage_tag,
    usage_stats_enabled,
    usage_report,
)

__all__ = ["record_extra_usage_tag", "usage_stats_enabled", "usage_report"]
