"""The port's copy of ``ray_tpu/air/types.py``.

AIR type surface (parity: ``python/ray/air/util/data_batch_conversion.py``
DataBatchType, ``air/config.py`` DatasetConfig, ``air/execution/resources``
ResourceRequest/AcquiredResources)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

import numpy as np

# what trainers/predictors accept as one batch of data
DataBatchType = Union[Dict[str, np.ndarray], "np.ndarray", List[dict]]


@dataclasses.dataclass
class DatasetConfig:
    """Per-dataset ingest options for trainers (parity: air DatasetConfig —
    legacy spelling of train.DataConfig's per-dataset knobs)."""

    fit: bool = False
    split: bool = True
    required: bool = False
    transform: bool = True


@dataclasses.dataclass
class ResourceRequest:
    """A resource bundle an execution component wants (parity:
    air.execution.resources.ResourceRequest)."""

    bundles: List[Dict[str, float]]
    strategy: str = "PACK"

    @property
    def head_bundle(self) -> Dict[str, float]:
        return self.bundles[0] if self.bundles else {}


@dataclasses.dataclass
class AcquiredResources:
    """A granted ResourceRequest (parity: air AcquiredResources)."""

    request: ResourceRequest
    placement_group: Optional[Any] = None
