"""Loader for the native hot-path extension (``_hotpath.so``).

The port's copy of ``ray_tpu/native/hotpath.py``. The extension provides C
implementations of the identifier types (``ray_tpu_torch/core/ids.py``
aliases them when available) and the socket frame codec
(``ray_tpu_torch/runtime/protocol.py``). Role parity: the reference's Cython
bridge (``python/ray/_raylet.pyx`` wrapping ``src/ray/common/id.h``) keeps
the same objects native.

Built from ``src/hotpath.c`` on first use (:mod:`ray_tpu_torch.native._build`,
under a file lock, renamed into place atomically). Its types are named
``ray_tpu_torch.core.ids.*``, so a pickled id loads as the port's class; the
module is loaded under its full dotted name, so it and the JAX package's
``_hotpath`` (the same init symbol) live side by side in one process.
"""

from __future__ import annotations

import importlib.machinery
import importlib.util

from ray_tpu_torch.native import _build

_NAME = __name__.rpartition(".")[0] + "._hotpath"


def _load():
    path = _build.library_path("hotpath")
    loader = importlib.machinery.ExtensionFileLoader(_NAME, path)
    spec = importlib.util.spec_from_file_location(_NAME, path, loader=loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    return mod


_mod = _load()

BaseID = _mod.BaseID
JobID = _mod.JobID
NodeID = _mod.NodeID
WorkerID = _mod.WorkerID
ActorID = _mod.ActorID
TaskID = _mod.TaskID
ObjectID = _mod.ObjectID
PlacementGroupID = _mod.PlacementGroupID
FrameDecoder = _mod.FrameDecoder
send_frame = _mod.send_frame
