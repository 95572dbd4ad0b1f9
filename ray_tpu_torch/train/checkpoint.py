"""Directory-based checkpoints of tensors and train states.

The port's own copy of ``ray_tpu/train/checkpoint.py``: ``Checkpoint`` is a
handle to a directory of files (``from_directory``/``to_directory``/
``as_directory``, ``from_dict``/``to_dict``), and ``from_pytree`` /
``to_pytree`` save a nested tree of tensors (params, a train state) as a
pickled host copy: every tensor crosses as a ``.cpu()`` copy, where the JAX
package calls ``jax.device_get``, and ``to_pytree(device=...)`` puts the
tree back on a device. There is no orbax branch.

Durability: every pickled artifact is written with crash-atomic framing:
``magic + blake2b-16(payload) + payload`` into a temp file, fsync, atomic
rename, with the previous generation rotated to ``<path>.prev`` first. A
writer killed at any instant leaves either the new complete file or the
previous complete one; restore rejects torn files on the digest and falls
back to ``.prev``.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import pickle
import shutil
import tempfile
import uuid
from typing import Any, Dict, Iterator, Optional

import torch

#: framing shared by every pickled checkpoint artifact (the JAX package's)
_CKPT_MAGIC = b"RTCKPT1\n"


def save_framed(path: str, obj: Any) -> None:
    """Crash-atomic pickled write: digest framing + tmp + fsync + rename,
    rotating the previous generation to ``<path>.prev``."""
    payload = pickle.dumps(obj, protocol=5)
    digest = hashlib.blake2b(payload, digest_size=16).digest()
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(_CKPT_MAGIC + digest + payload)
        f.flush()
        os.fsync(f.fileno())  # bytes durable BEFORE the rename publishes them
    if os.path.exists(path):
        # keep the last good generation: a crash between the two renames
        # still leaves .prev for load_framed's fallback
        os.replace(path, path + ".prev")
    os.replace(tmp, path)  # atomic: readers never see a torn file
    try:
        dir_fd = os.open(os.path.dirname(os.path.abspath(path)) or ".", os.O_RDONLY)
        try:
            os.fsync(dir_fd)  # the renames themselves survive power loss
        finally:
            os.close(dir_fd)
    except OSError:
        pass


def _load_framed_file(path: str) -> Optional[Any]:
    """One framed file -> object, or None if missing/torn. The digest check
    rejects truncated and bit-flipped files before pickle ever sees them;
    headerless files fall back to plain pickle."""
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            raw = f.read()
        if raw.startswith(_CKPT_MAGIC):
            off = len(_CKPT_MAGIC)
            digest, payload = raw[off:off + 16], raw[off + 16:]
            if hashlib.blake2b(payload, digest_size=16).digest() != digest:
                raise ValueError("checkpoint digest mismatch (torn/partial write)")
            return pickle.loads(payload)
        return pickle.loads(raw)
    except Exception:  # noqa: BLE001 — a torn file must fall back, not raise
        return None


def load_framed(path: str) -> Optional[Any]:
    """Framed file -> object; a rejected current generation restores the
    ``.prev`` one rotated by :func:`save_framed`. None when neither loads."""
    obj = _load_framed_file(path)
    if obj is None:
        obj = _load_framed_file(path + ".prev")
    return obj


def _map_tensors(tree: Any, fn) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


class Checkpoint:
    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    # ----------------------------------------------------------- directory
    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def to_directory(self, path: Optional[str] = None) -> str:
        if path is None or os.path.abspath(path) == self.path:
            return self.path
        os.makedirs(path, exist_ok=True)
        shutil.copytree(self.path, path, dirs_exist_ok=True)
        return path

    @contextlib.contextmanager
    def as_directory(self) -> Iterator[str]:
        yield self.path

    # --------------------------------------------------------------- dicts
    @classmethod
    def from_dict(cls, data: Dict[str, Any], base_dir: Optional[str] = None) -> "Checkpoint":
        path = os.path.join(base_dir or tempfile.gettempdir(), f"ckpt_{uuid.uuid4().hex[:12]}")
        os.makedirs(path, exist_ok=True)
        save_framed(os.path.join(path, "data.pkl"), data)
        return cls(path)

    def to_dict(self) -> Dict[str, Any]:
        data = load_framed(os.path.join(self.path, "data.pkl"))
        if data is None:
            raise FileNotFoundError(
                f"no readable checkpoint data at {self.path} (missing or torn)"
            )
        return data

    # ------------------------------------------------------------- pytrees
    @classmethod
    def from_pytree(cls, tree: Any, base_dir: Optional[str] = None) -> "Checkpoint":
        """Save a nested tree of tensors (dicts, lists, tuples; other leaves
        as they are) as a pickled host copy: each tensor crosses as
        ``.cpu()``, bits, dtype and shape unchanged."""
        path = os.path.join(base_dir or tempfile.gettempdir(), f"ckpt_{uuid.uuid4().hex[:12]}")
        os.makedirs(path, exist_ok=True)
        save_framed(os.path.join(path, "pytree.pkl"),
                    _map_tensors(tree, lambda t: t.detach().cpu()))
        return cls(path)

    def to_pytree(self, device=None) -> Any:
        """The saved tree, its tensors on the CPU, or on ``device``."""
        tree = load_framed(os.path.join(self.path, "pytree.pkl"))
        if tree is None:
            raise FileNotFoundError(
                f"no readable pytree checkpoint at {self.path} (missing or torn)"
            )
        if device is not None:
            tree = _map_tensors(tree, lambda t: t.to(device))
        return tree

    def __repr__(self) -> str:
        return f"Checkpoint(path={self.path})"
