"""URI-addressed resource cache with reference counting.

The port's copy of ``ray_tpu/runtime_env/uri_cache.py``.

Parity with ``python/ray/_private/runtime_env/uri_cache.py``: created
runtime-env artifacts (staged working dirs, py_modules) are cached by URI;
refcounts track live users and size-bounded eviction deletes unreferenced
artifacts oldest-first.
"""

from __future__ import annotations

import os
import shutil
import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional


def _dir_size(path: str) -> int:
    if os.path.isfile(path):
        return os.path.getsize(path)
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total


class URICache:
    def __init__(self, max_total_size_bytes: int = 10 * 1024**3):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, str]" = OrderedDict()  # uri -> local path
        self._refs: Dict[str, int] = {}
        self._sizes: Dict[str, int] = {}
        self._creation_locks: Dict[str, threading.Lock] = {}
        self.max_total_size_bytes = max_total_size_bytes

    def get_or_create(self, uri: str, creator: Callable[[], str], add_ref: bool = False) -> str:
        """Return the artifact path, creating it if absent.

        ``add_ref=True`` takes a reference atomically with the lookup, so no
        eviction window exists between handing out the path and the caller
        pinning it (pair with :meth:`remove_reference`).
        """
        # Serialize creation per URI so two concurrent submissions with the
        # same new artifact don't both run the creator (and race the copy).
        with self._lock:
            creation_lock = self._creation_locks.setdefault(uri, threading.Lock())
        with creation_lock:
            with self._lock:
                path = self._entries.get(uri)
                if path is not None and os.path.exists(path):
                    self._entries.move_to_end(uri)
                    if add_ref:
                        self._refs[uri] = self._refs.get(uri, 0) + 1
                    return path
            try:
                path = creator()
                with self._lock:
                    self._entries[uri] = path
                    self._sizes[uri] = _dir_size(path)
                    if add_ref:
                        self._refs[uri] = self._refs.get(uri, 0) + 1
                    self._evict_locked()
                return path
            finally:
                # prune the per-URI lock: fingerprinted URIs are minted per
                # content version, so keeping them would grow without bound
                with self._lock:
                    self._creation_locks.pop(uri, None)

    def add_reference(self, uri: str) -> None:
        with self._lock:
            self._refs[uri] = self._refs.get(uri, 0) + 1

    def remove_reference(self, uri: str) -> None:
        with self._lock:
            n = self._refs.get(uri, 0) - 1
            if n <= 0:
                self._refs.pop(uri, None)
            else:
                self._refs[uri] = n
            self._evict_locked()

    def get(self, uri: str) -> Optional[str]:
        with self._lock:
            return self._entries.get(uri)

    def describe(self):
        """Cache rows for the state API: uri, local path, refs, bytes."""
        with self._lock:
            return [
                {
                    "uri": uri,
                    "path": path,
                    "ref_count": self._refs.get(uri, 0),
                    "size_bytes": self._sizes.get(uri, 0),
                }
                for uri, path in self._entries.items()
            ]

    def total_size(self) -> int:
        with self._lock:
            return sum(self._sizes.values())

    def _evict_locked(self) -> None:
        total = sum(self._sizes.values())
        for uri in list(self._entries):
            if total <= self.max_total_size_bytes:
                break
            if self._refs.get(uri, 0) > 0:
                continue
            path = self._entries.pop(uri)
            total -= self._sizes.pop(uri, 0)
            shutil.rmtree(path, ignore_errors=True)
