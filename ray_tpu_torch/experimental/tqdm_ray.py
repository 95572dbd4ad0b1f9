"""Multi-bar-safe progress bars.

The port's copy of ``ray_tpu/experimental/tqdm_ray.py``: the same behaviour, imports renamed
to ``ray_tpu_torch``.

Parity: ``python/ray/experimental/tqdm_ray.py`` — a tqdm-compatible surface
where concurrent bars each own a terminal row (ANSI cursor positioning under
one process-wide lock) instead of shredding each other's ``\\r`` rewrites,
plus ``safe_print`` for interleaving plain output with live bars.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Optional

_lock = threading.Lock()
_instances: dict = {}
_next_uuid = 0


class tqdm:
    """Minimal tqdm-compatible surface: update/set_description/close, iterable
    wrapping, positioned line rendering."""

    def __init__(self, iterable=None, desc: str = "", total: Optional[int] = None, position: Optional[int] = None, **_kw):
        global _next_uuid
        self._iterable = iterable
        self.desc = desc
        self.total = total if total is not None else (len(iterable) if hasattr(iterable, "__len__") else None)
        self.n = 0
        self._start = time.time()
        self._last_render = 0.0
        self._closed = False
        with _lock:
            _next_uuid += 1
            self._uuid = _next_uuid
            self.position = position if position is not None else len(_instances)
            _instances[self._uuid] = self

    # ------------------------------------------------------------------
    def update(self, n: int = 1) -> None:
        self.n += n
        self._maybe_render()

    def set_description(self, desc: str) -> None:
        self.desc = desc
        self._maybe_render()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._render(final=True)
        with _lock:
            _instances.pop(self._uuid, None)

    def __iter__(self):
        for item in self._iterable:
            yield item
            self.update(1)
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    def _maybe_render(self) -> None:
        now = time.time()
        if now - self._last_render >= 0.1:
            self._render()

    def _render(self, final: bool = False) -> None:
        self._last_render = time.time()
        if os.environ.get("RAY_TPU_DISABLE_PBAR"):
            return
        rate = self.n / max(self._last_render - self._start, 1e-9)
        if self.total:
            frac = min(self.n / self.total, 1.0)
            filled = int(frac * 20)
            bar = "#" * filled + "-" * (20 - filled)
            line = f"{self.desc} |{bar}| {self.n}/{self.total} [{rate:.1f} it/s]"
        else:
            line = f"{self.desc} {self.n} [{rate:.1f} it/s]"
        with _lock:
            pos = self.position
            if pos > 0:
                # own row per bar: move down, rewrite, move back (all under
                # the lock so concurrent bars never interleave escape codes)
                sys.stderr.write(f"\x1b[{pos}B\r\x1b[K" + line + f"\x1b[{pos}A\r")
            else:
                sys.stderr.write("\r\x1b[K" + line)
            if final and pos == 0:
                sys.stderr.write(os.linesep)
            sys.stderr.flush()


def safe_print(*args, **kwargs) -> None:
    """Print without tearing active bars (reference tqdm_ray.safe_print)."""
    with _lock:
        sys.stderr.write("\r\033[K")
        print(*args, **kwargs)
