"""Channels: pre-allocated single-slot buffers for compiled-DAG transport.

The port's copy of ``ray_tpu/dag/channel.py``.  Reference parity:
``python/ray/experimental/channel/shared_memory_channel.py`` (mutable plasma
channels) and ``torch_tensor_nccl_channel.py`` (NCCL tensor channels).  The
host channel is a condition-variable slot (same-process runtime), and the
device channel holds a ``torch.Tensor`` on a CUDA device: handing a tensor
between stages is a reference move, and a placement onto another device is
a device-to-device copy by ``tensor.to``.

Stream order.  The writer and the reader of a slot are different threads
(two in-process actors, or a stage thread and the driver), and either may
compute on a stream other than the device's default one.  A CUDA tensor
written into a slot therefore carries a :class:`StreamFence`: an event
recorded on the writer's current stream once the slot is taken.  The
reader, if its current stream differs, makes that stream wait on the event
(no host synchronisation) and calls ``record_stream`` on the tensor, so the
caching allocator does not hand its memory out again before the reader's
work is done, even when the writer drops its reference first.

The fence orders the streams current in the threads that write and read a
slot.  In a plan those are the driver (entry and output channels) and the
stage threads; an actor's method runs on its actor's thread in between.  A
method that computes on a side stream of its own follows PyTorch's rule
for any function that does: its current stream waits for the side stream
before it returns (``torch.cuda.current_stream().wait_stream(s)``), and
the side stream waits for the current one before it reads its inputs.
"""

from __future__ import annotations

import sys
import threading
from typing import Any, List, Optional, Tuple


class ChannelClosed(Exception):
    pass


def _tensor_type():
    torch = sys.modules.get("torch")
    return None if torch is None else torch.Tensor


def _cuda_leaves(value: Any, out: List[Any], depth: int = 0) -> List[Any]:
    """The CUDA tensors in ``value`` (itself, or inside lists, tuples and
    dict values, a few levels deep)."""
    tensor = _tensor_type()
    if tensor is None:
        return out
    if isinstance(value, tensor):
        if value.is_cuda:
            out.append(value)
    elif depth < 4 and isinstance(value, (list, tuple)):
        for v in value:
            _cuda_leaves(v, out, depth + 1)
    elif depth < 4 and isinstance(value, dict):
        for v in value.values():
            _cuda_leaves(v, out, depth + 1)
    return out


class StreamFence:
    """The writer's side of a cross-thread CUDA hand-off: the streams the
    tensors were written on, each with an event recorded on it."""

    __slots__ = ("_marks",)

    def __init__(self, marks: List[Tuple[Any, Any]]):
        self._marks = marks  # [(stream, event)] one per device written on

    @staticmethod
    def record(value: Any) -> Optional["StreamFence"]:
        tensors = _cuda_leaves(value, [])
        if not tensors:
            return None
        import torch

        marks = []
        seen = set()
        for t in tensors:
            if t.device in seen:
                continue
            seen.add(t.device)
            stream = torch.cuda.current_stream(t.device)
            event = torch.cuda.Event()
            event.record(stream)
            marks.append((stream, event))
        return StreamFence(marks)

    def join(self, value: Any) -> None:
        """Reader's side: order the reader's current stream after the
        writer's work on every device where the two streams differ."""
        import torch

        waited = {}
        for stream, event in self._marks:
            mine = torch.cuda.current_stream(stream.device)
            if mine != stream:
                mine.wait_event(event)
                waited[stream.device] = mine
        if waited:
            for t in _cuda_leaves(value, []):
                mine = waited.get(t.device)
                if mine is not None:
                    t.record_stream(mine)


def device_place(value: Any, device=None) -> Any:
    """Place ``value`` on ``device``; with none given, on the caller's
    current CUDA device when there is one, else leave it where it is (as
    ``jax.device_put`` does on the CPU backend).

    The single placement primitive shared by :class:`DeviceChannel` and the
    device-kind ``SeqChannel`` in ``runtime/channel_manager.py``: a
    device-to-device copy when source and target differ, a no-op reference
    move when the tensor is already resident.  A numpy array becomes a
    tensor (one copy to the card where there is one); lists, tuples and
    dicts are placed leaf by leaf; any other value is returned as is."""
    import numpy as np
    import torch

    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    if isinstance(value, torch.Tensor):
        return value if device is None else value.to(device)
    if isinstance(value, np.ndarray):
        host = torch.from_numpy(value if value.flags.writeable else value.copy())
        return host if device is None else host.to(device)
    if isinstance(value, (list, tuple)):
        return type(value)(device_place(v, device) for v in value)
    if isinstance(value, dict):
        return {k: device_place(v, device) for k, v in value.items()}
    return value


class Channel:
    """Single-slot rendezvous buffer: write blocks while full, read blocks
    while empty (the mutable-plasma-channel protocol)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._full = False
        self._value: Any = None
        self._fence: Optional[StreamFence] = None
        self._closed = False

    def write(self, value: Any, timeout: Optional[float] = None) -> None:
        with self._cond:
            if not self._cond.wait_for(lambda: not self._full or self._closed, timeout):
                raise TimeoutError("channel write timed out")
            if self._closed:
                raise ChannelClosed()
            # placement (the _place hook) runs AFTER the slot is acquired:
            # under backpressure the pre-placement value must not already be
            # on the target device: that holds TWO copies in device memory
            # for the whole wait (DeviceChannel's copy happens here)
            self._value = self._place(value)
            self._fence = StreamFence.record(self._value)
            self._full = True
            self._cond.notify_all()

    @staticmethod
    def _place(value: Any) -> Any:
        return value

    def read(self, timeout: Optional[float] = None) -> Any:
        with self._cond:
            if not self._cond.wait_for(lambda: self._full or self._closed, timeout):
                raise TimeoutError("channel read timed out")
            if self._closed and not self._full:
                raise ChannelClosed()
            value, fence = self._value, self._fence
            self._value = self._fence = None
            self._full = False
            self._cond.notify_all()
        if fence is not None:
            fence.join(value)
        return value

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()


class DeviceChannel(Channel):
    """Channel whose payloads are tensors on a device.

    Writing moves the tensor to the channel's device (a device-to-device
    copy when source and target differ; no-op when already resident)
    without a host round trip: the NCCL-channel equivalent for threads of
    one process.
    """

    def __init__(self, device=None):
        super().__init__()
        self._device = device

    def _place(self, value: Any) -> Any:
        # runs inside write() AFTER the slot is free: a writer blocked on a
        # full channel holds only the source copy, never a second one on
        # the target device (the copy is deferred until it can be consumed)
        if self._device is not None:
            value = device_place(value, self._device)
        return value
