"""Task functions and actor classes of ``tests/test_torch_runtime.py``.

Worker processes of both packages import these by module name, so this
module imports only the standard library and numpy: no JAX, neither package
and no torch (whose import would cost every worker seconds).
"""

import os
import sys
import time

import numpy as np

def _inc(x):
    return x + 1


def _scale(a, k):
    return a * k


def _total(*parts):
    return float(sum(float(p.sum()) for p in parts))


def _checksum(a):
    return float(a.sum()), a.dtype.str, a.shape


def _boom(x):
    raise ValueError(f"bad input {x}")


def _sleep(s):
    time.sleep(s)
    return s


def _flaky(path, fail_times):
    with open(path, "a") as f:
        f.write("x")
    with open(path) as f:
        attempts = len(f.read())
    if attempts <= fail_times:
        raise RuntimeError(f"attempt {attempts} failed")
    return attempts


def _squares(n):
    for i in range(n):
        yield i * i


def _squares_then_fail(n):
    for i in range(n):
        yield i
    raise KeyError("stream broke")


def _payload(seed, nbytes):
    return np.random.default_rng(seed).bytes(nbytes)


def _host_view(x):
    """What a worker sees of an array argument: its kind, dtype and values
    as float32 numpy, plus whether the process holds a CUDA context."""
    cuda = sys.modules.get("torch") is not None and sys.modules["torch"].cuda.is_initialized()
    if type(x).__module__.startswith("torch"):
        return "tensor", str(x.dtype).removeprefix("torch."), x.float().numpy(), cuda
    return "ndarray", str(x.dtype), np.asarray(x).astype(np.float32), cuda


def _value_facts(x):
    """A bulk argument as a worker received it: its type, dtype, sum,
    shape, and the worker's pid."""
    total = x.float().sum() if hasattr(x, "float") else x.sum()
    return type(x).__name__, str(x.dtype), float(total), tuple(x.shape), os.getpid()


def _worker_facts():
    """What a worker process is: its command line, the top-level packages it
    has imported among those a port worker must not load, whether torch is
    loaded and sees a card, and its pid."""
    with open("/proc/self/cmdline", "rb") as f:
        argv = [a.decode() for a in f.read().split(b"\0") if a]
    roots = {m.split(".")[0] for m in sys.modules}
    torch_mod = sys.modules.get("torch")
    return {
        "argv": argv,
        "forbidden": sorted(roots & {"jax", "jaxlib", "ray_tpu"}),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "torch_sees_cuda": None if torch_mod is None else torch_mod.cuda.is_available(),
        "pid": os.getpid(),
    }


class Counter:
    def __init__(self, start):
        self.n = start

    def add(self, k):
        self.n += k
        return self.n

    def pid(self):
        return os.getpid()
