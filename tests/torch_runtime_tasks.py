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


# -- runtime environments (tests/test_torch_runtime_env.py) -----------------
def _crunch(n):
    total = 0
    for i in range(n):
        total += i * i
    return total


def _env_flag():
    return os.getpid(), os.environ.get("MY_TASK_FLAG")


def _read_a():
    return os.environ.get("A")


def _gpu_body(marker):
    with open(marker, "w") as f:
        f.write("ran")
    return os.getpid(), os.environ.get("MY_GPU_FLAG"), os.environ.get("CUDA_VISIBLE_DEVICES")


# -- job drivers (tests/test_torch_jobs.py) ----------------------------------
def _env_a():
    return os.environ.get("MY_FLAG")


# -- workflow steps (tests/test_torch_workflow.py) ---------------------------
def _wf_add(a, b):
    return a + b


def _wf_double(x):
    return x * 2


def _wf_ten():
    return 10


def _wf_fail_once(x, marker):
    """x + 5, after raising once while ``marker`` exists (it removes it)."""
    if os.path.exists(marker):
        os.unlink(marker)
        raise RuntimeError("transient failure")
    return x + 5


def _wf_slow():
    time.sleep(0.2)
    return "done"


def _wf_combine(evt, base):
    return {"event": evt, "base": base}


def _wf_unwrap(evt):
    return evt["decision"]


def _wf_boom(x):
    raise ValueError(f"boom {x}")


def _wf_count(path, x):
    """x, after appending a line to ``path`` (how often the step ran)."""
    with open(path, "a") as f:
        f.write("ran\n")
    return x


# -- GPU jobs and workflows on the card (tests/test_torch_cuda.py -k jobs) ---
# head_dim 64: the decode kernel takes 64 or 128
TINY = {"vocab_size": 128, "d_model": 128, "n_layers": 2, "n_heads": 2, "n_kv_heads": 1,
        "d_ff": 256, "max_seq_len": 128}
TINY_PROMPTS = [[(7 * i + j) % 120 + 1 for j in range(16)] for i in range(4)]


def _tiny_config():
    import torch

    from ray_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(**TINY, attention="dense", dtype=torch.bfloat16)


def _tiny_engine(quantize):
    """The tiny bf16 decoder's paged engine on the card from seed 0; K6 on
    every layer linear under ``quantize``."""
    import torch

    from ray_tpu_torch.models.transformer import init_params
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = _tiny_config()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    return LLMEngine(cfg, params, device="cuda", max_batch_size=4, max_seq_len=128,
                     kv_block_size=16, cache_kind="paged", quantize=quantize,
                     quantize_min_size=1024)


def _tiny_burst(quantize, max_tokens=8):
    """The burst through a fresh engine on the card: (tokens, {"k1", "k6",
    "k6_mma", "steps"}) counted over the burst alone."""
    from ray_tpu_torch.ops.decode_attention import paged_decode_attention
    from ray_tpu_torch.ops.quantization import int8_matmul

    eng = _tiny_engine(quantize)
    steps = [0]
    step = eng._step

    def counted():
        steps[0] += 1
        step()

    eng._step = counted
    try:
        eng.generate([5] * 16, max_tokens=2)
        k1, k6 = paged_decode_attention.launches, int8_matmul.launches
        mma, s0 = int8_matmul.launches_by_route["mma_bf16"], steps[0]
        futures = [eng.submit(p, max_tokens=max_tokens) for p in TINY_PROMPTS]
        tokens = [f.result(timeout=300) for f in futures]
        return tokens, {"k1": paged_decode_attention.launches - k1,
                        "k6": int8_matmul.launches - k6,
                        "k6_mma": int8_matmul.launches_by_route["mma_bf16"] - mma,
                        "steps": steps[0] - s0}
    finally:
        eng.shutdown()


def _job_gpu_driver():
    """A GPU job's driver (``JOB_MODE``): ``serve`` prints the float and int8
    bursts' tokens and launches as ``JOBREPORT`` lines; ``loop`` decodes
    until stopped; ``hidden`` builds the engine on its default device."""
    import json

    mode = os.environ["JOB_MODE"]
    if mode == "hidden":
        from ray_tpu_torch.serve.llm import LLMEngine

        LLMEngine(_tiny_config(), {})  # no device named: the card, or it refuses
        print("JOBREPORT " + json.dumps({"served": True}), flush=True)
        return
    if mode == "loop":
        eng = _tiny_engine(False)
        eng.generate(TINY_PROMPTS[0], max_tokens=2)
        print("JOBREPORT " + json.dumps({"ready": True}), flush=True)
        while True:
            eng.generate(TINY_PROMPTS[0], max_tokens=64)
    for quantize in (False, True):
        tokens, n = _tiny_burst(quantize)
        print("JOBREPORT " + json.dumps({"quantize": quantize, "tokens": tokens, **n}), flush=True)


def _wf_gpu_burst(gate, quantize):
    """A workflow's GPU step on the card: the tiny burst (host tokens) and
    its launches."""
    if gate != {"go": True}:
        raise ValueError(gate)
    return _tiny_burst(quantize)


def _wf_check_once(float_run, int8_run, marker):
    if os.path.exists(marker):
        os.unlink(marker)
        raise RuntimeError("the check fails once")
    return {"float": float_run[0], "int8": int8_run[0]}


def _gpu_matmul_task(n):
    import torch

    x = torch.ones(n, n, device="cuda")
    return os.getpid(), os.environ.get("MY_GPU_FLAG"), float((x @ x).sum().item())
