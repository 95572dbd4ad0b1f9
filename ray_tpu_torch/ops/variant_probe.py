"""Time variants of one kernel source against each other on one card.

A redesign is settled by building the same ``csrc/*.cu`` several times with
different preprocessor definitions (a temporary ``#ifndef X / #define X ...``
switch in the source: a tile size, a stage count, a code path) and timing the
builds in turns inside one process, so that every variant sees the same card,
clocks and inputs::

    python -m ray_tpu_torch.ops.variant_probe dq base: deep:STAGES=4,DEFER=1
    python -m ray_tpu_torch.ops.variant_probe int8 base: nosplit:FORCE1=1

Each argument after the target is ``name:DEF=VALUE,DEF=VALUE`` (no
definitions: the source as it stands). All variants compile in parallel, one
``nvcc`` each, into a temporary directory. A variant is first held against the
kernel's plain PyTorch version on every shape (bf16 limits atol = rtol = 2e-2,
two launches bitwise equal) and dropped with a ``"failed"`` line if it
disagrees or does not build; the rest are timed twice round, as
:func:`device_ms` times (CUDA events, the stream pre-filled so the host's
launch cost is not counted). The int8 matmul is timed cold (each call on the
next of several weight copies that together exceed the L2) and warm. One JSON
line a variant and shape, each with the card's name and power limit.

Targets: ``dq`` (``attention_bwd.cu::flash_attention_backward_dq``, bf16) and
``int8`` (``int8_matmul.cu::int8_matmul``, bf16 x on the tensor-core route).
The switches themselves are not kept in the sources once a design is chosen:
PERF.md records which were tried and what each measured.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
from typing import Dict, List, Tuple

from ray_tpu_torch.ops import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
L2_BYTES = 50 * 2**20

# (B, H, Tq, Tk, D, causal, window); "main" is the train step's shape
DQ_SHAPES = {
    "ragged_causal": (2, 4, 100, 100, 64, True, None),
    "window_causal_d128": (1, 4, 200, 200, 128, True, 16),
    "empty_rows": (1, 4, 150, 60, 64, False, 40),
    "noncausal": (2, 4, 37, 100, 64, False, None),
    "t1024_d128": (1, 2, 1024, 1024, 128, True, None),
    "main": (6, 16, 2048, 2048, 128, True, None),
}
DQ_TIMED = ("main", "t1024_d128")
# (M, K, N): the llm_bench decoder's products at decode and prefill, edges, and
# wide outputs (where the kernel takes 8- and 16-byte loads)
INT8_SHAPES = {
    "wq": (8, 1024, 1024), "wk": (8, 1024, 512), "w1": (8, 1024, 4096), "w2": (8, 4096, 1024),
    "prefill": (64, 1024, 4096), "prefill_w2": (64, 4096, 1024), "m16": (16, 1024, 4096),
    "m200": (200, 1024, 4096), "ragged_k": (20, 328, 512), "stream": (8, 4096, 32768),
    "wide_m16": (16, 1024, 16896), "wide_m32": (32, 1024, 16896), "wide_m64": (64, 1024, 16384),
    "m32_n8448": (32, 1024, 8448),
}
INT8_TIMED = ("wq", "wk", "w1", "w2", "prefill", "prefill_w2", "m200", "stream", "wide_m16",
              "wide_m32", "wide_m64", "m32_n8448")


def parse_variants(args: List[str]) -> Dict[str, List[str]]:
    """``["base:", "deep:STAGES=4,DEFER=1"]`` -> ``{"base": [], "deep":
    ["STAGES=4", "DEFER=1"]}``; names must be unique."""
    out: Dict[str, List[str]] = {}
    for a in args:
        name, _, defs = a.partition(":")
        if not name or name in out:
            raise ValueError(f"variant {a!r}: want a unique name before ':'")
        out[name] = [d for d in defs.split(",") if d]
    return out


def device_ms(fn, reps: int = 25) -> float:
    """Median device time of one ``fn()`` call (see ``chip_smoke.py``)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(200_000_000)  # ~0.1 s: covers the host's enqueue time
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def build_variants(source: str, variants: Dict[str, List[str]], out_dir: str):
    """{name: library path or None} and {name: nvcc's output}; one nvcc a
    variant, all started together."""
    jobs = {}
    for name, defs in variants.items():
        lib = os.path.join(out_dir, f"{name}.so")
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.FLAGS, *[f"-D{d}" for d in defs], "-o", lib,
             os.path.join(_build.CSRC, source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for name, (lib, proc) in jobs.items():
        logs[name], _ = proc.communicate()
        libs[name] = lib if proc.returncode == 0 else None
    return libs, logs


def _check(got, want, what: str) -> None:
    import torch

    got, want = got.float(), want.float()
    bad = ~torch.isfinite(got) | ((got - want).abs() > 2e-2 + 2e-2 * want.abs())
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements off")


def _stream() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream


def probe_dq(libs: Dict[str, ctypes.CDLL], emit) -> None:
    import torch

    from ray_tpu_torch.ops import attention as A

    g = torch.Generator(device="cuda").manual_seed(0)

    def case(B, H, Tq, Tk, D, causal, window):
        q, go = (torch.randn(B, H, Tq, D, generator=g, device="cuda").bfloat16() for _ in range(2))
        k, v = (torch.randn(B, H, Tk, D, generator=g, device="cuda").bfloat16() for _ in range(2))
        g_lse = torch.randn(B, H, Tq, generator=g, device="cuda")
        out, lse = A.flash_attention_with_lse(q, k, v, None, causal, window)
        return (q, k, v, go, lse, A._delta(out, go, g_lse), D ** -0.5, causal, window)

    def call(lib, a):
        q, k, v, go, lse, delta, scale, causal, window = a
        B, H, Tq, D = q.shape
        dq = torch.empty_like(q)
        err = lib.flash_attention_backward_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), go.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), B * H, Tq, k.shape[2], D, 1, scale, int(causal),
            int(window or 0), _stream())
        _build.check(err, "flash_attention_backward_dq")
        return dq

    args = {n: case(*s) for n, s in DQ_SHAPES.items()}
    want = {n: A._bwd_dq_plain(*a) for n, a in args.items()}
    good = {}
    for name, lib in libs.items():
        lib.flash_attention_backward_dq.argtypes = [_P] * 7 + [_I] * 5 + [_F, _I, _I, _P]
        try:
            for n, a in args.items():
                got = call(lib, a)
                _check(got, want[n], f"{name} {n}")
                if not torch.equal(got, call(lib, a)):
                    raise AssertionError(f"{name} {n}: two launches gave different bits")
            good[name] = lib
        except (AssertionError, RuntimeError) as exc:
            emit({"variant": name, "failed": str(exc)[:200]})
    for rnd in range(2):
        for name, lib in good.items():
            for n in DQ_TIMED:
                emit({"variant": name, "round": rnd, "shape": n,
                      "ms": device_ms(lambda: call(lib, args[n]))})


def probe_int8(libs: Dict[str, ctypes.CDLL], emit) -> None:
    import torch

    from ray_tpu_torch.ops import quantization as Q

    g = torch.Generator(device="cuda").manual_seed(0)

    def call(lib, x, w_q, s):
        (M, K), N = x.shape, w_q.shape[1]
        out = torch.empty(M, N, dtype=x.dtype, device="cuda")
        err = lib.int8_matmul(x.data_ptr(), w_q.data_ptr(), s.data_ptr(), out.data_ptr(), M, K, N,
                              1, Q._ROUTE_CODES["mma_bf16"], _stream())
        _build.check(err, "int8_matmul")
        return out

    data = {}
    for n, (M, K, N) in INT8_SHAPES.items():
        x = torch.randn(M, K, generator=g, device="cuda").bfloat16()
        ws = []
        for _ in range(max(2, -(-2 * L2_BYTES // (K * N)))):  # copies that exceed the L2
            w_q, s = Q.quantize_int8(torch.randn(K, N, generator=g, device="cuda"), axis=0)
            ws.append((w_q, s.reshape(N).contiguous()))
        data[n] = (x, ws, Q._int8_matmul_plain(x, *ws[0], x.dtype))
    for name, lib in libs.items():
        lib.int8_matmul.argtypes = [_P] * 4 + [_I] * 5 + [_P]
        try:
            for n, (x, ws, want) in data.items():
                got = call(lib, x, *ws[0])
                _check(got, want, f"{name} {n}")
                if not torch.equal(got, call(lib, x, *ws[0])):
                    raise AssertionError(f"{name} {n}: two launches gave different bits")
        except (AssertionError, RuntimeError) as exc:
            emit({"variant": name, "failed": str(exc)[:200]})
            continue
        for n in INT8_TIMED:
            x, ws, _ = data[n]
            nxt = itertools.cycle(ws).__next__
            cold = device_ms(lambda: call(lib, x, *nxt()))
            emit({"variant": name, "shape": n, "cold_ms": cold,
                  "warm_ms": device_ms(lambda: call(lib, x, *ws[0])),
                  "weight_tb_s": x.shape[1] * ws[0][0].shape[1] / (cold * 1e-3) / 1e12})


TARGETS: Dict[str, Tuple[str, object]] = {
    "dq": ("attention_bwd.cu", probe_dq),
    "int8": ("int8_matmul.cu", probe_int8),
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2 or argv[0] not in TARGETS:
        print(f"usage: variant_probe {{{','.join(TARGETS)}}} name:DEF=V,... [name:...]",
              file=sys.stderr)
        return 2
    variants = parse_variants(argv[1:])
    import torch

    if not torch.cuda.is_available():
        print("variant_probe: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]

    def emit(obj) -> None:
        print(json.dumps({"target": argv[0], "card": card, **obj}), flush=True)

    source, probe = TARGETS[argv[0]]
    with tempfile.TemporaryDirectory() as tmp:
        paths, logs = build_variants(source, variants, tmp)
        for name, path in paths.items():
            if path is None:
                emit({"variant": name, "failed": "build: " + logs[name][-400:]})
        probe({n: ctypes.CDLL(p) for n, p in paths.items() if p}, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
