"""Time variants of one kernel source against each other on one card.

A redesign is settled by building the same ``csrc/*.cu`` several times with
different preprocessor definitions (a temporary ``#ifndef X / #define X ...``
switch in the source: a tile size, a stage count, a code path) and timing the
builds in turns inside one process, so that every variant sees the same card,
clocks and inputs::

    python -m ray_tpu_torch.ops.variant_probe dq base: deep:STAGES=4,DEFER=1
    python -m ray_tpu_torch.ops.variant_probe int8 base: nosplit:FORCE1=1
    python -m ray_tpu_torch.ops.variant_probe paged base: alt:X=1

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

Targets: ``dq`` (``attention_bwd.cu::flash_attention_backward_dq``, bf16),
``int8`` (``int8_matmul.cu::int8_matmul``, bf16 x on the tensor-core route),
``paged`` and ``dense`` (``decode_attention.cu::paged_decode_attention`` and
``::decode_attention``: checked in f32 and bf16 on every case of
:func:`decode_cases` at each of ``DECODE_WARPS`` warps a block, timed in
bf16 at the serving step, the full context and batch 64 at each, cold and
warm). Every variant's first line gives its most registers and spilled
bytes. The decode shapes, their input builder and :func:`device_ms` are
also what ``chip_smoke.py`` and the card tests use.
The switches themselves are not kept in the sources once a design is chosen:
PERF.md records which were tried and what each measured.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import os
import random
import re
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


def device_ms(fn, reps: int = 25, between=None) -> float:
    """Median device time of one ``fn()`` call. The stream is held busy
    while all calls are enqueued, so host launch overhead is not counted:
    each pair of events brackets one call running back to back.
    ``between()``, where given, runs before each call outside its events
    (an L2 flush)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(200_000_000)  # ~0.1 s: covers the host's enqueue time
    for s, e in zip(starts, ends):
        if between is not None:
            between()
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


def build_report(log: str) -> dict:
    """Most registers of any kernel and spilled bytes of all, from nvcc's
    ``-Xptxas -v`` output."""
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(a) + int(b) for a, b in
                 re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log))
    return {"max_registers": max(regs, default=0), "spill_bytes": spills}


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
        out, lse = A.flash_attention_with_lse(q, k, v, None, causal, window=window)
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


# decode attention (K1 paged, K2 dense), shared with chip_smoke.py and the
# tests: the llm_bench decoder's heads (16 query, 8 kv, head_dim 64) and cache
# (pages of 16; its max_seq_len 1024 is 64 pages a row, or dense S) at a
# serving decode step (main), at the full context (long) and at batch 64
# (wide); (B, shortest length, longest length, table width)
DECODE_SHAPES = {"main": (8, 64, 96, 1024), "long": (8, 960, 1024, 1024),
                 "wide": (64, 960, 1024, 1024)}
# correctness cases beside them, (B, H, Hkv, D, table width, lengths): every
# n_rep at D 64 and 128, zero, ragged and clamped lengths (past the width),
# rows far shorter than the table, a width of 63 pages
DECODE_CASES = {
    "zero_and_ragged": (8, 16, 8, 64, 1024, [0, 1, 15, 16, 17, 1024, 500, 33]),
    "clamped": (4, 16, 8, 64, 112, [113, 5000, 112, 63]),
    "short_rows": (2, 16, 8, 64, 1024, [3, 40]),
    "odd_width": (4, 16, 8, 64, 1008, [1008, 999, 0, 531]),
    "nrep1": (4, 8, 8, 64, 256, [1, 100, 256, 37]),
    "nrep1_d128": (4, 8, 8, 128, 256, [1, 100, 256, 37]),
    "nrep3": (3, 24, 8, 64, 256, [256, 3, 130]),
    "nrep3_d128": (3, 24, 8, 128, 256, [256, 3, 130]),
    "nrep4_d128": (3, 16, 4, 128, 128, [0, 77, 128]),
    "nrep16": (2, 32, 2, 64, 512, [512, 300]),
    "nrep16_d128": (2, 32, 2, 128, 512, [512, 300]),
}
DECODE_BLOCK_SIZE = 16
# warps a block, timed at each shape
DECODE_WARPS = (4, 8, 16)


def decode_cases(seed: int = 0) -> Dict[str, tuple]:
    """Every decode case as (B, H, Hkv, D, table width, lengths): the timed
    shapes, their lengths drawn from ``seed``, then ``DECODE_CASES``."""
    rng = random.Random(seed)
    timed = {n: (B, 16, 8, 64, w, [rng.randint(lo, hi) for _ in range(B)])
             for n, (B, lo, hi, w) in DECODE_SHAPES.items()}
    return {**timed, **DECODE_CASES}


def decode_inputs(paged: bool, B, H, Hkv, D, width, lengths, dtype, g):
    """Inputs of one decode call on ``g``'s device: (q, k, v, lengths) for
    the dense cache [B, Hkv, width, D], (q, k_pages, v_pages, tables,
    lengths) for a pool of B * width / 16 + 1 pages of 16, each row's at
    shuffled places and its table entries past its length on the garbage
    page 0."""
    import torch

    dev = g.device
    q = torch.randn(B, H, D, generator=g, device=dev).to(dtype)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    if not paged:
        k, v = (torch.randn(B, Hkv, width, D, generator=g, device=dev).to(dtype)
                for _ in range(2))
        return q, k, v, ln
    bs = DECODE_BLOCK_SIZE
    M = width // bs
    N = B * M + 1
    k, v = (torch.randn(N, bs, Hkv, D, generator=g, device=dev).to(dtype) for _ in range(2))
    tables = (torch.randperm(N - 1, generator=g, device=dev) + 1).reshape(B, M).int()
    used = -(-ln.long() // bs)
    tables = torch.where(torch.arange(M, device=dev)[None, :] < used[:, None], tables, 0)
    return q, k, v, tables.contiguous(), ln


def probe_decode(paged: bool, libs: Dict[str, ctypes.CDLL], emit) -> None:
    """Each variant against the plain version (f32 and bf16, every case and
    timed shape, at each of ``DECODE_WARPS``), then timed in bf16 at each
    timed shape and warps, cold (the L2 flushed by reading 2x its size
    between calls) and warm."""
    import torch

    from ray_tpu_torch.ops import decode_attention as A

    g = torch.Generator(device="cuda").manual_seed(0)
    sms = A._sm_count(torch.device("cuda"))
    fn = "paged_decode_attention" if paged else "decode_attention"

    def call(lib, a, warps):
        q, k, v = a[:3]
        ln = a[-1]
        B, H, D = q.shape
        Hkv = k.shape[2] if paged else k.shape[1]
        rows = A.decode_plan(B, Hkv, H // Hkv, sms)[0]
        warps = min(warps, A.max_warps(rows))
        out = torch.empty_like(q)
        code = _build.dtype_code(q)
        if paged:
            tables = a[3]
            err = lib.paged_decode_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), tables.data_ptr(), ln.data_ptr(),
                out.data_ptr(), B, H, Hkv, D, k.shape[1], tables.shape[1], code, D ** -0.5,
                rows, warps, _stream())
        else:
            err = lib.decode_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), ln.data_ptr(), out.data_ptr(), B, H,
                Hkv, k.shape[2], D, code, D ** -0.5, rows, warps, _stream())
        _build.check(err, fn)
        return out

    def plain(a):
        if paged:
            q, k, v, tables, ln = a
            return A._paged_decode_plain(q, k, v, tables, ln, q.shape[-1] ** -0.5)
        q, k, v, ln = a
        return A._decode_plain(q, k, v, ln, q.shape[-1] ** -0.5)

    checks = {}
    for dt in (torch.float32, torch.bfloat16):
        for n, shape in decode_cases().items():
            a = decode_inputs(paged, *shape, dt, g)
            checks[(n, dt)] = (a, plain(a).to(dt))
    for name, lib in libs.items():
        getattr(lib, fn).argtypes = A._PROTOTYPES[fn]
        try:
            for (n, dt), (a, want) in checks.items():
                for warps in DECODE_WARPS:
                    got = call(lib, a, warps)
                    if dt == torch.float32:
                        if not torch.allclose(got, want, atol=1e-4, rtol=0):
                            raise AssertionError(f"{name} {n} f32 {warps} warps: off")
                    else:
                        _check(got, want, f"{name} {n} bf16 {warps} warps")
                    if not torch.equal(got, call(lib, a, warps)):
                        raise AssertionError(f"{name} {n} {warps} warps: two launches differ")
        except (AssertionError, RuntimeError) as exc:
            emit({"variant": name, "failed": str(exc)[:200]})
            libs = {k: x for k, x in libs.items() if k != name}
    flush = torch.empty(2 * L2_BYTES // 4, device="cuda")
    for rnd in range(2):
        for name, lib in libs.items():
            for n, (B, _, _, _) in DECODE_SHAPES.items():
                a = checks[(n, torch.bfloat16)][0]
                policy = A.decode_plan(B, 8, 2, sms)[1]
                for warps in DECODE_WARPS:
                    emit({"variant": name, "round": rnd, "shape": n, "warps": warps,
                          "policy": warps == policy,
                          "ms": device_ms(lambda: call(lib, a, warps),
                                          between=lambda: flush.sum()),
                          "warm_ms": device_ms(lambda: call(lib, a, warps))})


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
    "paged": ("decode_attention.cu", lambda libs, emit: probe_decode(True, libs, emit)),
    "dense": ("decode_attention.cu", lambda libs, emit: probe_decode(False, libs, emit)),
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
            else:
                emit({"variant": name, **build_report(logs[name])})
        probe({n: ctypes.CDLL(p) for n, p in paths.items() if p}, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
