#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                    # every phase, as a release check
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --phases build,kernels,train_parity,train   # the training slice
    python3 chip_smoke.py --phases build,profile   # one profiled train step (not in the default run)

Phases, each printing one JSON line; any failure exits non-zero:

1. ``build``   — nvcc builds every kernel from ``ray_tpu_torch/ops/csrc``.
2. ``kernel``  — one line per kernel: the kernel against its plain PyTorch
   version on the card, at the main paths' shapes plus edge cases, in f32
   (atol 1e-4: only the summation order differs) and bf16 (atol and rtol
   2e-2: bf16 keeps about 3 digits); the backward kernels also run twice and
   must give the same bits; device times of the kernel, the plain version
   and (where one PyTorch call computes the same function) that call, and
   the least time the card could take (``bound_ms``).
3. ``forward_parity`` — the 284M serving decoder (``llm_bench`` config:
   vocab 32000, d_model 1024, 16 layers, 16 heads / 8 kv heads, d_ff 4096)
   in f32 activations from a seeded generator: a paged prefill + 4 paged
   decode steps and a dense prefill + decode steps, through the kernels and
   through the plain path; logits within atol 1e-3, greedy tokens identical,
   and ``generate()`` equal to the plain greedy tokens.
4. ``engine``  — the paged ``LLMEngine`` at full width in bf16 serving 8
   concurrent requests (prompt 64, 32 tokens, greedy), then the dense
   engine; launch counters are zeroed just before each run and read just
   after, and every kernel of the run must have launched.
5. ``train_parity`` — the 602M train-step decoder of ``bench.py`` (vocab
   32000, d_model 2048, 8 layers, 16 heads, d_ff 8192, T 2048) in f32
   activations, batch 1: loss and every gradient leaf through the flash
   kernels (``attention="flash"``) against the einsum attention
   (``attention="dense"``): loss within 1e-4, each leaf's max error within
   1e-3 of that leaf's largest gradient.
6. ``train``   — the same decoder as ``bench.py`` trains it (bf16, batch 6,
   ``remat="dots"``): 5 AdamW steps on a repeated batch, counters zeroed
   before and read after each step (K4 = K5 = 8, K3 = 16 a step), every loss
   finite and the last below the first; step ms (CUDA events), tokens/s and
   the model FLOP share of 989 TFLOP/s. The state after step 2 is saved
   through ``Checkpoint.from_pytree`` and restored into a fresh state: step 3
   from both, with deterministic algorithms on, gives bitwise equal losses.
7. ``{"kernels": [...]}`` — per kernel: route, source, the TPU kernel it
   replaces, launches in the engine and train runs, max error, device ms,
   plain ms, bound ms and what bounds it, library ms.

Then the card's name and power limit (``nvidia-smi``), and as the last line
``{"ok": true, "device": {...}}``. Exits non-zero without a result when no
CUDA device is present or the package is missing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, dense FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

PHASES = ("build", "kernels", "forward_parity", "engine", "train_parity", "train")
OPTIONAL_PHASES = ("profile",)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def device_ms(fn, reps: int = 25) -> float:
    """Median device time of one ``fn()`` call. The stream is held busy
    while all calls are enqueued, so host launch overhead is not counted:
    each pair of events brackets one call running back to back."""
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


def bound(nbytes: int, flops: int, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want, atol: float, rtol: float, what: str) -> float:
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(
            f"{what}: {int(bad.sum())} elements off, max abs err {float(err.max()):.3e}"
        )
    return float(err.max())


TOLS = {"float32": (1e-4, 0.0), "bfloat16": (2e-2, 2e-2)}

# attention inside the train step of bench.py model_mfu: batch 6, 16 heads,
# T 2048, head_dim 128
TRAIN_ATTN = (6, 16, 2048, 128)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------
def _paged_case(g, B, H, Hkv, D, bs, M, N, lengths, dtype):
    import torch

    q = torch.randn(B, H, D, generator=g, device="cuda").to(dtype)
    kp = torch.randn(N, bs, Hkv, D, generator=g, device="cuda").to(dtype)
    vp = torch.randn(N, bs, Hkv, D, generator=g, device="cuda").to(dtype)
    # shuffled physical placement; entries past each row's length -> page 0
    perm = torch.randperm(N - 1, generator=g, device="cuda")[: B * M] + 1
    bt = perm.reshape(B, M).to(torch.int32)
    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    used = -(-lengths.long() // bs)
    bt = torch.where(torch.arange(M, device="cuda")[None, :] < used[:, None], bt, 0)
    return q, kp, vp, bt.contiguous(), lengths


def kernel_paged_decode(torch, g):
    from ray_tpu_torch.ops.decode_attention import _paged_decode_plain, paged_decode_attention

    def run(case, use_kernel):
        q, kp, vp, bt, ln = case
        return paged_decode_attention(q, kp, vp, bt, ln, use_kernel=use_kernel)

    B, H, Hkv, D, bs, M = 8, 16, 8, 64, 16, 64
    N = B * M + 1
    main_len = torch.randint(64, 97, (B,), generator=g, device="cuda").tolist()
    cases = {
        "main": (B, H, Hkv, D, bs, M, N, main_len),
        "zero_and_ragged": (B, H, Hkv, D, bs, M, N, [0, 1, 15, 16, 17, 1024, 500, 33]),
        "d128_nrep4": (3, 16, 4, 128, 16, 8, 25, [0, 77, 128]),
    }
    errs = {}
    for dt in ("float32", "bfloat16"):
        for name, shape in cases.items():
            case = _paged_case(g, *shape, dtype=getattr(torch, dt))
            atol, rtol = TOLS[dt]
            errs[f"{name}/{dt}"] = max_err(
                run(case, None), run(case, False), atol, rtol, f"paged_decode {name} {dt}"
            )
    torch.cuda.synchronize()
    case = _paged_case(g, *cases["main"], dtype=torch.bfloat16)
    q, kp, vp, bt, ln = case
    n_tok = int(ln.sum())
    nbytes = (2 * q.numel() * 2 + n_tok * Hkv * D * 2 * 2 + bt.numel() * 4 + B * 4)
    flops = 4 * n_tok * H * D
    scale = D ** -0.5
    return dict(
        name="paged_decode_attention",
        source="ray_tpu_torch/ops/csrc/decode_attention.cu",
        replaces="ray_tpu/ops/decode_attention.py:158 _paged_decode_kernel "
                 "(pallas_call at :290)",
        shapes=f"q[{B},{H},{D}] pages[{N},{bs},{Hkv},{D}] tables[{B},{M}] bf16",
        errs=errs, max_abs_err=errs["main/bfloat16"],
        kernel_ms=device_ms(lambda: run(case, None)),
        plain_ms=device_ms(lambda: _paged_decode_plain(q, kp, vp, bt, ln, scale)),
        library_ms=None,
        bound=bound(nbytes, flops, "bfloat16"),
    )


def _dense_case(g, B, H, Hkv, S, D, lengths, dtype):
    import torch

    q = torch.randn(B, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, Hkv, S, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, Hkv, S, D, generator=g, device="cuda").to(dtype)
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device="cuda")


def kernel_dense_decode(torch, g):
    import torch.nn.functional as F

    from ray_tpu_torch.ops.decode_attention import _decode_plain, decode_attention

    def run(case, use_kernel):
        q, k, v, ln = case
        return decode_attention(q, k, v, ln, use_kernel=use_kernel)

    B, H, Hkv, S, D = 8, 16, 8, 1024, 64
    main_len = torch.randint(64, 97, (B,), generator=g, device="cuda").tolist()
    cases = {
        "main": (B, H, Hkv, S, D, main_len),
        "zero_and_ragged": (B, H, Hkv, S, D, [0, 1, 63, 64, 65, 1000, 1024, 7]),
        "s_not_tile_multiple": (4, H, Hkv, 1000, D, [1000, 999, 0, 531]),
        "d128_nrep4": (3, 16, 4, 300, 128, [0, 77, 300]),
    }
    errs = {}
    for dt in ("float32", "bfloat16"):
        for name, shape in cases.items():
            case = _dense_case(g, *shape, dtype=getattr(torch, dt))
            atol, rtol = TOLS[dt]
            errs[f"{name}/{dt}"] = max_err(
                run(case, None), run(case, False), atol, rtol, f"decode {name} {dt}"
            )
    case = _dense_case(g, *cases["main"], dtype=torch.bfloat16)
    q, k, v, ln = case
    n_tok = int(ln.sum())
    nbytes = 2 * q.numel() * 2 + n_tok * Hkv * D * 2 * 2 + B * 4
    flops = 4 * n_tok * H * D
    scale = D ** -0.5
    # the yardstick: one SDPA call over the same cache, lengths as a mask
    mask = (torch.arange(S, device="cuda")[None, :] < ln[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    kr = k.repeat_interleave(H // Hkv, dim=1)
    vr = v.repeat_interleave(H // Hkv, dim=1)
    lib = device_ms(lambda: F.scaled_dot_product_attention(q4, kr, vr, attn_mask=mask))
    return dict(
        name="decode_attention",
        source="ray_tpu_torch/ops/csrc/decode_attention.cu",
        replaces="ray_tpu/ops/decode_attention.py:47 _decode_kernel (pallas_call at :134)",
        shapes=f"q[{B},{H},{D}] k/v[{B},{Hkv},{S},{D}] bf16",
        errs=errs, max_abs_err=errs["main/bfloat16"],
        kernel_ms=device_ms(lambda: run(case, None)),
        plain_ms=device_ms(lambda: _decode_plain(q, k, v, ln, scale)),
        library_ms=lib,
        library_call="scaled_dot_product_attention(q, k/v repeated to H heads, attn_mask)",
        bound=bound(nbytes, flops, "bfloat16"),
    )


def kernel_flash_forward(torch, g):
    import torch.nn.functional as F

    from ray_tpu_torch.ops.attention import _flash_forward_plain, flash_attention_with_lse

    def mk(B, H, Tq, Tk, D, dtype):
        q = torch.randn(B, H, Tq, D, generator=g, device="cuda").to(dtype)
        k = torch.randn(B, H, Tk, D, generator=g, device="cuda").to(dtype)
        v = torch.randn(B, H, Tk, D, generator=g, device="cuda").to(dtype)
        return q, k, v

    cases = {  # (B, H, Tq, Tk, D, causal, window)
        "main": (1, 16, 64, 64, 64, True, None),
        "ragged_causal": (2, 4, 100, 100, 64, True, None),
        "ragged_noncausal": (2, 4, 37, 100, 64, False, None),
        "window_causal": (1, 4, 200, 200, 64, True, 16),
        "window_noncausal": (1, 4, 150, 150, 64, False, 40),
        "d128": (1, 8, 77, 77, 128, True, None),
        "train_shape": (*TRAIN_ATTN[:3], TRAIN_ATTN[2], TRAIN_ATTN[3], True, None),
    }
    errs = {}
    for dt in ("float32", "bfloat16"):
        atol, rtol = TOLS[dt]
        for name, (B, H, Tq, Tk, D, causal, window) in cases.items():
            q, k, v = mk(B, H, Tq, Tk, D, getattr(torch, dt))
            o_k, lse_k = flash_attention_with_lse(q, k, v, None, causal, window)
            o_p, lse_p = flash_attention_with_lse(q, k, v, None, causal, window, use_kernel=False)
            errs[f"{name}/{dt}"] = max_err(o_k, o_p, atol, rtol, f"flash {name} {dt}")
            max_err(lse_k, lse_p, 1e-4, 1e-5, f"flash lse {name} {dt}")
    def measure(B, H, T, D):
        q, k, v = mk(B, H, T, T, D, torch.bfloat16)
        nbytes = 4 * B * H * T * D * 2 + B * H * T * 4
        flops = 4 * B * H * D * (T * (T + 1) // 2)
        return dict(
            kernel_ms=device_ms(lambda: flash_attention_with_lse(q, k, v, None, True)),
            plain_ms=device_ms(lambda: _flash_forward_plain(q, k, v, D ** -0.5, True)),
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)),
            bound=bound(nbytes, flops, "bfloat16"),
        )

    # the serving path's prefill shape, and the train step's (bench.py model_mfu)
    train = measure(*TRAIN_ATTN)
    train["bound_ms"], train["bound_by"] = train.pop("bound")
    B, H, T, D = 1, 16, 64, 64
    return dict(
        name="flash_attention_forward",
        source="ray_tpu_torch/ops/csrc/attention.cu",
        replaces="ray_tpu/ops/attention.py:62 _attn_fwd_kernel (pallas_call at :156)",
        shapes=f"q/k/v[{B},{H},{T},{D}] causal bf16",
        errs=errs, max_abs_err=errs["main/bfloat16"],
        library_call="scaled_dot_product_attention(q, k, v, is_causal=True)",
        **measure(B, H, T, D),
        train_shape="q/k/v[{},{},{},{}] causal bf16".format(*TRAIN_ATTN),
        **{f"train_{k}": x for k, x in train.items()},
    )


def kernel_flash_backward(torch, g):
    """K4 and K5, each against its plain version (same q, k, v, dO, lse,
    delta), with a non-zero lse cotangent folded into delta."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as A

    def mk(B, H, Tq, Tk, D, causal, window, dtype):
        q, g_out = (torch.randn(B, H, Tq, D, generator=g, device="cuda").to(dtype)
                    for _ in range(2))
        k, v = (torch.randn(B, H, Tk, D, generator=g, device="cuda").to(dtype) for _ in range(2))
        g_lse = torch.randn(B, H, Tq, generator=g, device="cuda")
        out, lse = A.flash_attention_with_lse(q, k, v, None, causal, window)
        return (q, k, v, g_out, lse, A._delta(out, g_out, g_lse), D ** -0.5, causal, window)

    cases = {  # (B, H, Tq, Tk, D, causal, window)
        "main": (*TRAIN_ATTN[:3], TRAIN_ATTN[2], TRAIN_ATTN[3], True, None),
        "ragged_causal": (2, 4, 100, 100, 64, True, None),
        "ragged_noncausal": (2, 4, 37, 100, 64, False, None),
        "window_causal": (1, 4, 200, 200, 64, True, 16),
        "window_noncausal": (1, 4, 150, 150, 64, False, 40),
        "window_noncausal_empty_rows": (1, 4, 150, 60, 64, False, 40),  # rows >= 99 see no key
        "d128": (1, 8, 77, 77, 128, True, None),
    }
    errs = {"dq": {}, "dkv": {}}
    for dt in ("float32", "bfloat16"):
        atol, rtol = TOLS[dt]
        for name, shape in cases.items():
            a = mk(*shape, getattr(torch, dt))
            dq = A.flash_attention_backward_dq(*a)
            dk, dv = A.flash_attention_backward_dkv(*a)
            dq_p = A._bwd_dq_plain(*a)
            dk_p, dv_p = A._bwd_dkv_plain(*a)
            what = f"{name} {dt}"
            errs["dq"][f"{name}/{dt}"] = max_err(dq, dq_p, atol, rtol, f"backward dq {what}")
            errs["dkv"][f"{name}/{dt}"] = max(max_err(dk, dk_p, atol, rtol, f"backward dk {what}"),
                                              max_err(dv, dv_p, atol, rtol, f"backward dv {what}"))
            # no atomics: a second launch on the same inputs gives the same bits
            dk2, dv2 = A.flash_attention_backward_dkv(*a)
            if not (torch.equal(dq, A.flash_attention_backward_dq(*a))
                    and torch.equal(dk, dk2) and torch.equal(dv, dv2)):
                raise AssertionError(f"backward {what}: two launches gave different bits")
            del a, dq, dk, dv, dq_p, dk_p, dv_p, dk2, dv2
    B, H, T, D = TRAIN_ATTN
    a = mk(B, H, T, T, D, True, None, torch.bfloat16)
    q, k, v, g_out = a[:4]
    # the yardstick: the backward of one SDPA call on the same q, k, v
    ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
    o = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    library_ms = device_ms(lambda: torch.autograd.grad(o, (ql, kl, vl), g_out, retain_graph=True))
    pairs = B * H * int(A._visible(T, T, True, None, "cuda").sum())
    elem = B * H * T * D * 2  # one bf16 [B,H,T,D] tensor
    side = 2 * B * H * T * 4  # lse and delta, f32
    common = dict(shapes=f"q/k/v/dO[{B},{H},{T},{D}] causal bf16, non-zero g_lse",
                  library_ms=library_ms,
                  library_call="backward of scaled_dot_product_attention(q, k, v, "
                               "is_causal=True): dq, dk and dv in one call")
    return [
        dict(name="flash_attention_backward_dq",
             source="ray_tpu_torch/ops/csrc/attention_bwd.cu",
             replaces="ray_tpu/ops/attention.py:188 _bwd_dq_kernel (pallas_call at :319)",
             errs=errs["dq"], max_abs_err=errs["dq"]["main/bfloat16"],
             kernel_ms=device_ms(lambda: A.flash_attention_backward_dq(*a)),
             plain_ms=device_ms(lambda: A._bwd_dq_plain(*a)),
             bound=bound(5 * elem + side, 6 * D * pairs, "bfloat16"), **common),
        dict(name="flash_attention_backward_dkv",
             source="ray_tpu_torch/ops/csrc/attention_bwd.cu",
             replaces="ray_tpu/ops/attention.py:237 _bwd_dkv_kernel (pallas_call at :342)",
             errs=errs["dkv"], max_abs_err=errs["dkv"]["main/bfloat16"],
             kernel_ms=device_ms(lambda: A.flash_attention_backward_dkv(*a)),
             plain_ms=device_ms(lambda: A._bwd_dkv_plain(*a)),
             bound=bound(6 * elem + side, 8 * D * pairs, "bfloat16"), **common),
    ]


# each returns the entries of the kernels line it checks
KERNEL_CHECKS = (
    lambda torch, g: [kernel_paged_decode(torch, g)],
    lambda torch, g: [kernel_dense_decode(torch, g)],
    lambda torch, g: [kernel_flash_forward(torch, g)],
    kernel_flash_backward,
)


# ---------------------------------------------------------------------------
# full-width model phases
# ---------------------------------------------------------------------------
def serving_config(torch):
    from ray_tpu_torch.models.transformer import TransformerConfig

    # ray_tpu/scripts/llm_bench.py: the serving-class decoder (~284M params)
    return TransformerConfig(
        vocab_size=32000, d_model=1024, n_layers=16, n_heads=16, n_kv_heads=8,
        d_ff=4096, max_seq_len=1024, attention="dense", dtype=torch.bfloat16,
    )


def forward_parity(torch, cfg, params):
    from ray_tpu_torch.models import generation as gen

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)
    B, Tp, steps = 2, 64, 4
    lengths = torch.tensor([64, 40], device=dev)
    prompt = torch.randint(1, cfg.vocab_size, (B, Tp), generator=g, device=dev)
    bs, M = 16, cfg.max_seq_len // 16
    perm = torch.randperm(B * M, generator=g, device=dev) + 1
    tables = perm.reshape(B, M).to(torch.int32)
    positions = torch.arange(Tp, device=dev)[None, :].expand(B, Tp)
    valid = positions < lengths[:, None]
    report = {}

    def paged(kernel: bool):
        cache = gen.init_paged_cache(cfg, B * M + 1, bs, device=dev)
        logits, _ = gen.paged_forward_with_cache(
            cfg, params, cache, tables, prompt, positions, valid=valid,
            use_decode_kernel=False,
        )
        out = [logits[torch.arange(B), lengths - 1]]
        for t in range(steps):
            tok = out[-1].argmax(-1)
            lg, _ = gen.paged_decode_step(
                cfg, params, cache, tok, lengths + t, tables, use_decode_kernel=kernel
            )
            out.append(lg)
        return out

    def dense(kernel: bool):
        cache = gen.init_cache(cfg, B, Tp + steps + 1, device=dev)
        last, _ = gen.prefill(cfg, params, cache, prompt, lengths,
                              use_prefill_kernel=kernel, use_decode_kernel=kernel)
        out = [last]
        for t in range(steps):
            tok = out[-1].argmax(-1)
            lg, _ = gen.decode_step(cfg, params, cache, tok, lengths + t,
                                    use_decode_kernel=kernel)
            out.append(lg)
        return out

    with torch.inference_mode():
        for name, fn in (("paged", paged), ("dense", dense)):
            got, want = fn(True), fn(False)
            errs = [max_err(a, b, 1e-3, 0.0, f"{name} logits step {i}")
                    for i, (a, b) in enumerate(zip(got, want))]
            t_got = [x.argmax(-1).tolist() for x in got]
            t_want = [x.argmax(-1).tolist() for x in want]
            if t_got != t_want:
                raise AssertionError(f"{name}: greedy tokens differ {t_got} vs {t_want}")
            report[name] = {"max_abs_err_per_step": errs, "tokens": t_got}
        out, lens = gen.generate(cfg, params, prompt, lengths, max_new_tokens=steps + 1,
                                 temperature=0)
        want = [[report["dense"]["tokens"][s][b] for s in range(steps + 1)] for b in range(B)]
        got = [out[b, int(lengths[b]): int(lengths[b]) + steps + 1].tolist() for b in range(B)]
        if got != want:
            raise AssertionError(f"generate(): {got} vs plain greedy {want}")
        report["generate_tokens"] = got
    return report


def run_engine(torch, cfg, params, cache_kind: str, n_req: int, prompt_len: int,
               max_tokens: int, counters: dict):
    """Serve ``n_req`` concurrent streaming requests; ``counters`` ({kernel
    name: wrapper}) are zeroed just before the burst and read just after."""
    from ray_tpu_torch.serve.llm import LLMEngine

    eng = LLMEngine(cfg, params, device="cuda", max_batch_size=8,
                    max_seq_len=cfg.max_seq_len, kv_block_size=16, cache_kind=cache_kind)
    try:
        eng.generate([5] * prompt_len, max_tokens=2)  # warm-up: cuBLAS handles, kernel load
        torch.cuda.synchronize()
        prompts = [[(7 * i + j) % (cfg.vocab_size - 2) + 1 for j in range(prompt_len)]
                   for i in range(n_req)]
        results = [None] * n_req
        ttft = [None] * n_req

        def client(i):
            t0 = time.perf_counter()
            toks = []
            for tok in eng.submit_stream(prompts[i], max_tokens=max_tokens):
                if not toks:
                    ttft[i] = time.perf_counter() - t0
                toks.append(tok)
            results[i] = toks

        for fn in counters.values():
            fn.launches = 0
        threads = [threading.Thread(target=client, args=(i,)) for i in range(n_req)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
    finally:
        eng.shutdown()
    for i, r in enumerate(results):
        if r is None or len(r) != max_tokens:
            raise AssertionError(f"{cache_kind} request {i} returned {r!r}")
        if not all(0 <= t < cfg.vocab_size for t in r):
            raise AssertionError(f"{cache_kind} request {i}: token out of range")
    n_tok = sum(len(r) for r in results)
    return {
        "cache_kind": cache_kind, "requests": n_req, "prompt_len": prompt_len,
        "max_tokens": max_tokens, "tokens": n_tok, "wall_s": wall,
        "tokens_per_s": n_tok / wall,
        "ttft_s_median": statistics.median(ttft), "ttft_s_max": max(ttft),
        "launches": launches,
    }


def train_config(torch):
    from ray_tpu_torch.models.transformer import TransformerConfig

    # bench.py model_mfu: the single-chip train step (602.6M params), as it
    # runs there on a TPU: bf16 activations, f32 params, flash attention,
    # remat="dots", unrolled layers
    return TransformerConfig(
        vocab_size=32000, d_model=2048, n_layers=8, n_heads=16, d_ff=8192,
        max_seq_len=2048, dtype=torch.bfloat16, attention="flash", remat="dots",
        scan_layers=False,
    )


def named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in named_leaves(v, f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def train_parity(torch, cfg, params):
    """Loss and every gradient leaf through the flash kernels against the
    einsum attention, f32, batch 1."""
    from ray_tpu_torch.models.transformer import loss_and_grads

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (1, cfg.max_seq_len), generator=g, device="cuda")
    res = {}
    for attention in ("flash", "dense"):
        res[attention] = loss_and_grads(dataclasses.replace(cfg, attention=attention),
                                        params, tokens)
    (loss_k, grads_k), (loss_p, grads_p) = res["flash"], res["dense"]
    loss_err = abs(float(loss_k) - float(loss_p))
    if not (torch.isfinite(loss_k) and loss_err <= 1e-4):
        raise AssertionError(f"train_parity: loss {float(loss_k)} vs {float(loss_p)}")
    rel = {}
    for (name, a), (_, b) in zip(named_leaves(grads_k), named_leaves(grads_p)):
        if not torch.isfinite(a).all():
            raise AssertionError(f"train_parity: non-finite grad {name}")
        rel[name] = float((a - b).abs().max() / b.abs().max())
        if rel[name] > 1e-3:
            raise AssertionError(f"train_parity: grad {name} off by {rel[name]:.3e} "
                                 "of its largest element")
    return {"loss_flash": float(loss_k), "loss_dense": float(loss_p), "loss_abs_err": loss_err,
            "grad_max_rel_err": max(rel.values()), "grad_rel_err": rel}


def run_train(torch, cfg, params, counters: dict, steps: int = 5, batch: int = 6):
    """``steps`` AdamW steps on a repeated batch, counters zeroed before
    and read after each; the state after step 2 is checkpointed and step 3
    is taken again from the restored copy (deterministic algorithms on for
    both step 3s): the two losses must be bitwise equal."""
    from ray_tpu_torch.models.transformer import make_train_step, new_train_state
    from ray_tpu_torch.train.checkpoint import Checkpoint

    _, train_step = make_train_step(cfg, device="cuda")
    state = new_train_state(params)
    n_params = sum(p.numel() for _, p in named_leaves(params))
    T = cfg.max_seq_len
    g = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (batch, T), generator=g, device="cuda")
    losses, step_ms, launches = [], [], []

    def one_step(state):
        for fn in counters.values():
            fn.launches = 0
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        state, loss = train_step(state, tokens)
        t1.record()
        torch.cuda.synchronize()
        n = {name: fn.launches for name, fn in counters.items()}
        L = cfg.n_layers
        if not (n["flash_attention_backward_dq"] == n["flash_attention_backward_dkv"] == L
                and n["flash_attention_forward"] >= L):
            raise AssertionError(f"step {len(losses) + 1}: launches {n}")
        losses.append(loss)
        step_ms.append(t0.elapsed_time(t1))
        launches.append(n)
        return state

    torch.cuda.reset_peak_memory_stats()
    state = one_step(one_step(state))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ckpt = Checkpoint.from_pytree(state, base_dir=tmp)
        save_s = time.perf_counter() - t0
        torch.use_deterministic_algorithms(True)
        try:
            state = one_step(state)  # the uninterrupted step 3
            t0 = time.perf_counter()
            restored = ckpt.to_pytree(device="cuda")
            restore_s = time.perf_counter() - t0
            restored, loss_resumed = train_step(restored, tokens)
        finally:
            torch.use_deterministic_algorithms(False)
        if not torch.equal(loss_resumed, losses[2]):
            raise AssertionError(f"resumed step 3 loss {float(loss_resumed)!r} != "
                                 f"{float(losses[2])!r}")
        del restored
    for _ in range(steps - 3):
        state = one_step(state)
    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train: losses {losses}")
    ms = statistics.median(step_ms)
    tokens_per_s = batch * T / (ms / 1e3)
    # bench.py model_mfu's count: fwd+bwd ~= 6 FLOPs/param/token + attention
    flops_per_token = 6 * n_params + 12 * cfg.n_layers * cfg.d_model * T
    return {
        "params": n_params, "batch": batch, "seq": T, "remat": cfg.remat, "losses": losses,
        "step_ms": step_ms, "step_ms_median": ms, "tokens_per_s": tokens_per_s,
        "model_flops_per_token": flops_per_token,
        "flop_share_of_989_tflops": tokens_per_s * flops_per_token / PEAK_FLOPS["bfloat16"],
        "launches_per_step": launches, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "resume_loss_bitwise_equal": True, "checkpoint_save_s": save_s,
        "checkpoint_restore_s": restore_s, "step3_deterministic_algorithms": True,
    }


def profile_train_step(torch, cfg, params, batch: int = 6):
    """One train step (after a warm-up step) under ``torch.profiler``:
    device time by kernel and the device's busy share of the step."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models.transformer import make_train_step, new_train_state

    _, train_step = make_train_step(cfg, device="cuda")
    state = new_train_state(params)
    g = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len), generator=g,
                           device="cuda")
    state, _ = train_step(state, tokens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = train_step(state, tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): a CPU op's row repeats the
    # device time of the kernels it launched
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    groups = {}
    for name, t, _ in rows:
        if "rtt::" in name:  # the port's kernels, by kernel name
            group = re.search(r"::(\w+)<", name).group(1)
        elif any(w in name for w in ("nvjet", "gemm", "cutlass", "sm90_xmma")):
            group = "cublas_matmul"
        else:
            group = "other (elementwise, reductions, copies, optimizer)"
        groups[group] = groups.get(group, 0.0) + t
    busy = sum(r[1] for r in rows)
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "device_busy_share": busy / wall_ms,
            "device_ms_by_group": groups,
            "top": [{"name": n[:120], "device_ms": t, "calls": c} for n, t, c in rows[:15]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES + OPTIONAL_PHASES)}")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if phases - set(PHASES + OPTIONAL_PHASES):
        ap.error(f"unknown phases {sorted(phases - set(PHASES + OPTIONAL_PHASES))}")

    # cuBLAS reads this when CUDA starts; deterministic algorithms (the
    # resume check of the train phase) need it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from ray_tpu_torch.ops import _build
    except ImportError as exc:
        print(f"chip_smoke: the ray_tpu_torch package is missing ({exc})", file=sys.stderr)
        return 1
    from ray_tpu_torch.ops.attention import (
        flash_attention_backward_dkv,
        flash_attention_backward_dq,
        flash_attention_with_lse,
    )
    from ray_tpu_torch.ops.decode_attention import decode_attention, paged_decode_attention

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for log in _build.build_logs().values() for ln in log.splitlines()
             if "Used" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "ok": True, "seconds": build_s, "card": card, "ptxas": ptxas})

    kernels = {}
    if "kernels" in phases:
        g = torch.Generator(device="cuda").manual_seed(0)
        for check in KERNEL_CHECKS:
            for r in check(torch, g):
                r["bound_ms"], r["bound_by"] = r.pop("bound")
                kernels[r["name"]] = r
                emit({"phase": "kernel", "ok": True, "card": card, **r})
            torch.cuda.empty_cache()

    launches = {}  # kernel -> launches over the engine and train runs
    if phases & {"forward_parity", "engine"}:
        cfg = serving_config(torch)
        from ray_tpu_torch.models.transformer import init_params

        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in [params["embed"], params["final_norm"],
                                           *params["layers"].values()])
        init_s = time.perf_counter() - t0
        if "forward_parity" in phases:
            rep = forward_parity(torch, dataclasses.replace(cfg, dtype=torch.float32), params)
            emit({"phase": "forward_parity", "ok": True, "params": n_params,
                  "init_s": init_s, **rep})
        if "engine" in phases:
            paged = run_engine(torch, cfg, params, "paged", 8, 64, 32,
                               {"paged_decode_attention": paged_decode_attention})
            need = cfg.n_layers * 31
            if paged["launches"]["paged_decode_attention"] < need:
                raise AssertionError(f"paged decode kernel launched "
                                     f"{paged['launches']} < {need} times")
            emit({"phase": "engine", "ok": True, "card": card, "params": n_params, **paged})
            dense = run_engine(torch, cfg, params, "dense", 2, 64, 32,
                               {"decode_attention": decode_attention,
                                "flash_attention_forward": flash_attention_with_lse})
            if min(dense["launches"].values()) < 1:
                raise AssertionError(f"dense engine skipped a kernel: {dense['launches']}")
            emit({"phase": "engine", "ok": True, "card": card, **dense})
            launches = {**paged["launches"], **dense["launches"]}
        del params
        torch.cuda.empty_cache()
    if phases & {"train_parity", "train", "profile"}:
        cfg = train_config(torch)
        from ray_tpu_torch.models.transformer import init_params

        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        if "train_parity" in phases:
            rep = train_parity(torch, dataclasses.replace(cfg, dtype=torch.float32), params)
            emit({"phase": "train_parity", "ok": True, "card": card, **rep})
            torch.cuda.empty_cache()
        if "profile" in phases:
            rep = profile_train_step(torch, cfg, params)  # updates params in place
            emit({"phase": "profile", "ok": True, "card": card, **rep})
            params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        if "train" in phases:
            rep = run_train(torch, cfg, params, {
                "flash_attention_forward": flash_attention_with_lse,
                "flash_attention_backward_dq": flash_attention_backward_dq,
                "flash_attention_backward_dkv": flash_attention_backward_dkv,
            })
            emit({"phase": "train", "ok": True, "card": card, **rep})
            for per_step in rep["launches_per_step"]:
                for name, n in per_step.items():
                    launches[name] = launches.get(name, 0) + n
        del params
    if kernels:
        # the K3 entry's ms/bound are its serving prefill shape; train_* keys
        # hold the same numbers at the train step's shape
        emit({"kernels": [
            {"name": n, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
             "launches": launches.get(n), "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
             "library_ms": r["library_ms"],
             **{k: x for k, x in r.items() if k.startswith("train_") and k != "train_shape"}}
            for n, r in kernels.items()
        ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
