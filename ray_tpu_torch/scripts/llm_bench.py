"""Continuous-batching LLM decode throughput on the current device.

Measures the serving engine's aggregate generated-tokens/s with a full
slot pool of concurrent requests — the serving-side counterpart of
``bench.py``'s ``model_train_step`` row.  The reference delegates LLM
serving to vLLM (``python/ray/llm/``); this engine is in-tree
(``ray_tpu_torch/serve/llm.py``), so its number documents the beyond-parity
surface rather than competing with a reference baseline.

The port's copy of ``ray_tpu/scripts/llm_bench.py``: the same 284M decoder,
slots, prompts and waves, on the engine's default paged KV pool, so every
decode step launches the paged decode kernel once a layer (16 a step).
It runs on CUDA unless ``device="cpu"`` is given, and raises where there is
no CUDA device.  ``RAY_TPU_LLM_BENCH_TINY`` runs the reference's tiny
config (head_dim 8) on the CPU; on the card, whose decode kernel takes
head_dim 64 or 128, the tiny run widens to ``d_model=256, n_heads=4,
n_kv_heads=2``.  ``RAY_TPU_LLM_BENCH_CHUNK`` sets the engine's decode chunk.

Usage: python -m ray_tpu_torch.scripts.llm_bench [out.json]
Prints one JSON line; optionally writes it to the given path.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time


def main(out_path: str | None = None, device=None) -> dict:
    import torch

    from ray_tpu_torch.models.common import default_device
    from ray_tpu_torch.models.transformer import TransformerConfig, init_params
    from ray_tpu_torch.ops.decode_attention import paged_decode_attention
    from ray_tpu_torch.serve.llm import LLMEngine

    dev = default_device(device, "llm_bench")
    if os.environ.get("RAY_TPU_LLM_BENCH_TINY"):
        # in-suite smoke: exercises the same waves/warmup/accounting paths
        width = ({"d_model": 32, "n_heads": 4, "n_kv_heads": 2} if dev.type == "cpu"
                 else {"d_model": 256, "n_heads": 4, "n_kv_heads": 2})
        cfg = TransformerConfig(
            vocab_size=97, n_layers=2, d_ff=64, max_seq_len=128, attention="dense",
            dtype=torch.float32, **width,
        )
        B, new_tokens, prompt_len, seq_cap = 2, 4, 3, 128
    else:
        # serving-class decoder: ~284M params (GPT-2-medium scale, tied
        # embeddings), bf16, GQA 16q/8kv
        cfg = TransformerConfig(
            vocab_size=32000, d_model=1024, n_layers=16, n_heads=16, n_kv_heads=8,
            d_ff=4096, max_seq_len=1024, attention="dense", dtype=torch.bfloat16,
        )
        B, new_tokens, prompt_len, seq_cap = 8, 128, 64, 1024
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in (params["embed"], params["final_norm"],
                                       *params["layers"].values()))

    chunk = int(os.environ.get("RAY_TPU_LLM_BENCH_CHUNK", "1"))
    engine = LLMEngine(
        cfg, params, device=dev, max_batch_size=B, max_seq_len=seq_cap, decode_chunk=chunk
    )
    # count the loop's decode steps (the paged kernel launches once a layer
    # in each); the count lives in a list, not on an object the loop holds
    steps = [0]
    step = engine._step

    def counted_step():
        steps[0] += 1
        step()

    engine._step = counted_step
    try:
        vocab_span = cfg.vocab_size - 2
        prompts = [
            [(7 * i + j) % vocab_span + 1 for j in range(prompt_len)] for i in range(B)
        ]

        def run_wave() -> int:
            done = []
            errors = []
            lock = threading.Lock()

            def one(p):
                try:
                    out = engine.generate(p, max_tokens=new_tokens, temperature=0)
                    with lock:
                        done.append(len(out))
                except BaseException as exc:  # noqa: BLE001 — re-raised below
                    with lock:
                        errors.append(exc)

            ts = [threading.Thread(target=one, args=(p,)) for p in prompts]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            if errors:
                # a partial wave would print a silently-wrong throughput
                raise errors[0]
            return sum(done)

        run_wave()  # warmup: cuBLAS handles, the kernels' first load
        steps0 = steps[0]
        k1_0 = paged_decode_attention.launches
        t0 = time.perf_counter()
        waves = 3
        total = sum(run_wave() for _ in range(waves))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        decode_steps = steps[0] - steps0
        k1 = paged_decode_attention.launches - k1_0
    finally:
        engine.shutdown()

    result = {
        "metric": "llm_decode_throughput",
        "value": round(total / dt, 1),
        "unit": "tokens/s",
        "extra": {
            "params_millions": round(n_params / 1e6, 1),
            "decode_chunk": chunk,
            "batch_slots": B,
            "new_tokens_per_request": new_tokens,
            "prompt_len": prompt_len,
            "waves": waves,
            "total_tokens": total,
            "wall_s": round(dt, 2),
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "cache_kind": engine.cache_kind,
            "decode_steps": decode_steps,
            "k1_launches": k1,
        },
    }
    print(json.dumps(result))
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
