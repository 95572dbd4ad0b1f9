"""The port's scripts (``ray_tpu_torch.scripts``) against the JAX package's,
on the CPU: ``llm_bench`` at its tiny config (``test_serve_llm.py:483``),
``scale_bench`` at a small scale (``test_scale_suite.py``), the
microbenchmark suite's quick rows, ``kernel_bench``'s rows at tiny shapes
on ``device="cpu"``, and the parts of ``quota_scaling`` that touch no
cgroup.  Rates are host timings: compared by key and size, not value.
"""

import contextlib
import importlib
import io

import pytest

torch = pytest.importorskip("torch")

PACKAGES = ("ray_tpu", "ray_tpu_torch")
#: the port's own llm_bench keys (its kernel launch count and cache kind)
PORT_LLM_BENCH_KEYS = {"cache_kind", "decode_steps", "k1_launches"}


def test_llm_bench_tiny_matches_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("RAY_TPU_LLM_BENCH_TINY", "1")
    out = {}
    for name in PACKAGES:
        main = importlib.import_module(name + ".scripts.llm_bench").main
        path = tmp_path / f"{name}.json"
        with contextlib.redirect_stdout(io.StringIO()):
            out[name] = main(str(path)) if name == "ray_tpu" else main(str(path), device="cpu")
        assert path.exists()
    j, p = out["ray_tpu"], out["ray_tpu_torch"]
    assert sorted(p) == sorted(j)
    assert set(p["extra"]) - set(j["extra"]) == PORT_LLM_BENCH_KEYS
    for o in (j, p):
        assert o["metric"] == "llm_decode_throughput" and o["unit"] == "tokens/s"
        assert o["value"] > 0
        assert o["extra"]["total_tokens"] == 2 * 4 * 3  # slots x tokens x waves
    for k in ("decode_chunk", "batch_slots", "new_tokens_per_request", "prompt_len", "waves",
              "params_millions"):
        assert p["extra"][k] == j["extra"][k], k
    assert p["extra"]["device"] == "cpu" and p["extra"]["cache_kind"] == "paged"
    # the plain decode path runs on the CPU: no kernel launch to count
    assert p["extra"]["k1_launches"] == 0 and p["extra"]["decode_steps"] >= 3 * 3


def test_scale_bench_small_matches_jax():
    reports = {}
    for name in PACKAGES:
        rt = importlib.import_module(name)
        sb = importlib.import_module(name + ".scripts.scale_bench")
        rt.init(num_cpus=4)
        try:
            reports[name] = sb.run(rt, scale=0.005)
        finally:
            rt.shutdown()
    j, p = reports["ray_tpu"], reports["ray_tpu_torch"]
    assert sorted(p) == sorted(j) and p["reference"] == j["reference"]
    for k in ("many_actors", "many_tasks", "many_pgs", "vs_reference"):
        assert sorted(p[k]) == sorted(j[k]), k
    for k, n in (("many_actors", "num_actors"), ("many_tasks", "num_tasks"),
                 ("many_pgs", "num_pgs")):
        assert p[k][n] == j[k][n], k
    # no rate floor: the rates are host timings of a loaded box, whose
    # floors test_scale_suite.py holds for the JAX package
    assert all(p[k][r] > 0 for k, r in (("many_actors", "actors_per_s"),
                                         ("many_tasks", "tasks_per_s"), ("many_pgs", "pgs_per_s")))


QUICK_ROWS = ["single_client_tasks_sync", "1_1_actor_calls_sync", "single_client_put_calls",
              "single_client_get_calls", "placement_group_create_removal"]


def test_microbench_quick_rows_match_jax():
    got = {}
    for name in PACKAGES:
        rt = importlib.import_module(name)
        mb = importlib.import_module(name + ".scripts.microbench")
        rt.init(num_cpus=4)
        try:
            got[name] = mb.run_suite(rt, select=QUICK_ROWS, quick=True)
        finally:
            rt.shutdown()
    j, p = got["ray_tpu"], got["ray_tpu_torch"]
    assert list(p) == list(j) == [n for n in QUICK_ROWS]  # the suite's order
    assert {n: u for n, (_, u) in p.items()} == {n: u for n, (_, u) in j.items()}
    assert all(v > 0 for v, _ in p.values())
    from ray_tpu.scripts.microbench import BASELINES as JB
    from ray_tpu_torch.scripts.microbench import BASELINES as PB

    assert PB == JB


#: the rows the port left out until the multi-node runtime was ported
MULTI_NODE_ROWS = ["broadcast_64mb_to_n", "broadcast_root_egress_x", "xproc_object_gigabytes"]


@pytest.mark.parametrize("pkg", ["ray_tpu", "ray_tpu_torch"])
def test_microbench_left_out_rows_say_why(pkg):
    """The three multi-node rows, through both packages: 256 MiB objects
    from a node agent's process (the port's agent for the port), and 64 MiB
    (8 MiB under ``quick``) relayed to four data servers with a root egress
    near the tree's fanout of 2.  The name is historical: the port left
    these rows out, with their reason printed, until the multi-node
    runtime was ported."""
    rt = importlib.import_module(pkg)
    mb = importlib.import_module(pkg + ".scripts.microbench")
    assert not hasattr(mb, "LEFT_OUT")
    rt.init(num_cpus=2)
    try:
        out = mb.run_suite(rt, select=MULTI_NODE_ROWS, quick=True)
    finally:
        rt.shutdown()
    assert sorted(out) == MULTI_NODE_ROWS, out
    assert out["xproc_object_gigabytes"][1] == "GB/s" and out["xproc_object_gigabytes"][0] > 0
    assert out["broadcast_64mb_to_n"][1] == "GB/s" and out["broadcast_64mb_to_n"][0] > 0
    egress, unit = out["broadcast_root_egress_x"]
    assert unit == "x" and 1.9 < egress < 2.2, egress


def test_microbench_device_rows_on_the_cpu():
    """The device rows with ``device="cpu"``: host copies, the channel and
    gang rows, and the LLM capacity row on the reference's decoder."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.scripts.microbench import run_suite

    rows = ["hbm_put_gigabytes", "hbm_get_gigabytes", "device_channel_edge_bw",
            "device_channel_vs_pickle_x", "spmd_pipeline_iter", "llm_paged_capacity_x"]
    rt.init(num_cpus=4)
    try:
        got = run_suite(rt, select=rows, quick=True, device="cpu")
    finally:
        rt.shutdown()
    assert sorted(got) == sorted(rows)
    assert {n: u for n, (_, u) in got.items()} == {
        "hbm_put_gigabytes": "GB/s", "hbm_get_gigabytes": "GB/s",
        "device_channel_edge_bw": "GB/s", "device_channel_vs_pickle_x": "x",
        "spmd_pipeline_iter": "us", "llm_paged_capacity_x": "x"}
    assert got["llm_paged_capacity_x"][0] >= 2.0


def test_kernel_bench_rows_at_tiny_shapes_on_the_cpu():
    from ray_tpu_torch.scripts import kernel_bench as kb

    dec = kb.bench_decode(B=2, H=4, Hkv=2, D=64, S=64, reps=2, warmup=1, device="cpu")
    assert sorted(dec) == sorted(["decode_kernel_us", "decode_dense_us", "speedup",
                                  "decode_bound_us", "decode_bound_by", "decode_max_abs_err",
                                  "decode_launches", "decode_shape"])
    assert dec["decode_max_abs_err"] == 0.0  # the CPU runs the plain version on both sides
    fl = kb.bench_flash_blocks(B=1, H=2, T=128, D=64, reps=2, warmup=1, device="cpu")
    assert fl["flash_tile"] == "192x64" and "flash_192x64_ms" in fl
    assert sorted(fl) == sorted(["flash_192x64_ms", "flash_plain_ms", "flash_bound_ms",
                                 "flash_bound_by", "flash_max_abs_err", "flash_rel_err",
                                 "flash_fault_rel_err", "flash_launches",
                                 "flash_launches_by_route", "flash_tile",
                                 "flash_blocks_requested", "flash_shape"])
    # both planted faults read above K3's limit, which the plain version meets
    assert fl["flash_rel_err"] == 0.0
    assert sorted(fl["flash_fault_rel_err"]) == ["scale_ln2", "tile_dropped"]
    assert min(fl["flash_fault_rel_err"].values()) > kb.FLASH_REL_LIMIT
    # the CPU runs the plain versions: no kernel launch to count
    assert dec["decode_launches"] == 0 and fl["flash_launches"] == 0
    assert fl["flash_blocks_requested"] == ["128x128", "256x512", "512x1024"]
    assert kb.flash_tile(64) == (64, 64)
    # the bound at the default shapes (PERF.md: bytes at 3.35 TB/s, FLOPs
    # at the dense peak of the dtype)
    assert kb._bound_s(4 * 8 * 4 * 4096 * 128 * 2, 0, "float32")[1] == "bytes"


def test_quota_scaling_parts_that_touch_no_cgroup(monkeypatch):
    jq = importlib.import_module("ray_tpu.scripts.quota_scaling")
    pq = importlib.import_module("ray_tpu_torch.scripts.quota_scaling")
    assert pq.ROWS == jq.ROWS and pq.QUOTAS == jq.QUOTAS
    curves = [{0.25: 100.0, 0.5: 200.0, 1.0: 400.0}, {0.25: 100.0, 0.5: 110.0, 1.0: 115.0},
              {0.25: 0.0, 0.5: 10.0}, {}]
    assert [pq.linearity(c) for c in curves] == [jq.linearity(c) for c in curves]
    src = pq._CHILD_SRC.format(repo="/r", rows=list(pq.ROWS))
    compile(src, "<child>", "exec")
    assert "ray_tpu_torch" in src and "jax" not in src.lower()
    monkeypatch.setattr(pq, "_cgroup_create", lambda name, quota: None)
    with pytest.raises(RuntimeError, match="no writable cgroup"):
        pq.run_quota(0.5)


@pytest.mark.parametrize("row,unit", [("llm_chunked_prefill_stall_p99", "s"),
                                      ("llm_prefix_cache_ttft_x", "x")])
def test_microbench_timing_floor_is_its_own_error(row, unit):
    """The two LLM timing floors the card's host-bound engine can miss
    raise ``TimingFloorMissed`` (an ``AssertionError``) carrying the row as
    it would have been recorded; the row's other guards raise as before."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.scripts.microbench import TimingFloorMissed, run_suite

    assert issubclass(TimingFloorMissed, AssertionError)
    rt.init(num_cpus=2)
    try:
        got = {n: u for n, (_, u) in run_suite(rt, select=[row], quick=True,
                                                device="cpu").items()}
    except TimingFloorMissed as exc:
        assert exc.value > 0
        got = {exc.row: exc.unit}
    finally:
        rt.shutdown()
    assert got == {row: unit}
