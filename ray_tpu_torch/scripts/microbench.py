"""The microbenchmark suite: ray_perf parity plus the device data paths.

Mirrors the reference's ``python/ray/_private/ray_perf.py:93`` metric set
(the numbers published in ``release/release_logs/2.22.0/microbenchmark.json``
— see BASELINE.md) so every row is directly comparable, and adds the
bandwidth axes the reference can't have: the native shm copy tier and
host<->HBM copies of CUDA tensors (the H100's memory is HBM3).

The port's copy of ``ray_tpu/scripts/microbench.py``: the same ``BASELINES``,
row names and units.  The rows that compute (``hbm_*``, the device-channel,
SPMD-gang and train-scaling rows, the LLM rows) run on CUDA unless
``run_suite(..., device="cpu")`` is given, and raise where there is no CUDA
device.  The LLM rows keep the reference's decoder (``d_model=32,
n_heads=4``: head_dim 8) on the CPU; on the card, whose decode kernels take
head_dim 64 or 128, they use the narrowest decoder those take,
``d_model=256, n_heads=4, n_kv_heads=2`` (head_dim 64), f32.  The
multi-node rows run as the reference measures them: ``xproc_object_gigabytes``
spawns a port node agent and pulls 256 MiB host objects from it, the
broadcast rows relay 64 MiB through a tree of four data servers.

Used by ``rt microbenchmark`` (human table).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

# Reference baselines (mean, unit) from BASELINE.md / microbenchmark.json.
BASELINES: Dict[str, Tuple[float, str]] = {
    "single_client_tasks_sync": (971.3, "tasks/s"),
    "single_client_tasks_async": (8194.0, "tasks/s"),
    "single_client_tasks_and_get_batch": (8.14, "batches/s"),
    "multi_client_tasks_async": (21744.0, "tasks/s"),
    "1_1_actor_calls_sync": (2096.0, "calls/s"),
    "1_1_actor_calls_async": (9063.0, "calls/s"),
    "1_1_actor_calls_concurrent": (5480.0, "calls/s"),
    "1_n_actor_calls_async": (8606.0, "calls/s"),
    "n_n_actor_calls_async": (27688.0, "calls/s"),
    "n_n_actor_calls_with_arg_async": (2714.0, "calls/s"),
    "1_1_async_actor_calls_sync": (1326.0, "calls/s"),
    "1_1_async_actor_calls_async": (3314.0, "calls/s"),
    "n_n_async_actor_calls_async": (23093.0, "calls/s"),
    "single_client_put_calls": (5196.0, "puts/s"),
    "single_client_get_calls": (10270.0, "gets/s"),
    "multi_client_put_calls": (12873.0, "puts/s"),
    "single_client_put_gigabytes": (20.1, "GB/s"),
    "multi_client_put_gigabytes": (35.9, "GB/s"),
    "single_client_wait_1k_refs": (5.01, "waits/s"),
    "single_client_get_object_containing_10k_refs": (13.3, "gets/s"),
    "placement_group_create_removal": (838.5, "ops/s"),
    # shm_put_gigabytes / hbm_put_gigabytes / hbm_get_gigabytes have NO
    # reference analogue (device-native axes) and carry no baseline: their
    # vs_baseline is intentionally absent from bench output.
}

#: the LLM rows' decoder: the reference's on the CPU, head_dim 64 on the card
LLM_CONFIG = {"cpu": dict(d_model=32, n_heads=4, n_kv_heads=2),
              "cuda": dict(d_model=256, n_heads=4, n_kv_heads=2)}


class TimingFloorMissed(AssertionError):
    """An LLM row's timing floor missed: the chunked-prefill stall p99 not
    below one-shot prefill's, or the warm prefix-cache TTFT under 2x the
    cold one.  The row's correctness guards held before it was raised;
    ``row``, ``value`` and ``unit`` are the row as it would have been
    recorded.  On the card the engine's host loop binds prefill, and these
    two floors fail in some runs (ROADMAP A2)."""

    def __init__(self, row: str, value: float, unit: str, msg: str):
        super().__init__(msg)
        self.row, self.value, self.unit = row, value, unit


# Side-channel for bench.py: the LLM rows' engine-side SLO sketch
# percentiles ({ttft, inter_token, queue_wait, e2e} -> percentiles dict),
# captured from the concurrent-streams engine before shutdown.  Cleared
# at the top of every run_suite call.
LLM_SKETCH_CAPTURE: Dict[str, dict] = {}


def _rate(fn: Callable[[], None], n: int, warmup: Optional[int] = None, rounds: int = 3) -> float:
    """Median-of-rounds rate (ops/s) — robust to shared-box noise."""
    for _ in range(min(100, n // 10) if warmup is None else warmup):
        fn()
    rates = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        rates.append(n / (time.perf_counter() - t0))
    return sorted(rates)[len(rates) // 2]


def run_suite(
    rt,
    select: Optional[List[str]] = None,
    quick: bool = False,
    progress: Optional[Callable[[str, float, str], None]] = None,
    device=None,
) -> Dict[str, Tuple[float, str]]:
    """Run the suite on an initialized runtime; returns name -> (value, unit).

    ``select`` limits to the named metrics; ``quick`` shrinks iteration
    counts (CI smoke); ``progress(name, value, unit)`` streams rows as they
    finish (the CLI prints incrementally); ``device`` is where the rows that
    compute run (CUDA when None)."""
    import numpy as np

    results: Dict[str, Tuple[float, str]] = {}
    LLM_SKETCH_CAPTURE.clear()

    def record(name: str, value: float, unit: str) -> None:
        results[name] = (value, unit)
        if progress is not None:
            progress(name, value, unit)

    def wanted(name: str) -> bool:
        return select is None or name in select

    scale = 0.2 if quick else 1.0
    _dev = []

    def dev():
        """The rows' device, resolved at the first row that computes."""
        if not _dev:
            from ray_tpu_torch.models.common import default_device

            _dev.append(default_device(device, "the microbenchmark's device rows"))
        return _dev[0]

    def N(n: int) -> int:
        return max(10, int(n * scale))

    @rt.remote
    def noop():
        return None

    @rt.remote
    class A:
        def m(self):
            return None

        def m_arg(self, x):
            return None

    class AsyncA:
        async def m(self):
            return None

    AsyncA = rt.remote(AsyncA)

    # ---- tasks -----------------------------------------------------------
    if wanted("single_client_tasks_sync"):
        record("single_client_tasks_sync", _rate(lambda: rt.get(noop.remote()), N(3000)), "tasks/s")

    if wanted("single_client_tasks_async"):
        batch = N(1000)
        record(
            "single_client_tasks_async",
            _rate(lambda: rt.get([noop.remote() for _ in range(batch)]), 10, warmup=2) * batch,
            "tasks/s",
        )

    if wanted("single_client_tasks_and_get_batch"):
        # reference: ray_perf.py:131 — submit a 1k-task batch, get it; the
        # rate is BATCHES per second (baseline 8.14)
        batch = N(1000)

        def tasks_and_get_batch():
            rt.get([noop.remote() for _ in range(batch)])

        record(
            "single_client_tasks_and_get_batch",
            _rate(tasks_and_get_batch, 8, warmup=2) * batch / 1000.0,
            "batches/s",
        )

    if wanted("multi_client_tasks_async"):
        # The reference runs several driver processes against one cluster;
        # here concurrent submitter threads share the driver runtime (the
        # fabric is in-process — threads ARE the contention axis).
        n_clients = 4
        per_client = N(2000)

        def client():
            rt.get([noop.remote() for _ in range(per_client)])

        rates = []
        for _ in range(3):
            threads = [threading.Thread(target=client) for _ in range(n_clients)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            rates.append(n_clients * per_client / (time.perf_counter() - t0))
        record("multi_client_tasks_async", sorted(rates)[1], "tasks/s")

    # ---- actors ----------------------------------------------------------
    # each actor section kills its actors afterwards: they hold CPU
    # resources, and a leaked holder starves the next section's creations
    if wanted("1_1_actor_calls_sync") or wanted("1_1_actor_calls_async"):
        a = A.remote()
        rt.get(a.m.remote())
        if wanted("1_1_actor_calls_sync"):
            record("1_1_actor_calls_sync", _rate(lambda: rt.get(a.m.remote()), N(2000)), "calls/s")
        if wanted("1_1_actor_calls_async"):
            batch = N(500)
            record(
                "1_1_actor_calls_async",
                _rate(lambda: rt.get([a.m.remote() for _ in range(batch)]), 8, warmup=2) * batch,
                "calls/s",
            )
        rt.kill(a)

    if wanted("1_1_async_actor_calls_sync") or wanted("1_1_async_actor_calls_async"):
        aa = AsyncA.options(max_concurrency=8).remote()
        rt.get(aa.m.remote())
        if wanted("1_1_async_actor_calls_sync"):
            record("1_1_async_actor_calls_sync", _rate(lambda: rt.get(aa.m.remote()), N(1000)), "calls/s")
        if wanted("1_1_async_actor_calls_async"):
            batch = N(500)
            record(
                "1_1_async_actor_calls_async",
                _rate(lambda: rt.get([aa.m.remote() for _ in range(batch)]), 8, warmup=2) * batch,
                "calls/s",
            )
        rt.kill(aa)

    if wanted("1_1_actor_calls_concurrent"):
        # reference: ray_perf.py:205 — one actor, max_concurrency=16
        ca = A.options(max_concurrency=16).remote()
        rt.get(ca.m.remote())
        batch = N(500)
        record(
            "1_1_actor_calls_concurrent",
            _rate(lambda: rt.get([ca.m.remote() for _ in range(batch)]), 8, warmup=2) * batch,
            "calls/s",
        )
        rt.kill(ca)

    if wanted("1_n_actor_calls_async"):
        # reference: ray_perf.py:214-220 — ONE client actor fanning a batch
        # across n server actors (nested submission from inside an actor)
        n_servers = max(2, min(4, int(rt.cluster_resources().get("CPU", 2))))
        servers = [A.remote() for _ in range(n_servers)]
        rt.get([s.m.remote() for s in servers])

        # num_cpus=0, like the reference's Client (ray_perf.py:38): with n
        # servers already holding every CPU, a 1-CPU client would never
        # schedule and the row would deadlock
        @rt.remote(num_cpus=0)
        class Client:
            def __init__(self, servers):
                self.servers = servers

            def batch(self, per):
                refs = []
                for s in self.servers:
                    refs.extend([s.m.remote() for _ in range(per)])
                rt.get(refs)

        client = Client.remote(servers)
        per = N(250)
        record(
            "1_n_actor_calls_async",
            _rate(lambda: rt.get(client.batch.remote(per)), 6, warmup=1) * per * n_servers,
            "calls/s",
        )
        rt.kill(client)
        for s in servers:
            rt.kill(s)

    if wanted("n_n_actor_calls_async"):
        n = max(2, min(4, int(rt.cluster_resources().get("CPU", 2))))
        actors = [A.remote() for _ in range(n)]
        rt.get([a.m.remote() for a in actors])
        per = N(1000)

        def caller(actor):
            rt.get([actor.m.remote() for _ in range(per)])

        rates = []
        for _ in range(3):
            threads = [threading.Thread(target=caller, args=(a,)) for a in actors]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            rates.append(n * per / (time.perf_counter() - t0))
        record("n_n_actor_calls_async", sorted(rates)[1], "calls/s")
        for actor in actors:
            rt.kill(actor)

    if wanted("n_n_actor_calls_with_arg_async"):
        # reference: ray_perf.py:234-243 — n client actors, each fanning
        # calls WITH a put-ref argument to its own server actor
        n = max(2, min(4, int(rt.cluster_resources().get("CPU", 2))))
        servers = [A.remote() for _ in range(n)]
        rt.get([s.m.remote() for s in servers])

        @rt.remote(num_cpus=0)
        class ArgClient:
            def __init__(self, server):
                self.server = server

            def batch_arg(self, per):
                x = rt.put(0)
                rt.get([self.server.m_arg.remote(x) for _ in range(per)])

        clients = [ArgClient.remote(s) for s in servers]
        per = N(200)

        def round_():
            rt.get([c.batch_arg.remote(per) for c in clients])

        record(
            "n_n_actor_calls_with_arg_async",
            _rate(round_, 4, warmup=1) * per * n,
            "calls/s",
        )
        for c in clients:
            rt.kill(c)
        for s in servers:
            rt.kill(s)

    if wanted("n_n_async_actor_calls_async"):
        # reference: ray_perf.py:276-288 — n concurrent submitters against
        # n ASYNC actors
        n = max(2, min(4, int(rt.cluster_resources().get("CPU", 2))))
        actors = [AsyncA.options(max_concurrency=8).remote() for _ in range(n)]
        rt.get([a.m.remote() for a in actors])
        per = N(500)

        def caller(i):
            rt.get([actors[(i + j) % n].m.remote() for j in range(per)])

        rates = []
        for _ in range(3):
            threads = [threading.Thread(target=caller, args=(i,)) for i in range(n)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            rates.append(n * per / (time.perf_counter() - t0))
        record("n_n_async_actor_calls_async", sorted(rates)[1], "calls/s")
        for actor in actors:
            rt.kill(actor)

    # ---- lease-based direct dispatch ---------------------------
    # The two regression rows' SHAPES re-measured in a fresh runtime with
    # the lease path warm: N submitter threads flooding repeat-shape work
    # that rides cached worker leases / actor direct routes after the
    # single warmup grant — tracked head-to-head against the historical
    # multi_client_tasks_async / n_n_actor_calls_async numbers.
    if wanted("direct_dispatch_tasks_async"):
        n_clients = 4
        per_client = N(2000)

        @rt.remote
        def leased_noop():
            return None

        rt.get([leased_noop.remote() for _ in range(100)])  # grant + tier warm

        def leased_client():
            rt.get([leased_noop.remote() for _ in range(per_client)])

        rates = []
        for _ in range(3):
            threads = [threading.Thread(target=leased_client) for _ in range(n_clients)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            rates.append(n_clients * per_client / (time.perf_counter() - t0))
        record("direct_dispatch_tasks_async", sorted(rates)[1], "tasks/s")

    if wanted("direct_dispatch_actor_calls_async"):
        n = max(2, min(4, int(rt.cluster_resources().get("CPU", 2))))
        actors = [A.remote() for _ in range(n)]
        rt.get([a.m.remote() for a in actors])  # alive: routes granted
        per = N(1000)

        def route_caller(actor):
            rt.get([actor.m.remote() for _ in range(per)])

        rates = []
        for _ in range(3):
            threads = [threading.Thread(target=route_caller, args=(a,)) for a in actors]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            rates.append(n * per / (time.perf_counter() - t0))
        record("direct_dispatch_actor_calls_async", sorted(rates)[1], "calls/s")
        for actor in actors:
            rt.kill(actor)

    # ---- put/get call rates ---------------------------------------------
    if wanted("single_client_put_calls"):
        small = np.zeros(1024, dtype=np.uint8)
        record("single_client_put_calls", _rate(lambda: rt.put(small), N(5000)), "puts/s")

    if wanted("single_client_get_calls"):
        ref = rt.put(np.zeros(1024, dtype=np.uint8))
        record("single_client_get_calls", _rate(lambda: rt.get(ref), N(5000)), "gets/s")

    if wanted("multi_client_put_calls"):
        # reference: ray_perf.py:110-124 — 10 concurrent tasks each doing
        # 100 nested puts (the put rate under multi-submitter contention)
        @rt.remote
        def do_put_small():
            for _ in range(100):
                rt.put(0)

        def put_multi_small():
            rt.get([do_put_small.remote() for _ in range(10)])

        record(
            "multi_client_put_calls",
            _rate(put_multi_small, max(2, N(6)), warmup=1) * 1000,
            "puts/s",
        )

    if wanted("single_client_get_object_containing_10k_refs"):
        # reference: ray_perf.py:71-76,148-155 — a remote task creates an
        # object holding 10k ObjectRefs; the client gets that object
        n_refs = N(10_000)

        @rt.remote
        def create_object_containing_ref():
            return [rt.put(1) for _ in range(n_refs)]

        obj = create_object_containing_ref.remote()
        got = rt.get(obj)
        assert len(got) == n_refs
        # normalize to the reference's 10k-ref object rate
        record(
            "single_client_get_object_containing_10k_refs",
            _rate(lambda: rt.get(obj), N(60), warmup=5) * n_refs / 10_000.0,
            "gets/s",
        )

    if wanted("single_client_wait_1k_refs"):
        refs = [noop.remote() for _ in range(1000)]
        rt.get(refs)
        record(
            "single_client_wait_1k_refs",
            _rate(lambda: rt.wait(refs, num_returns=1000), N(20), warmup=2),
            "waits/s",
        )

    if wanted("xproc_object_gigabytes"):
        # Cross-PROCESS object bandwidth over the peer-to-peer data plane
        # (chunked out-of-band frames; the head carries zero bulk bytes).
        # Runs BEFORE the GB-scale section: 8 GB of by-reference puts churn
        # the page cache enough to halve this row on a one-core host.
        try:
            value = _xproc_bandwidth(rt)
            if value is not None:
                record("xproc_object_gigabytes", value, "GB/s")
        except Exception:  # noqa: BLE001 — agent spawn env issues: skip row
            pass

    # ---- GB-scale object paths ------------------------------------------
    gb = 1 << 30
    if wanted("single_client_put_gigabytes"):
        # Reference semantics: 1 GB ndarray through put+get. The driver
        # store holds it BY REFERENCE (no serialization, no copy) — the
        # native design point; effective bandwidth is bounded only by
        # the op rate. Reported as real elapsed GB/s over put+get pairs.
        big = np.zeros(gb, dtype=np.uint8)

        def put_get_pair():
            r = rt.put(big)
            out = rt.get(r)
            assert out.nbytes == big.nbytes

        # _rate = median of 3 rounds: robust to a single noisy-neighbor
        # stall on the shared CI box
        pairs_per_round = max(2, round(4 * scale))
        rate = _rate(put_get_pair, pairs_per_round, warmup=1)
        record("single_client_put_gigabytes", rate * big.nbytes / 1e9, "GB/s")
        del big

    if wanted("multi_client_put_gigabytes"):
        # reference: ray_perf.py:138-146 — 10 concurrent tasks each doing
        # 10 nested 80 MB puts; scaled to the box (N) with the same shape:
        # concurrent submitters, bulk ndarray payloads
        put_mb = 40
        puts_per_task = 4
        n_tasks = max(2, N(8))

        @rt.remote
        def do_put_big():
            for _ in range(puts_per_task):
                rt.put(np.zeros(put_mb * 1024 * 1024, dtype=np.uint8))

        def put_multi_big():
            rt.get([do_put_big.remote() for _ in range(n_tasks)])

        bytes_per_round = n_tasks * puts_per_task * put_mb * 1024 * 1024
        rate = _rate(put_multi_big, 3, warmup=1, rounds=3)
        record("multi_client_put_gigabytes", rate * bytes_per_round / 1e9, "GB/s")

    if wanted("shm_put_gigabytes"):
        # The copy path a process boundary pays (plasma-role C++ shm arena):
        # one memcpy in per put, zero-copy view out.
        shm = rt.get_cluster().shm_store
        if shm is not None:
            half = np.zeros(1 << 29, dtype=np.uint8)
            counter = [0]

            def shm_roundtrip():
                counter[0] += 1
                oid = counter[0].to_bytes(20, "little")
                shm.put(oid, memoryview(half), meta_size=0)
                view, _meta = shm.get(oid)
                assert len(view) == half.nbytes
                shm.release(oid)
                shm.delete(oid)

            n = max(2, N(8))
            t0 = time.perf_counter()
            for _ in range(n):
                shm_roundtrip()
            dt = time.perf_counter() - t0
            record("shm_put_gigabytes", n * half.nbytes / 1e9 / dt, "GB/s")
            del half

    if wanted("hbm_put_gigabytes") or wanted("hbm_get_gigabytes"):
        # Host<->HBM: 256 MiB host buffers copied onto the card and back
        # (pinned host memory, the copy engines' path), each timed to the
        # last byte by a synchronize.
        import torch

        d = dev()
        n = max(2, N(4))
        host = torch.zeros(gb // 4, dtype=torch.uint8, pin_memory=d.type == "cuda")

        def sync():
            if d.type == "cuda":
                torch.cuda.synchronize(d)

        if wanted("hbm_put_gigabytes"):
            outs = [torch.empty_like(host, device=d) for _ in range(n)]
            outs[0].copy_(host, non_blocking=True)  # warm the path
            sync()
            t0 = time.perf_counter()
            for o in outs:
                o.copy_(host, non_blocking=True)
            sync()
            dt = time.perf_counter() - t0
            record("hbm_put_gigabytes", n * host.nbytes / 1e9 / dt, "GB/s")
            del outs
        if wanted("hbm_get_gigabytes"):
            srcs = [torch.full((host.numel(),), i, dtype=torch.uint8, device=d) for i in range(n)]
            srcs[0].to("cpu")
            sync()
            t0 = time.perf_counter()
            for src in srcs:
                host.copy_(src, non_blocking=True)
            sync()
            dt = time.perf_counter() - t0
            assert int(host[-1]) == n - 1
            record("hbm_get_gigabytes", n * host.nbytes / 1e9 / dt, "GB/s")
            del srcs
        del host

    # ---- spanning-tree object broadcast ----------------------------------
    if wanted("broadcast_64mb_to_n") or wanted("broadcast_root_egress_x"):
        # One 64 MiB object relayed through a fanout-bounded tree of N data
        # servers (chunk-pipelined recv->write+forward hops).  GB/s is the
        # aggregate delivered rate (N * size / wall); root egress is SOCKET
        # bytes out of the source client — with the relay it stays at
        # ~fanout x object size instead of the N x of repeated unicast
        # (the bar asserted in tests/test_broadcast.py).
        from ray_tpu_torch.core.ids import ObjectID
        from ray_tpu_torch.core.object_store import ObjectStore
        from ray_tpu_torch.runtime import data_plane as dp

        n_dest, fanout = 4, 2
        size = (8 << 20) if quick else (64 << 20)
        stores = [ObjectStore(shm_store=None) for _ in range(n_dest)]
        servers = [dp.store_server(s, chunk_bytes=8 << 20) for s in stores]
        client = dp.DataClient(chunk_bytes=8 << 20)
        value = np.ones(size, np.uint8)
        try:
            rates = []
            sent_before = client.stats.bytes_sent
            rounds = 3
            for _ in range(rounds):
                oid = ObjectID.from_random()
                tree = dp.build_relay_tree([s.address for s in servers], fanout)
                t0 = time.perf_counter()
                failed = client.relay(oid.binary(), value, tree)
                dt = time.perf_counter() - t0
                assert not failed, failed
                assert all(st.contains(oid) for st in stores)
                rates.append(n_dest * size / 1e9 / dt)
                for st in stores:
                    st.delete(oid)
            record("broadcast_64mb_to_n", sorted(rates)[len(rates) // 2], "GB/s")
            record(
                "broadcast_root_egress_x",
                (client.stats.bytes_sent - sent_before) / (rounds * size),
                "x",
            )
        finally:
            client.close()
            for server in servers:
                server.close()
        del value

    # ---- compiled execution plans ----------------------------------------
    if wanted("compiled_pipeline_iter") or wanted("compiled_pipeline_vs_remote_x"):
        # Per-iteration latency of a 4-stage cross-node actor pipeline run
        # through an INSTALLED execution plan (the acceptance bar):
        # zero TaskSpecs / scheduler hops / ObjectRefs per iteration, edges
        # as pre-established channels.  The _x row is the dispatch-overhead
        # ratio vs the equivalent per-call `.remote()` chain (bar: >= 3x).
        # Runs in its own fresh-runtime group: it adds a node.
        from ray_tpu_torch.dag import InputNode

        cluster = rt.get_cluster()
        cluster.add_node({"CPU": 2, "pipe_bench": 4})

        @rt.remote
        class PipeStage:
            def step(self, x):
                return x + 1

        head = dict(execution="inproc")
        other = dict(execution="inproc", resources={"pipe_bench": 1}, num_cpus=0)
        stages = [
            PipeStage.options(**head).remote(),
            PipeStage.options(**other).remote(),
            PipeStage.options(**other).remote(),
            PipeStage.options(**head).remote(),
        ]
        with InputNode() as inp:
            d = inp
            for s in stages:
                d = s.step.bind(d)
        plan = d.compile_plan(name="bench")
        try:
            # steady-state per-iteration cost, BOTH paths pipelined with the
            # same batch in flight: the plan streams iterations through its
            # installed channels; the chain pays 4 TaskSpecs + ObjectRefs +
            # scheduler hops per iteration.  Median of 3 rounds.
            batch = N(300)
            for _ in range(30):
                plan.execute(0)  # warm

            def plan_batch():
                futs = [plan.execute_async(0) for _ in range(batch)]
                for f in futs:
                    f.result(timeout=120)

            plan_rate = _rate(plan_batch, 1, warmup=1, rounds=3) * batch

            def submit_chain():
                ref = stages[0].step.remote(0)
                for s in stages[1:]:
                    ref = s.step.remote(ref)
                return ref

            rt.get([submit_chain() for _ in range(20)])

            def remote_batch():
                rt.get([submit_chain() for _ in range(batch)], timeout=120)

            remote_rate = _rate(remote_batch, 1, warmup=1, rounds=3) * batch
            record("compiled_pipeline_iter", 1e6 / plan_rate, "us")
            record("compiled_pipeline_vs_remote_x", plan_rate / remote_rate, "x")
        finally:
            plan.teardown()

    # ---- device-native plan channels --------------------------
    if wanted("device_channel_edge_bw") or wanted("device_channel_vs_pickle_x"):
        # One MB-scale tensor pushed through a REAL chan_push wire
        # (store_server + ChannelStream + SeqChannel consumer), device kind
        # vs pickle kind.  Device kind: the push is a control-only header
        # and the payload moves through the staged device-to-device pull —
        # zero array bytes on the stream, zero pickling.  The transport
        # stand-in hands the staged tensor over as a reference (on the card
        # the pull rides the CUDA IPC transfer server), so the row
        # measures the channel fabric's per-kind cost with the interconnect
        # externalized; the _x row is the acceptance bar (device > pickle
        # on >= 1 MiB arrays).
        import torch

        from ray_tpu_torch.core.object_store import ObjectStore
        from ray_tpu_torch.runtime import channel_manager, data_plane as dp, device_plane

        size = (1 << 20) if quick else (8 << 20)
        value = torch.ones(size, dtype=torch.uint8, device=dev())

        class _RefTicket:
            def __init__(self):
                self._cbs = []

            def add_done_callback(self, fn):
                self._cbs.append(fn)

            def fire(self):
                cbs, self._cbs = self._cbs, []
                for fn in cbs:
                    fn(self)

        class _RefTransfer:
            def __init__(self):
                self._staged = {}
                self._lock = threading.Lock()

            def address(self):
                return "inproc:0"

            def await_pull(self, uuid, array):
                t = _RefTicket()
                with self._lock:
                    self._staged[uuid] = (array, t)
                return t

            def connect(self, addr):
                return self

            def pull(self, uuid, template):
                with self._lock:
                    array, t = self._staged.pop(uuid)
                t.fire()
                return array

        mgr = channel_manager.global_manager()
        store = ObjectStore(shm_store=None)
        server = dp.store_server(store, chunk_bytes=8 << 20)
        pushes = max(4, N(16))

        def edge_bytes_per_s(kind: str) -> float:
            plan_id = f"bench-devchan-{kind}"
            ch = mgr.register(plan_id, ["edge"], kinds={"edge": kind})["edge"]
            stream = dp.ChannelStream(server.address, plan_id, "edge", kind=kind)
            stop = threading.Event()

            def consume():
                while not stop.is_set():
                    try:
                        ch.read(timeout=30)
                    except Exception:  # noqa: BLE001 — closed: drain done
                        return

            reader = threading.Thread(target=consume, daemon=True)
            reader.start()
            seq = [0]

            def burst():
                for _ in range(pushes):
                    stream.push(seq[0], value)
                    seq[0] += 1

            try:
                rate = _rate(burst, 1, warmup=1, rounds=3)
                return rate * pushes * size
            finally:
                stop.set()
                stream.close()
                mgr.release_plan(plan_id)
                reader.join(timeout=5)

        try:
            try:
                device_plane.install_transfer_server(_RefTransfer())
                dev_bw = edge_bytes_per_s("device")
            finally:
                device_plane.install_transfer_server(None)
            pickle_bw = edge_bytes_per_s("pickle")
        finally:
            server.close()
        record("device_channel_edge_bw", dev_bw / 1e9, "GB/s")
        record("device_channel_vs_pickle_x", dev_bw / max(pickle_bw, 1e-9), "x")
        del value

    if wanted("spmd_pipeline_iter"):
        # End-to-end us/iter of a plan whose single stage is an SPMD gang:
        # inputs split across the members, steps run concurrently,
        # outputs reassembled into one tensor — trace once at install
        # (warmup), execute many.  Steady state via execute_async pipelining,
        # same shape as compiled_pipeline_iter.
        import torch

        from ray_tpu_torch.dag import InputNode, StageGroup

        gang_dev = dev()

        @rt.remote
        class GangWorker:
            def step(self, x):
                return x.to(gang_dev) * 2.0 + 1.0

        members = [GangWorker.options(execution="inproc").remote() for _ in range(2)]
        gang = StageGroup(members, "step", split_axis=0, warmup=((8, 128), "float32"))
        with InputNode() as inp:
            out = gang.bind(inp)
        plan = out.compile_plan(name="gang-bench")
        x = torch.ones((8, 128), dtype=torch.float32, device=gang_dev)
        try:
            for _ in range(10):
                plan.execute(x)
            batch = N(200)

            def gang_batch():
                futs = [plan.execute_async(x) for _ in range(batch)]
                for f in futs:
                    f.result(timeout=120)

            iters_per_s = _rate(gang_batch, 1, warmup=1, rounds=3) * batch
            record("spmd_pipeline_iter", 1e6 / iters_per_s, "us")
        finally:
            plan.teardown()

    # ---- elastic gang training --------------------------------
    if wanted("train_step_scaling"):
        # Step time vs gang size through a TrainController StageGroup gang:
        # the same global batch split across 1, then 2, then 4 members
        # (elastic resize re-traces once per new mesh size).  Row value =
        # median step time at gang 1 / at gang 4 (x) — what the split
        # actually buys end to end, gang dispatch included.
        # In-row guard (train-while-serve): a serving deployment's p99
        # measured WHILE the gang steps in the background must stay within
        # noise of its idle p99 — training registers as a preemptible
        # background tenant, and a step must never stall a serving burst
        # beyond the generous shared-box bound asserted below.
        from ray_tpu_torch import serve
        from ray_tpu_torch.train.controller import TrainController

        gang_dev = dev()  # before the deployment: a refusal leaves nothing running

        @serve.deployment(num_replicas=1, max_ongoing_requests=8)
        class _Echo:
            def __call__(self, x):
                return x

        handle = serve.run(_Echo.bind(), route_prefix=None)
        assert handle.remote(0).result(timeout=30) == 0  # warm the replica

        def serve_p99(calls: int) -> float:
            lat = []
            for i in range(calls):
                t0 = time.perf_counter()
                handle.remote(i).result(timeout=30)
                lat.append(time.perf_counter() - t0)
            return float(np.percentile(np.asarray(lat), 99))

        ctl = TrainController(
            "bench_scaling",
            world_size=1,
            batch_size=32,
            feature_dim=64,
            seed=11,
            checkpoint_period=10**9,  # no checkpoint I/O inside the timing
            preemptible=True,
            # zero-CPU members: the gang must coexist with the serving
            # deployment on the 4-CPU bench runtime (inproc members burn
            # no scheduler capacity anyway)
            member_resources=[{}],
            device=gang_dev,
        )
        steps = N(20)
        try:
            step_us = {}
            for size in (1, 2, 4):
                if size != ctl.world_size:
                    ctl.resize(size, reason="scale_up")
                for _ in range(3):  # absorb the re-trace + warm the path
                    ctl.step()
                step_us[size] = 1e6 / _rate(ctl.step, steps, warmup=0, rounds=3)

            idle_p99 = serve_p99(100)
            stop = threading.Event()

            def background_train():
                while not stop.is_set():
                    ctl.step()

            trainer_thread = threading.Thread(target=background_train, daemon=True)
            trainer_thread.start()
            try:
                busy_p99 = serve_p99(100)
            finally:
                stop.set()
                trainer_thread.join(timeout=30)
            # generous shared-box bound: the guard catches a gang that
            # wedges serving (seconds-long head-of-line stalls), not
            # scheduler jitter on a contended core
            if busy_p99 > 5 * idle_p99 + 0.100:
                raise AssertionError(
                    f"serving p99 regressed under background training: "
                    f"{busy_p99 * 1e3:.1f}ms busy vs {idle_p99 * 1e3:.1f}ms idle"
                )
            record("train_step_scaling", step_us[1] / max(step_us[4], 1e-9), "x")
        finally:
            ctl.shutdown()
            serve.shutdown()

    # ---- placement groups ------------------------------------------------
    if wanted("placement_group_create_removal"):
        from ray_tpu_torch.util.placement import placement_group, remove_placement_group

        def pg_cycle():
            pg = placement_group([{"CPU": 0.01}])
            pg.wait(timeout_seconds=5)
            remove_placement_group(pg)

        record("placement_group_create_removal", _rate(pg_cycle, N(500)), "ops/s")

    # ---- locality-aware scheduling ---------------------------------------
    if wanted("locality_arg_tasks"):
        # Arg-heavy cross-node tasks/s: a 32 MiB argument lives on a second
        # node; each round fans a batch of consumers over it.  The locality
        # stage lands them ON the holder, so the rate measures scheduling +
        # dispatch — not redundant 32 MiB copies.  Runs
        # LAST in the suite: it adds a node, which must not perturb the
        # CPU-count-derived shapes of earlier rows.
        cluster = rt.get_cluster()
        cluster.add_node({"CPU": 2, "loc_bench": 1})

        @rt.remote(execution="thread", resources={"loc_bench": 1}, num_cpus=0)
        def produce_big():
            return np.ones(32 * 1024 * 1024, np.uint8)

        @rt.remote(execution="thread", num_cpus=0)
        def consume_big(x):
            return x.nbytes

        big_ref = produce_big.remote()
        deadline = time.monotonic() + 30
        while not cluster.directory.locations(big_ref.id()):
            if time.monotonic() > deadline:
                break
            time.sleep(0.01)
        batch = N(200)

        def locality_round():
            rt.get([consume_big.remote(big_ref) for _ in range(batch)], timeout=120)

        record(
            "locality_arg_tasks",
            _rate(locality_round, 4, warmup=1) * batch,
            "tasks/s",
        )
        del big_ref

    # ---- hedged straggler retries ------------------------------
    if wanted("overload_goodput"):
        # Overload survival: goodput under 5x-capacity offered
        # load through the serve admission spine.  Capacity = throughput
        # with offered concurrency == the replicas' aggregate concurrency
        # (nothing sheds); overload = 5x the client threads.  Row value =
        # goodput under overload / capacity (x; ~1.0 = graceful
        # degradation — shed requests cost a typed 429, not a queue).
        # In-row guards: every rejection is a typed OverloadedError with a
        # retry_after_s hint, the router's admission gauge never exceeds
        # its configured bound, and overload actually shed something.
        import threading as _th

        from ray_tpu_torch import serve
        from ray_tpu_torch.exceptions import OverloadedError

        MAX_ONGOING, REPLICAS, MAX_QUEUED = 4, 2, 8
        # dispatched in-flight never exceeds the replicas' aggregate
        # concurrency (the bounded router queue holds the rest)
        capacity_bound = REPLICAS * MAX_ONGOING

        @serve.deployment(
            num_replicas=REPLICAS,
            max_ongoing_requests=MAX_ONGOING,
            max_queued_requests=MAX_QUEUED,
        )
        class _Work:
            def __call__(self, x):
                # 10ms: large enough that 5x client-thread GIL churn is
                # noise next to the work item, so the ratio measures the
                # ADMISSION machinery, not Python thread scheduling
                time.sleep(0.010)
                return x

        handle = serve.run(_Work.bind(), route_prefix=None)
        assert handle.remote(0).result(timeout=30) == 0  # warm replicas

        router = handle._router

        def drive(n_threads: int, seconds: float):
            stop_at = time.monotonic() + seconds
            ok = [0] * n_threads
            shed = [0] * n_threads
            bad: list = []
            peak = [0]

            def client(k):
                while time.monotonic() < stop_at:
                    try:
                        handle.remote(k).result(timeout=30)
                        ok[k] += 1
                    except OverloadedError as exc:
                        if not exc.retry_after_s > 0:
                            bad.append("OverloadedError without retry_after_s")
                        shed[k] += 1
                        time.sleep(min(0.005, exc.retry_after_s))
                    except Exception as exc:  # noqa: BLE001
                        bad.append(f"untyped rejection: {exc!r}")

            threads = [
                _th.Thread(target=client, args=(k,), daemon=True)
                for k in range(n_threads)
            ]
            t0 = time.monotonic()
            for t in threads:
                t.start()
            while any(t.is_alive() for t in threads):
                with router._lock:
                    depth = sum(router._inflight.values())
                peak[0] = max(peak[0], depth)
                time.sleep(0.005)
            for t in threads:
                t.join()
            dt = time.monotonic() - t0
            return sum(ok) / dt, sum(shed), bad, peak[0]

        cap_rate, _, bad1, _ = drive(REPLICAS * MAX_ONGOING, 1.2)
        good_rate, n_shed, bad2, peak = drive(5 * REPLICAS * MAX_ONGOING, 1.5)
        serve.shutdown()
        problems = bad1 + bad2
        if problems:
            raise AssertionError(f"overload row broke typing: {problems[:5]}")
        if peak > capacity_bound + 2:  # +2: racing admits before the gauge
            raise AssertionError(
                f"router admission exceeded its bound: {peak} > {capacity_bound}"
            )
        if n_shed == 0:
            raise AssertionError("5x offered load shed nothing — bound not engaged")
        record("overload_goodput", good_rate / max(cap_rate, 1e-9), "x")

    if wanted("hedged_tail_latency_p99"):
        # Tail latency under ONE delay-armed slow node, hedging off vs on:
        # bursts spread across both nodes, so ~half the tasks land on the
        # straggler.  p99 without hedging pays the full chaos delay; with
        # `.options(hedge_after_s=...)` the watchdog launches the second
        # attempt on the OTHER node and first-commit-wins rescues the tail.
        # Row value = p99_baseline / p99_hedged (x; higher is better).
        # Own fresh-runtime group — it adds a node and arms a delay.
        cluster = rt.get_cluster()
        slow = cluster.add_node({"CPU": 4})
        slow._chaos_delay_s = 0.25

        @rt.remote(execution="thread", max_retries=3)
        def unit():
            return 1

        def burst_latencies(hedge_after_s):
            fn = unit if hedge_after_s is None else unit.options(hedge_after_s=hedge_after_s)
            out = []
            for _ in range(3):
                t0 = time.perf_counter()
                refs = [fn.remote() for _ in range(32)]
                pending = list(refs)
                while pending:
                    ready, pending = rt.wait(pending, num_returns=1, timeout=60)
                    out.append(time.perf_counter() - t0)
                time.sleep(0.05)
            return sorted(out)

        def p99(lat):
            return lat[min(len(lat) - 1, int(len(lat) * 0.99))]

        rt.get([unit.remote() for _ in range(16)])  # warm both nodes
        base = burst_latencies(None)
        hedged = burst_latencies(0.06)
        # the acceptance guard: zero duplicate terminal commits across all
        # the racing (task_id, attempt) pairs — asserted from the event
        # store, the same record invariant 3 audits
        terminal: dict = {}
        for ev in cluster.control.task_events.list_events(limit=1_000_000):
            if ev.get("state") in ("FINISHED", "FAILED"):
                key = (ev["task_id"], ev.get("attempt"))
                terminal[key] = terminal.get(key, 0) + 1
        dupes = {k: n for k, n in terminal.items() if n > 1}
        if dupes:
            raise AssertionError(f"hedging double-committed: {list(dupes)[:5]}")
        record("hedged_tail_latency_p99", p99(base) / max(1e-9, p99(hedged)), "x")
        slow._chaos_delay_s = 0.0

    # ---- paged KV + chunked prefill ---------------------------
    if (
        wanted("llm_paged_capacity_x")
        or wanted("llm_chunked_prefill_stall_p99")
        or wanted("llm_concurrent_streams_x")
        or wanted("llm_prefix_cache_ttft_x")
        or wanted("llm_disagg_intertoken_p99")
    ):
        import functools

        import torch

        from ray_tpu_torch.models import TransformerConfig, init_params
        from ray_tpu_torch.serve import llm as _llm

        llm_dev = dev()
        llm_cfg = TransformerConfig(
            vocab_size=128, n_layers=2, d_ff=64, attention="dense", dtype=torch.float32,
            **LLM_CONFIG[llm_dev.type],
        )
        llm_params = init_params(llm_cfg, torch.Generator(device=llm_dev).manual_seed(0))
        LLMEngine = functools.partial(_llm.LLMEngine, device=llm_dev)

    if wanted("llm_paged_capacity_x"):
        # Concurrent streams at a FIXED KV HBM budget, paged vs dense.  The
        # budget is 4 max-length rows (4 x 256 positions).  Dense must cut
        # it into 4 whole-sequence slots, so 4 streams run no matter how
        # short the requests are; the paged pool shares the same positions
        # at 16-token block granularity, so 64-position requests pack 16
        # deep.  Row value = measured peak concurrent paged streams /
        # measured peak dense (x).  In-row guards: every stream completes,
        # all pool blocks return, and the ratio meets the >= 2x acceptance.
        import threading as _th

        S_CAP, BS = 256, 16
        BUDGET_BLOCKS = 4 * (S_CAP // BS)  # the dense engine's footprint
        PROMPT_N, MAX_T = 40, 24  # 64 positions = 4 blocks per stream
        STREAMS = 16

        def _peak_streams(kind, batch, num_blocks=None):
            # prefix_cache off: this row measures block-granular packing at
            # a fixed HBM budget; cached prefixes would hold pool pages and
            # trip the all-blocks-return guard
            eng = LLMEngine(
                llm_cfg, llm_params, max_batch_size=batch, max_seq_len=S_CAP,
                cache_kind=kind, kv_block_size=BS, kv_num_blocks=num_blocks,
                prefix_cache=False,
            )
            try:
                eng.generate([1] * PROMPT_N, max_tokens=2)  # warm compiles
                peak = [0]
                stop = _th.Event()

                def watch():
                    while not stop.is_set():
                        peak[0] = max(peak[0], eng.stats()["active_slots"])
                        time.sleep(0.002)

                w = _th.Thread(target=watch, daemon=True)
                w.start()
                futs = [
                    eng.submit([2 + (i % 96)] * PROMPT_N, max_tokens=MAX_T)
                    for i in range(STREAMS)
                ]
                outs = [f.result(timeout=300) for f in futs]
                stop.set()
                w.join()
                if not all(len(o) == MAX_T for o in outs):
                    raise AssertionError("capacity row: a stream stopped early")
                if kind == "paged" and eng.stats()["kv_blocks_in_use"] != 0:
                    raise AssertionError("capacity row leaked KV blocks")
                return peak[0]
            finally:
                eng.shutdown()

        dense_peak = _peak_streams("dense", batch=4)
        paged_peak = _peak_streams(
            "paged", batch=STREAMS, num_blocks=BUDGET_BLOCKS + 1
        )
        ratio = paged_peak / max(1, dense_peak)
        if ratio < 2.0:
            raise AssertionError(
                f"paged capacity {paged_peak} vs dense {dense_peak} = "
                f"{ratio:.2f}x, below the 2x acceptance floor"
            )
        record("llm_paged_capacity_x", ratio, "x")

    if wanted("llm_chunked_prefill_stall_p99"):
        # Client-observed p99 inter-token gap of a RUNNING decode stream
        # while three long prompts are admitted behind it.  One-shot
        # prefill freezes decode for a whole 384-token forward per admit;
        # chunked prefill (32-token chunks) interleaves a decode step
        # between chunks, bounding the stall to one chunk's forward.  Row
        # value = the chunked engine's p99 gap (s; lower is better).
        # In-row guard: chunked p99 strictly beats the one-shot baseline.
        LONG_N, VICTIM_T = 384, 48

        def _gap_p99(chunk_tokens):
            eng = LLMEngine(
                llm_cfg, llm_params, max_batch_size=4, max_seq_len=512,
                cache_kind="paged", prefill_chunk_tokens=chunk_tokens,
            )
            try:
                # warm the prefill/decode compiles out of the measurement
                eng.generate([(i % 96) + 1 for i in range(LONG_N)], max_tokens=2)
                stream = eng.submit_stream([5, 6, 7], max_tokens=VICTIM_T)
                next(stream)
                gaps, got, injected = [], 1, False
                t = time.perf_counter()
                for _tok in stream:
                    now = time.perf_counter()
                    gaps.append(now - t)
                    t = now
                    got += 1
                    if not injected and got >= 5:
                        injected = True
                        for j in range(3):
                            eng.submit([j + 2] * LONG_N, max_tokens=2)
                if not injected:
                    raise AssertionError("stall row: victim ended before inject")
                gaps.sort()
                return gaps[min(len(gaps) - 1, int(len(gaps) * 0.99))]
            finally:
                eng.shutdown()

        oneshot_p99 = _gap_p99(0)
        chunked_p99 = _gap_p99(32)
        if not chunked_p99 < oneshot_p99:
            raise TimingFloorMissed(
                "llm_chunked_prefill_stall_p99", chunked_p99, "s",
                f"chunked prefill p99 gap {chunked_p99:.4f}s did not beat "
                f"one-shot {oneshot_p99:.4f}s"
            )
        record("llm_chunked_prefill_stall_p99", chunked_p99, "s")

    if wanted("llm_disagg_intertoken_p99"):
        # Disaggregated prefill/decode: client-observed p99
        # inter-token gap of a RUNNING decode stream while three 384-token
        # prompts burst in.  Baseline = the same burst chunked-prefilled on
        # the SHARED replica (the chunked-prefill mitigation): every chunk still
        # steals one decode step, so the gap is bounded, not flat.
        # Disaggregated = the burst prefills on a separate prefill engine
        # and only the staged KV blocks migrate into the decode engine —
        # no prefill forward ever runs where the victim decodes.  In
        # production the prefill pool is separate hardware; this one-core
        # box cannot run P concurrently without timeslicing the very
        # decode under test, so the burst is prefilled (and staged) before
        # the victim window opens and the window measures exactly what
        # the decode replica experiences: staged KV blocks pulled and
        # adopted mid-stream.  Row value = disaggregated p99 gap (s;
        # lower is better).  In-row guards: beats the shared-replica
        # chunked baseline in this same row; each migration's wall (pulls
        # + adoption) undercuts one CHUNK-token prefill's measured
        # latency; the control-stream ticket is header-only JSON (zero KV
        # payload bytes).
        import json as _json
        import threading as _dth

        from ray_tpu_torch.serve import disagg as _disagg

        # VICTIM_T covers the burst's full lifecycle on BOTH sides (the
        # shared replica chunks ~36 ticks before its burst even decodes;
        # a shorter window would end before the baseline's compound
        # chunk+mixed-decode phase and understate its tail)
        LONG_N, VICTIM_T, CHUNK = 384, 96, 32
        burst_prompts = [[(j + 2) % 96 + 1] * LONG_N for j in range(3)]
        warm_prompt = [97] * LONG_N

        def _engine(**kw):
            # prefix_cache off everywhere: the row measures prefill
            # interference, and a warm prefix would let later runs skip the
            # very compute under test
            kw.setdefault("max_batch_size", 4)
            kw.setdefault("max_seq_len", 512)
            return LLMEngine(llm_cfg, llm_params, cache_kind="paged",
                             prefill_chunk_tokens=CHUNK, prefix_cache=False,
                             **kw)

        def _victim_gaps(eng, inject):
            stream = eng.submit_stream([5, 6, 7], max_tokens=VICTIM_T)
            next(stream)
            gaps, got, injected = [], 1, False
            t = time.perf_counter()
            for _tok in stream:
                now = time.perf_counter()
                gaps.append(now - t)
                t = now
                got += 1
                if not injected and got >= 5:
                    injected = True
                    inject()
            if not injected:
                raise AssertionError("disagg row: victim ended before inject")
            return gaps

        def _p99(gaps):
            gaps = sorted(gaps)
            return gaps[min(len(gaps) - 1, int(len(gaps) * 0.99))]

        # -- baseline: burst chunk-prefills on the victim's own engine ----
        # 3 victim windows per side, p99 over the POOLED gap distribution
        # (~285 intervals): a single window's p99 is its max gap, and one
        # descheduled wakeup on the shared box fakes a stall (PERF.md's
        # scheduling lottery)
        shared = _engine()
        try:
            shared.generate(warm_prompt, max_tokens=2)  # warm the compiles
            shared_gaps: list = []
            for _ in range(3):
                burst_reqs: list = []
                shared_gaps.extend(_victim_gaps(
                    shared,
                    lambda: burst_reqs.extend(
                        shared.submit(p, max_tokens=2) for p in burst_prompts),
                ))
                for fut in burst_reqs:  # drain before the next window
                    fut.result(timeout=300)
            shared_p99 = _p99(shared_gaps)
        finally:
            shared.shutdown()

        # -- disaggregated: burst prefills on P, KV blocks migrate to D ---
        p_eng, d_eng = _engine(), _engine()
        tickets: list = []
        adopted: list = []
        try:
            p_eng.generate(warm_prompt, max_tokens=2)
            d_eng.generate(warm_prompt, max_tokens=2)
            # warm the adoption path too: the first migration compiles the
            # page-write step (~90ms once per engine lifetime); production
            # decode replicas adopt continuously, so charging that cold
            # start to the victim window would measure XLA, not handoff
            warm_ticket = p_eng.prefill_export(
                warm_prompt, mig_id="bench/warm").result(timeout=300)
            warm_arrays = {
                b: _disagg.pull_block(warm_ticket, b)[0]
                for b in range(int(warm_ticket["n_blocks"]))
            }
            d_eng.adopt_migration(
                warm_ticket, warm_arrays, max_tokens=2
            ).future.result(timeout=300)
            p_eng.release_migration("bench/warm")
            def _mover(round_tickets):
                # off the stream-consumer thread: the handoff must not
                # starve the victim's token reads.  Pulls run sequentially
                # — the in-process rung resolves a block in ~µs, and a
                # worker pool here only adds GIL churn that steals the
                # engine loop's timeslices on the one-core box
                for ticket in round_tickets:
                    arrays = {
                        b: _disagg.pull_block(ticket, b)[0]
                        for b in range(int(ticket["n_blocks"]))
                    }
                    adopted.append(
                        d_eng.adopt_migration(ticket, arrays, max_tokens=2))
                    p_eng.release_migration(ticket["mig_id"])

            disagg_gaps: list = []
            for r in range(3):
                # the prefill pool's work, staged ahead of each victim
                # window (see the row comment: on one core a concurrent P
                # would timeslice the decode it is supposed to be
                # isolated from)
                round_tickets = [
                    p_eng.prefill_export(p, mig_id=f"bench/m{r}_{j}")
                    .result(timeout=300)
                    for j, p in enumerate(burst_prompts)
                ]
                tickets.extend(round_tickets)
                mover = _dth.Thread(
                    target=_mover, args=(round_tickets,), daemon=True)
                disagg_gaps.extend(_victim_gaps(d_eng, mover.start))
                mover.join(timeout=300)
                if mover.is_alive():
                    raise AssertionError("disagg row: migrations never finished")
                for req in adopted:  # drain before the next window
                    req.future.result(timeout=300)
            disagg_p99 = _p99(disagg_gaps)
            if len(adopted) != 3 * len(burst_prompts):
                raise AssertionError("disagg row: migrations never finished")
            for req in adopted:
                if len(req.future.result(timeout=300)) != 2:
                    raise AssertionError("disagg row: adopted decode stopped early")

            # guard: the handoff header carries zero KV payload bytes
            for ticket in tickets:
                if len(_json.dumps(ticket)) >= 2048:
                    raise AssertionError(
                        f"ticket for {ticket['mig_id']} is not header-only: "
                        f"{len(_json.dumps(ticket))} bytes")
            # guard: intrinsic migration wall (pulls + adoption) < one
            # prefill chunk's latency — otherwise disaggregation pays more
            # than the interference it removes.  Measured QUIET (after the
            # victim stream ended) on both sides, median-of-3: the loaded
            # walls above include the victim's own decode contention, which
            # is the interference, not the handoff cost.
            quiet_migs = []
            for j in range(3):
                ticket = p_eng.prefill_export(
                    [(j + 11) % 96 + 1] * LONG_N, mig_id=f"bench/q{j}"
                ).result(timeout=300)
                t0 = time.perf_counter()
                arrays = {
                    b: _disagg.pull_block(ticket, b)[0]
                    for b in range(int(ticket["n_blocks"]))
                }
                req = d_eng.adopt_migration(ticket, arrays, max_tokens=2)
                quiet_migs.append(time.perf_counter() - t0)
                req.future.result(timeout=300)
                p_eng.release_migration(ticket["mig_id"])
            chunk_lats = []
            for _ in range(3):
                t0 = time.perf_counter()
                p_eng.generate([9] * CHUNK, max_tokens=1)
                chunk_lats.append(time.perf_counter() - t0)
            mig_med = sorted(quiet_migs)[1]
            chunk_med = sorted(chunk_lats)[1]
            if not mig_med < chunk_med:
                raise AssertionError(
                    f"migration wall {mig_med:.4f}s did not undercut one "
                    f"{CHUNK}-token prefill chunk ({chunk_med:.4f}s)")
        finally:
            p_eng.shutdown()
            d_eng.shutdown()

        if not disagg_p99 < shared_p99:
            raise AssertionError(
                f"disaggregated p99 gap {disagg_p99:.4f}s did not beat the "
                f"shared-replica chunked baseline {shared_p99:.4f}s")
        record("llm_disagg_intertoken_p99", disagg_p99, "s")

    if wanted("llm_concurrent_streams_x"):
        # Decode-batch utilization: wall-clock tokens/s of 8
        # concurrent streams vs the SAME 8 requests one at a time on one
        # engine.  Sequential serving decodes a batch of 1 per step; the
        # continuous batcher packs all 8 into one decode forward.  Row value
        # = concurrent tok/s / sequential tok/s (x).  In-row guards: outputs
        # are request-for-request identical (greedy), ratio >= 1.5x floor.
        # prefix_cache off so the sequential pass cannot seed reuse for the
        # concurrent pass — both do full prefills.
        N_STREAMS, GEN_T, PROMPT_L = 8, 32, 24
        eng = LLMEngine(
            llm_cfg, llm_params, max_batch_size=N_STREAMS, max_seq_len=256,
            cache_kind="paged", prefix_cache=False,
        )
        try:
            prompts = [
                [(i * 7 + j) % 96 + 1 for j in range(PROMPT_L)]
                for i in range(N_STREAMS)
            ]
            eng.generate(prompts[0], max_tokens=2)  # warm the compiles
            t0 = time.perf_counter()
            seq_out = [eng.generate(p, max_tokens=GEN_T) for p in prompts]
            seq_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            futs = [eng.submit(p, max_tokens=GEN_T) for p in prompts]
            conc_out = [f.result(timeout=300) for f in futs]
            conc_s = time.perf_counter() - t0
            if conc_out != seq_out:
                raise AssertionError(
                    "concurrent streams row: batched tokens diverged from "
                    "sequential"
                )
            ratio = seq_s / max(1e-9, conc_s)
            if ratio < 1.5:
                raise AssertionError(
                    f"8 concurrent streams only {ratio:.2f}x sequential "
                    f"tok/s, below the 1.5x floor"
                )
            # capture the engine's SLO sketch percentiles (TTFT /
            # inter-token over all 16 runs) for the bench report's
            # llm_latency_sketches row — read before shutdown zeroes it
            LLM_SKETCH_CAPTURE.update(eng.admission_snapshot()["latency"])
        finally:
            eng.shutdown()
        record("llm_concurrent_streams_x", ratio, "x")

    if wanted("llm_prefix_cache_ttft_x"):
        # Prefix-cache TTFT: time-to-first-token of a 192-token
        # prompt cold (full prefill) vs warm (every full block shared out of
        # the radix cache; the engine recomputes ONE token through a
        # copy-on-write tail block).  Row value = cold TTFT / warm TTFT (x).
        # In-row guards: warm tokens identical to cold (greedy), >= 2x
        # acceptance floor.
        PREFIX_L, GEN_T = 192, 8
        eng = LLMEngine(
            llm_cfg, llm_params, max_batch_size=2, max_seq_len=256,
            cache_kind="paged", kv_block_size=16,
        )
        try:
            # warm BOTH code paths (full prefill and hit + COW) on an
            # unrelated prompt so the row times KV reuse, not XLA compiles
            warmup = [7] * PREFIX_L
            eng.generate(warmup, max_tokens=2)
            eng.generate(warmup, max_tokens=2)
            eng.flush_prefix_cache()

            def ttft(p):
                t0 = time.perf_counter()
                stream = eng.submit_stream(p, max_tokens=GEN_T)
                first = next(stream)
                dt = time.perf_counter() - t0
                return dt, [first] + list(stream)

            prompt = [(j * 5) % 96 + 1 for j in range(PREFIX_L)]
            cold_s, cold_toks = ttft(prompt)
            warm_s, warm_toks = ttft(prompt)
            if warm_toks != cold_toks:
                raise AssertionError("ttft row: warm tokens diverged from cold")
            if eng.stats()["prefix_cache_hits"] < 1:
                raise AssertionError("ttft row: warm run missed the cache")
            ratio = cold_s / max(1e-9, warm_s)
            if ratio < 2.0:
                raise TimingFloorMissed(
                    "llm_prefix_cache_ttft_x", ratio, "x",
                    f"warm TTFT {warm_s * 1e3:.2f}ms vs cold "
                    f"{cold_s * 1e3:.2f}ms = {ratio:.2f}x, below the 2x "
                    f"acceptance floor"
                )
        finally:
            eng.shutdown()
        record("llm_prefix_cache_ttft_x", ratio, "x")

    return results


def _xproc_bandwidth(rt, nbytes: int = 1 << 28, rounds: int = 3) -> Optional[float]:
    """GB/s for a 256 MiB object moving agent-process -> driver over the
    data plane (lazy commit + chunked out-of-band pull).  End-to-end rate:
    includes the remote task producing the value — what a user's
    rt.get(remote_result) actually sees."""
    import os
    import subprocess
    import sys

    import numpy as np

    cluster = rt.get_cluster()
    address = cluster.start_head_service()
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.runtime.agent", "--address", address,
         "--num-cpus", "2", "--resources", '{"bench_remote": 4}'],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    try:
        deadline = time.monotonic() + 60
        while sum(1 for n in cluster.nodes.values() if not n.dead) < 2:
            if time.monotonic() > deadline:
                return None
            time.sleep(0.1)

        @rt.remote(resources={"bench_remote": 1})
        def produce(seed):
            return np.full(nbytes, seed % 251, dtype=np.uint8)

        # warm (worker spawn, connection setup)
        rt.get(produce.remote(0), timeout=120)
        rates = []
        for i in range(rounds):
            t0 = time.perf_counter()
            out = rt.get(produce.remote(i + 1), timeout=300)
            dt = time.perf_counter() - t0
            assert out.nbytes == nbytes
            rates.append(nbytes / 1e9 / dt)
        return sorted(rates)[len(rates) // 2]
    finally:
        proc.kill()
        proc.wait(timeout=10)


def run_scaling(rt, widths=(1, 2, 4), per_client: int = 1500) -> Dict[str, Dict[int, float]]:
    """Aggregate throughput vs number of concurrent submitters, for the two
    parallel-submitter rows (to show the architecture — not
    the box — is the limit).  On an N-core box the curve should hold roughly
    flat once submitters exceed cores; a DROP with width would indicate
    fabric-side contention."""
    out: Dict[str, Dict[int, float]] = {"multi_client_tasks_async": {}, "n_n_actor_calls_async": {}}

    @rt.remote
    def noop():
        return None

    @rt.remote
    class A:
        def m(self):
            return None

    for width in widths:
        def client():
            rt.get([noop.remote() for _ in range(per_client)])

        rates = []
        for _ in range(3):
            threads = [threading.Thread(target=client) for _ in range(width)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            rates.append(width * per_client / (time.perf_counter() - t0))
        out["multi_client_tasks_async"][width] = sorted(rates)[1]

    for width in widths:
        actors = [A.remote() for _ in range(width)]
        rt.get([a.m.remote() for a in actors])

        def caller(actor):
            rt.get([actor.m.remote() for _ in range(per_client)])

        rates = []
        for _ in range(3):
            threads = [threading.Thread(target=caller, args=(a,)) for a in actors]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            rates.append(width * per_client / (time.perf_counter() - t0))
        out["n_n_actor_calls_async"][width] = sorted(rates)[1]
        for a in actors:
            rt.kill(a)
    return out


def format_table(results: Dict[str, Tuple[float, str]]) -> str:
    lines = [f"{'metric':42s} {'value':>14s} {'unit':>8s} {'vs_ref':>8s}"]
    for name, (value, unit) in results.items():
        base = BASELINES.get(name)
        vs = f"{value / base[0]:7.2f}x" if base else "      --"
        lines.append(f"{name:42s} {value:14.1f} {unit:>8s} {vs}")
    return "\n".join(lines)
