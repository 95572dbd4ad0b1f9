"""The port's data plane (``ray_tpu_torch/runtime/data_plane.py``) against
the JAX package's: the single-process scenarios of
``tests/test_data_plane.py`` (a ``DataServer`` over one ``ObjectStore``
and a ``DataClient``; the same-host shm hand-off; a worker's puts released
from the arena) and the host-staged ``kv_pull`` rung of
``serve/disagg.pull_block`` through a ``store_server`` in one process.

Each scenario runs once in each package on the same seeded inputs and
returns what a caller sees (values as lists, error types, the servers' and
clients' transfer counters); the port's output must equal the JAX
package's.  The two-agent scenarios of that file wait for the multi-node
runtime.
"""

import importlib
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

PACKAGES = ("ray_tpu", "ray_tpu_torch")


class _Side:
    def __init__(self, name):
        self.name = name
        self.rt = importlib.import_module(name)
        self.is_jax = name == "ray_tpu"
        self.dp = importlib.import_module(name + ".runtime.data_plane")
        self.ids = importlib.import_module(name + ".core.ids")
        self.store_mod = importlib.import_module(name + ".core.object_store")
        self.shm_mod = importlib.import_module(name + ".native.shm_store")
        self.config = importlib.import_module(name + ".core.config")

    def server_store(self, **kw):
        store = self.store_mod.ObjectStore(shm_store=None)
        return store, self.dp.store_server(store, chunk_bytes=1 << 20, **kw)


def _both(scenario, *args):
    outs = {}
    for name in PACKAGES:
        side = _Side(name)
        side.config.reset_config()
        outs[name] = scenario(side, *args)
    return outs["ray_tpu"], outs["ray_tpu_torch"]


def _pull_roundtrip(s):
    store, server = s.server_store()
    try:
        oid = s.ids.ObjectID.from_random()
        value = np.arange(1000, dtype=np.int64)
        store.put(oid, value)
        client = s.dp.DataClient(chunk_bytes=1 << 20)
        got, is_error = client.pull(server.address, oid.binary())
        client.close()
        return {"is_error": is_error, "type": type(got).__name__, "equal": np.array_equal(got, value)}
    finally:
        server.close()


def _pull_chunked_large_object(s):
    store, server = s.server_store()
    try:
        oid = s.ids.ObjectID.from_random()
        value = np.random.default_rng(0).integers(0, 255, size=5 * (1 << 20), dtype=np.uint8)
        store.put(oid, value)
        client = s.dp.DataClient(chunk_bytes=1 << 20)
        got, _ = client.pull(server.address, oid.binary())
        client.close()
        # the server thread counts its bytes after its last send returns,
        # which can be after the client has them all: wait for the count
        deadline = time.monotonic() + 10.0
        while server.stats.snapshot()["bytes_sent"] == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        # out-of-band frames: the array bytes moved raw, not as one pickle frame
        sent = server.stats.snapshot()["bytes_sent"]
        return {"equal": np.array_equal(got, value), "raw": sent >= value.nbytes,
                "sent_over": sent - value.nbytes}
    finally:
        server.close()


def _push_roundtrip(s):
    store, server = s.server_store()
    try:
        oid = s.ids.ObjectID.from_random()
        value = {"weights": np.ones((256, 256), np.float32), "step": 7}
        client = s.dp.DataClient(chunk_bytes=1 << 20)
        client.push(server.address, oid.binary(), value)
        got = store.get(oid, timeout=5)
        client.close()
        # the server thread counts a push after its ack is sent, which can
        # be after the client has returned: wait for the count (F19)
        deadline = time.monotonic() + 10.0
        while server.stats.snapshot()["pushes_received"] == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        return {"step": got["step"], "equal": np.array_equal(got["weights"], value["weights"]),
                "received": server.stats.snapshot()["pushes_received"]}
    finally:
        server.close()


def _pull_not_found(s):
    _store, server = s.server_store()
    try:
        client = s.dp.DataClient()
        try:
            client.pull(server.address, s.ids.ObjectID.from_random().binary(), timeout=0.2)
        except s.dp.ObjectNotFound as exc:
            return {"raised": type(exc).__name__, "is_dp_error": isinstance(exc, s.dp.DataPlaneError)}
        finally:
            client.close()
    finally:
        server.close()


def _pull_waits_for_inflight_materialization(s):
    store, server = s.server_store()
    try:
        oid = s.ids.ObjectID.from_random()

        def late_put():
            time.sleep(0.3)
            store.put(oid, b"late-bytes")

        threading.Thread(target=late_put, daemon=True).start()
        client = s.dp.DataClient()
        got, _ = client.pull(server.address, oid.binary(), timeout=10)
        client.close()
        return got
    finally:
        server.close()


def _error_objects_carry_flag(s):
    store, server = s.server_store()
    try:
        oid = s.ids.ObjectID.from_random()
        store.put(oid, ValueError("boom"), is_error=True)
        client = s.dp.DataClient()
        got, is_error = client.pull(server.address, oid.binary())
        client.close()
        return {"is_error": is_error, "type": type(got).__name__, "message": str(got)}
    finally:
        server.close()


def _concurrent_pulls(s):
    store, server = s.server_store()
    try:
        oids = []
        for i in range(12):
            oid = s.ids.ObjectID.from_random()
            store.put(oid, np.full(200_000, i, np.int32))
            oids.append(oid)
        client = s.dp.DataClient(max_concurrent=3)
        results = [None] * len(oids)

        def pull(i):
            results[i], _ = client.pull(server.address, oids[i].binary())

        threads = [threading.Thread(target=pull, args=(i,)) for i in range(len(oids))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        client.close()
        return [None if r is None else int(r[0]) for r in results]
    finally:
        server.close()


def _recv_exact_large_reads_use_single_buffer(s):
    import socket as socket_mod

    a, b = socket_mod.socketpair()
    try:
        payload = np.random.default_rng(1).bytes(3 * (1 << 20) + 17)
        t = threading.Thread(target=lambda: a.sendall(payload), daemon=True)
        t.start()
        got = s.dp._recv_exact(b, len(payload))
        t.join(timeout=10)
        a.sendall(b"tiny")
        small = s.dp._recv_exact(b, 4)
        return {"large": (type(got).__name__, bytes(got) == payload),
                "small": (type(small).__name__, small)}
    finally:
        a.close()
        b.close()


UNIT = [_pull_roundtrip, _pull_chunked_large_object, _push_roundtrip, _pull_not_found,
        _pull_waits_for_inflight_materialization, _error_objects_carry_flag, _concurrent_pulls,
        _recv_exact_large_reads_use_single_buffer]

EXPECTED = {
    "_pull_roundtrip": {"is_error": False, "type": "ndarray", "equal": True},
    "_push_roundtrip": {"step": 7, "equal": True, "received": 1},
    "_pull_not_found": {"raised": "ObjectNotFound", "is_dp_error": True},
    "_pull_waits_for_inflight_materialization": b"late-bytes",
    "_error_objects_carry_flag": {"is_error": True, "type": "ValueError", "message": "boom"},
    "_concurrent_pulls": list(range(12)),
    "_recv_exact_large_reads_use_single_buffer": {"large": ("bytearray", True),
                                                   "small": ("bytes", b"tiny")},
}


@pytest.mark.parametrize("scenario", UNIT, ids=lambda f: f.__name__[1:])
def test_data_server_scenario_matches_jax(scenario):
    jax_out, port_out = _both(scenario)
    assert port_out == jax_out
    if scenario.__name__ in EXPECTED:
        assert port_out == EXPECTED[scenario.__name__]
    if scenario is _pull_chunked_large_object:
        assert port_out["equal"] and port_out["raw"]


# --------------------------------------------------------------------------
# same-host shm hand-off
# --------------------------------------------------------------------------
def _shm_server_store(s):
    prefix = "/rt_test_dp_" if s.is_jax else "/rttorch_test_dp_"
    shm = s.shm_mod.ShmObjectStore(f"{prefix}{os.getpid():x}_{os.urandom(2).hex()}", 1 << 28)
    store, server = s.server_store(shm_store=shm)
    return store, server, shm


def _close_shm(server, shm):
    server.close()
    shm.close()
    shm.unlink()


def _same_host_pull_moves_zero_socket_bytes(s):
    store, server, shm = _shm_server_store(s)
    try:
        oid = s.ids.ObjectID.from_random()
        value = np.arange(500_000, dtype=np.int64)  # 4 MB, well over inline
        store.put(oid, value)
        client = s.dp.DataClient(chunk_bytes=1 << 20)
        got, is_error = client.pull(server.address, oid.binary())
        out = {"is_error": is_error, "equal": np.array_equal(got, value),
               "server": {k: server.stats.snapshot()[k] for k in ("shm_handoffs", "bytes_sent")},
               "client_handoffs": client.stats.snapshot()["shm_handoffs"],
               "read_only": isinstance(got, np.ndarray) and not got.flags.writeable}
        del got
        client.close()
        return out
    finally:
        _close_shm(server, shm)


def _same_host_pull_disabled_by_config(s):
    store, server, shm = _shm_server_store(s)
    cfg = s.config.get_config()
    old = cfg.same_host_shm_transfer
    cfg.same_host_shm_transfer = False
    try:
        oid = s.ids.ObjectID.from_random()
        value = np.arange(200_000, dtype=np.int64)
        store.put(oid, value)
        client = s.dp.DataClient(chunk_bytes=1 << 20)
        got, _ = client.pull(server.address, oid.binary())
        client.close()
        return {"equal": np.array_equal(got, value),
                "handoffs": server.stats.snapshot()["shm_handoffs"]}
    finally:
        cfg.same_host_shm_transfer = old
        _close_shm(server, shm)


def _shm_offer_fallback_when_entry_vanishes(s):
    store, server, shm = _shm_server_store(s)
    try:
        oid = s.ids.ObjectID.from_random()
        value = np.arange(300_000, dtype=np.int64)
        store.put(oid, value)
        client = s.dp.DataClient(chunk_bytes=1 << 20)
        calls = {"n": 0}

        def broken_consume(offer, is_error):
            calls["n"] += 1
            raise s.dp.DataPlaneError("simulated vanished entry")

        client._consume_shm_offer = broken_consume
        got, _ = client.pull(server.address, oid.binary())
        client.close()
        return {"equal": np.array_equal(got, value), "attempts": calls["n"]}
    finally:
        _close_shm(server, shm)


SHM = [_same_host_pull_moves_zero_socket_bytes, _same_host_pull_disabled_by_config,
       _shm_offer_fallback_when_entry_vanishes]

SHM_EXPECTED = {
    "_same_host_pull_moves_zero_socket_bytes": {
        "is_error": False, "equal": True, "server": {"shm_handoffs": 1, "bytes_sent": 0},
        "client_handoffs": 1, "read_only": True},
    "_same_host_pull_disabled_by_config": {"equal": True, "handoffs": 0},
    "_shm_offer_fallback_when_entry_vanishes": {"equal": True, "attempts": 1},
}


@pytest.mark.parametrize("scenario", SHM, ids=lambda f: f.__name__[1:])
def test_same_host_shm_scenario_matches_jax(scenario):
    jax_out, port_out = _both(scenario)
    assert port_out == jax_out == SHM_EXPECTED[scenario.__name__]


def _worker_put_refs_release_arena(s):
    s.rt.init(num_cpus=2)
    try:
        cluster = s.rt.get_cluster()
        if cluster.shm_store is None:
            return "no arena"

        @s.rt.remote
        def churn():
            import numpy

            for _ in range(3):
                r = s.rt.put(numpy.zeros(2 * 1024 * 1024, dtype=numpy.uint8))
                del r
            return None

        s.rt.get(churn.remote(), timeout=60)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and cluster.shm_store.num_objects:
            time.sleep(0.2)
        return cluster.shm_store.num_objects
    finally:
        s.rt.shutdown()


def test_worker_put_refs_release_arena_matches_jax():
    jax_out, port_out = _both(_worker_put_refs_release_arena)
    assert port_out == jax_out == 0


# --------------------------------------------------------------------------
# the host-staged kv_pull rung of serve/disagg.pull_block
# --------------------------------------------------------------------------
def _kv_pull_host_rung(s):
    disagg = importlib.import_module(s.name + ".serve.disagg")
    block = np.random.default_rng(2).standard_normal((2, 16, 2, 8)).astype(np.float32)
    source = (lambda i: block * (i + 1)) if s.is_jax else (
        lambda i: torch.as_tensor(block) * (i + 1))
    store, server = s.server_store()
    real = s.dp.kv_block_source
    # one process holds both ends: the pull's own registry lookup misses, the
    # data server's (on its serve thread) finds the staged migration
    s.dp.kv_block_source = lambda mig: (
        real(mig) if threading.current_thread().name == "data-serve" else None)
    s.dp.register_kv_block_source("mig-kv", source)
    try:
        ticket = {"mig_id": "mig-kv", "transfer_addr": None, "data_addr": server.address,
                  "block_shape": list(block.shape), "block_dtype": "float32"}
        got = [disagg.pull_block(ticket, b) for b in range(2)]
        direct = s.dp.pull_kv_block(server.address, "mig-kv", 1)
        missing = s.dp.pull_kv_block(server.address, "no-such-mig", 0)
        try:
            disagg.pull_block({**ticket, "mig_id": "no-such-mig"}, 0)
        except disagg.KVMigrationError as exc:
            unreachable = (type(exc).__name__, exc.stage)
        return {"rungs": [r for _, r in got],
                "values": [np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a).tolist()
                           for a, _ in got],
                "direct": np.array_equal(np.asarray(direct), block * 2),
                "missing": missing, "unreachable": unreachable,
                "served": server.stats.snapshot()["kv_blocks_served"]}
    finally:
        s.dp.kv_block_source = real
        s.dp.unregister_kv_block_source("mig-kv")
        server.close()


def test_kv_pull_host_rung_of_pull_block_matches_jax():
    jax_out, port_out = _both(_kv_pull_host_rung)
    assert port_out == jax_out
    assert port_out["rungs"] == ["host", "host"] and port_out["direct"]
    assert port_out["missing"] is None and port_out["served"] == 3
    assert port_out["unreachable"] == ("KVMigrationError", "staging")


def test_relay_and_push_task_raise_not_ported():
    """What serves node agents waits for the multi-node runtime: the relay
    tree and leased direct dispatch raise ``NotPortedError`` where they are
    reached, and a data server answers their ops with an error."""
    from ray_tpu_torch.exceptions import NotPortedError
    from ray_tpu_torch.runtime import data_plane

    with pytest.raises(NotPortedError):
        data_plane.build_relay_tree(["a:1"], 2)
    client = data_plane.DataClient()
    with pytest.raises(NotPortedError):
        client.relay(b"x" * 28, 1, [])
    with pytest.raises(NotPortedError):
        client.push_task("127.0.0.1:1", b"spec")
    _store, server = _Side("ray_tpu_torch").server_store()
    import socket

    try:
        sock = socket.create_connection(("127.0.0.1", server.port), timeout=10)
        data_plane._send_header(sock, {"op": "relay", "oid": b"x", "meta_size": 0,
                                       "buffer_sizes": []})
        assert data_plane._recv_header(sock) == {"ok": False, "error": "relay is not ported"}
        sock.close()
    finally:
        server.close()
