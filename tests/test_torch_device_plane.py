"""The port's device envelope and transfer negotiation
(``ray_tpu_torch/runtime/device_plane.py`` under ``runtime/data_plane.py``)
against the JAX package's: the single-process scenarios of
``tests/test_device_plane.py``.

A ``torch.Tensor`` takes the place of a ``jax.Array``: the envelope frames
CPU tensors as the JAX package's frames CPU ``jax.Array`` s, so the same
scenarios exercise it here; the transfer server is the host-memory fake of
each package (``runtime/fake_transfer.py``).  Each scenario runs once in
each package on the same inputs and returns what a caller sees; the port's
output must equal the JAX package's.  The two-process scenario is held in
``tests/test_torch_multinode_plans.py``.
"""

import importlib
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

PACKAGES = ("ray_tpu", "ray_tpu_torch")


class _Side:
    def __init__(self, name):
        self.name = name
        self.is_jax = name == "ray_tpu"
        self.dp = importlib.import_module(name + ".runtime.data_plane")
        self.dev = importlib.import_module(name + ".runtime.device_plane")
        self.fake = importlib.import_module(name + ".runtime.fake_transfer")
        self.ids = importlib.import_module(name + ".core.ids")
        self.store_mod = importlib.import_module(name + ".core.object_store")

    def array(self, value, dtype="float32"):
        if self.is_jax:
            import jax.numpy as jnp

            return jnp.asarray(np.asarray(value, "float32"), dtype=getattr(jnp, dtype))
        return torch.as_tensor(np.asarray(value, "float32")).to(getattr(torch, dtype))

    def is_array(self, x):
        if self.is_jax:
            import jax

            return isinstance(x, jax.Array)
        return isinstance(x, torch.Tensor)

    def template(self, shape):
        if self.is_jax:
            import jax
            import jax.numpy as jnp

            return jax.ShapeDtypeStruct(shape, jnp.float32)
        return torch.empty(shape, dtype=torch.float32, device="meta")


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _both(scenario, fake=False):
    outs = {}
    for name in PACKAGES:
        side = _Side(name)
        server = side.fake.FakeTransferServer() if fake else None
        if fake:
            side.dev.install_transfer_server(server)
        try:
            outs[name] = scenario(side, server) if fake else scenario(side)
        finally:
            if fake:
                side.dev.install_transfer_server(None)
                server.close()
    return outs["ray_tpu"], outs["ray_tpu_torch"]


def _wait_for(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


# --------------------------------------------------------------------------
# the device envelope
# --------------------------------------------------------------------------
def _serializes_out_of_band(s):
    x = s.array(np.arange(250_000))  # 1 MB
    meta, buffers = s.dp.to_frames(x)
    return {"meta_small": len(meta) < 4096,
            "out_of_band": sum(memoryview(b).cast("B").nbytes for b in buffers) >= 1_000_000}


def _roundtrips_as_device_array(s):
    before = s.dev.stats.snapshot()["arrays_restored"]
    x = s.array(np.arange(100_000)) * 3.0
    meta, buffers = s.dp.to_frames(x)
    y = s.dp.from_frames(meta, [bytearray(memoryview(b).cast("B")) for b in buffers])
    return {"is_array": s.is_array(y), "equal": np.array_equal(_host(y), _host(x)),
            "restored": s.dev.stats.snapshot()["arrays_restored"] - before}


def _nested_in_containers(s):
    value = {"params": {"w": s.array(np.ones((64, 64)), "bfloat16")}, "step": 3,
             "host": np.arange(10)}
    meta, buffers = s.dp.to_frames(value)
    got = s.dp.from_frames(meta, [bytes(memoryview(b).cast("B")) for b in buffers])
    w = got["params"]["w"]
    return {"is_array": s.is_array(w), "dtype": str(w.dtype).removeprefix("torch."),
            "ones": bool((_host(w) == 1).all()), "step": got["step"],
            "host": type(got["host"]).__name__, "buffers": len(buffers)}


def _abstract_values_are_not_enveloped(s):
    """Inside a trace the JAX reducer must not export buffers (a tracer);
    the port's counterpart of a value with no data is a meta tensor."""
    if s.is_jax:
        import jax
        import jax.numpy as jnp

        seen = []

        @jax.jit
        def f(x):
            seen.append(s.dev.is_device_array(x))
            return x * 2

        out = _host(f(jnp.ones(4)))
        return {"abstract": seen, "out": out.tolist(), "concrete": s.dev.is_device_array(jnp.ones(2))}
    abstract = [s.dev.is_device_array(torch.empty(4, device="meta"))]
    return {"abstract": abstract, "out": (torch.ones(4) * 2).tolist(),
            "concrete": s.dev.is_device_array(torch.ones(2))}


def _transfer_server_probe_degrades_gracefully(s):
    addr = s.dev.transfer_address()
    return addr is None or isinstance(addr, str)


def _pull_of_device_array_via_data_server(s):
    store = s.store_mod.ObjectStore(shm_store=None)
    server = s.dp.store_server(store)
    try:
        oid = s.ids.ObjectID.from_random()
        store.put(oid, s.array(np.full((512, 512), 7.0)))
        client = s.dp.DataClient()
        got, is_error = client.pull(server.address, oid.binary())
        client.close()
        return {"is_error": is_error, "is_array": s.is_array(got), "value": float(_host(got)[0, 0])}
    finally:
        server.close()


ENVELOPE = [_serializes_out_of_band, _roundtrips_as_device_array, _nested_in_containers,
            _abstract_values_are_not_enveloped, _transfer_server_probe_degrades_gracefully,
            _pull_of_device_array_via_data_server]

ENVELOPE_EXPECTED = {
    "_serializes_out_of_band": {"meta_small": True, "out_of_band": True},
    "_roundtrips_as_device_array": {"is_array": True, "equal": True, "restored": 1},
    "_nested_in_containers": {"is_array": True, "dtype": "bfloat16", "ones": True, "step": 3,
                              "host": "ndarray", "buffers": 2},
    "_abstract_values_are_not_enveloped": {"abstract": [False], "out": [2.0] * 4,
                                           "concrete": True},
    "_transfer_server_probe_degrades_gracefully": True,
    "_pull_of_device_array_via_data_server": {"is_error": False, "is_array": True, "value": 7.0},
}


@pytest.mark.parametrize("scenario", ENVELOPE, ids=lambda f: f.__name__[1:])
def test_envelope_scenario_matches_jax(scenario):
    jax_out, port_out = _both(scenario)
    assert port_out == jax_out == ENVELOPE_EXPECTED[scenario.__name__]


# --------------------------------------------------------------------------
# the negotiation protocol through the fake transfer server
# --------------------------------------------------------------------------
def _device_pull_negotiation_end_to_end(s, fake):
    store = s.store_mod.ObjectStore(shm_store=None)
    server = s.dp.store_server(store)
    try:
        oid = s.ids.ObjectID.from_random()
        store.put(oid, s.array(np.arange(4096)) * 2.0)
        ici_before = s.dev.stats.snapshot()["ici_pulls"]
        client = s.dp.DataClient()
        got, is_error = client.pull(server.address, oid.binary())
        client.close()
        _wait_for(lambda: fake.pulls_served >= 1)  # counted after the last byte is sent
        return {"is_error": is_error, "is_array": s.is_array(got), "value": float(_host(got)[3]),
                "ici": s.dev.stats.snapshot()["ici_pulls"] - ici_before,
                "served": fake.pulls_served}
    finally:
        server.close()


def _ticket_released_on_consume(s, fake):
    store = s.store_mod.ObjectStore(shm_store=None)
    server = s.dp.store_server(store)
    try:
        oid = s.ids.ObjectID.from_random()
        store.put(oid, s.array(np.ones((256, 256))))
        client = s.dp.DataClient()
        got, _ = client.pull(server.address, oid.binary())
        client.close()
        return {"is_array": s.is_array(got), "staged": fake.staged_count(),
                "released": _wait_for(lambda: s.dev._staged_outstanding == 0)}
    finally:
        server.close()


def _concurrent_offers_pull_by_uuid(s, fake):
    arrays = {100 + i: s.array(np.full((64,), float(i + 1))) for i in range(3)}
    offered = [s.dev.offer_device_pull(uuid, arr) for uuid, arr in arrays.items()]
    staged = fake.staged_count()
    addr = s.dev.transfer_address()
    pulled = []
    for uuid in [102, 100, 101]:  # out of order: uuid routing, not FIFO luck
        got = s.dev.device_pull(addr, uuid, s.template((64,)))
        pulled.append((s.is_array(got), float(_host(got)[0])))
    return {"offered": offered, "staged": staged, "pulled": pulled,
            "after": fake.staged_count()}


def _unstaged_uuid_raises_keyerror(s, fake):
    conn = fake.connect(fake.address())
    try:
        conn.pull(424242, s.template((4,)))
    except KeyError as exc:
        return type(exc).__name__


NEGOTIATION = [_device_pull_negotiation_end_to_end, _ticket_released_on_consume,
               _concurrent_offers_pull_by_uuid, _unstaged_uuid_raises_keyerror]

NEGOTIATION_EXPECTED = {
    "_device_pull_negotiation_end_to_end": {"is_error": False, "is_array": True, "value": 6.0,
                                            "ici": 1, "served": 1},
    "_ticket_released_on_consume": {"is_array": True, "staged": 0, "released": True},
    "_concurrent_offers_pull_by_uuid": {"offered": [True] * 3, "staged": 3,
                                        "pulled": [(True, 3.0), (True, 1.0), (True, 2.0)],
                                        "after": 0},
    "_unstaged_uuid_raises_keyerror": "KeyError",
}


@pytest.mark.parametrize("scenario", NEGOTIATION, ids=lambda f: f.__name__[1:])
def test_negotiation_scenario_matches_jax(scenario):
    jax_out, port_out = _both(scenario, fake=True)
    assert port_out == jax_out == NEGOTIATION_EXPECTED[scenario.__name__]


def _midflight_refusal_falls_back_to_envelope(s):
    refusing = s.fake.FakeTransferServer(refuse_pulls=True)
    s.dev.install_transfer_server(refusing)
    store = s.store_mod.ObjectStore(shm_store=None)
    server = s.dp.store_server(store)
    try:
        oid = s.ids.ObjectID.from_random()
        store.put(oid, s.array(np.arange(1000)))
        ici_before = s.dev.stats.snapshot()["ici_pulls"]
        client = s.dp.DataClient()
        got, is_error = client.pull(server.address, oid.binary())
        client.close()
        return {"is_error": is_error, "is_array": s.is_array(got),
                "last": float(_host(got)[999]), "ici": s.dev.stats.snapshot()["ici_pulls"] - ici_before}
    finally:
        s.dev.install_transfer_server(None)
        refusing.close()
        server.close()


def test_midflight_refusal_falls_back_to_envelope_matches_jax():
    jax_out, port_out = _both(_midflight_refusal_falls_back_to_envelope)
    assert port_out == jax_out == {"is_error": False, "is_array": True, "last": 999.0, "ici": 0}


# --------------------------------------------------------------------------
# the port's own
# --------------------------------------------------------------------------
def test_envelope_never_takes_the_cuda_ipc_reducer():
    """A tensor framed by the envelope pickles as its bytes: the stream
    holds no ``torch.multiprocessing`` rebuild (a CUDA IPC handle for a
    CUDA tensor), even once that module has registered its reducers."""
    import pickle
    import pickletools

    import torch.multiprocessing  # noqa: F401 — registers the IPC reducers

    from ray_tpu_torch.runtime import data_plane, device_plane

    meta, buffers = data_plane.to_frames({"t": torch.arange(8, dtype=torch.float32)})
    names = {arg for op, arg, _ in pickletools.genops(meta) if op.name in ("STACK_GLOBAL", "GLOBAL")
             or isinstance(arg, str)}
    assert "_rebuild_device_array" in names
    assert not any("multiprocessing" in str(n) or "rebuild_cuda" in str(n) for n in names)
    out = pickle.loads(meta, buffers=buffers)
    assert torch.equal(out["t"], torch.arange(8, dtype=torch.float32))
    assert device_plane.is_device_array(out["t"]) and not out["t"].is_cuda


def test_transfer_server_survives_a_peer_that_fails_authentication():
    """F25: a peer whose key differs (a node agent started on its own, not
    by ``multiprocessing``) failed the handshake, and the
    ``AuthenticationError`` ended the server's accept loop; every later
    pull from that server then waited for ever. The loop now skips such a
    peer; the next one with the right key is served."""
    from multiprocessing import AuthenticationError

    from ray_tpu_torch.runtime import device_plane

    server = device_plane.CudaIpcTransferServer()
    try:
        with pytest.raises(AuthenticationError):
            device_plane._IpcConnection(server.address(), b"not-the-key", timeout_s=10)
        conn = server.connect(server.address(), timeout_s=10)  # the right key
        conn.close()
    finally:
        server.close()


def test_head_sends_its_ipc_key_only_to_agents_on_its_host():
    """The head's ``register_node_config`` reply carries its CUDA IPC key
    (F25) only to a peer on its own host: one that reached it over loopback
    or from the head's own IP. An agent on another host, where the
    loopback-bound transfer server is out of reach, never gets it."""
    import multiprocessing
    import types

    from ray_tpu_torch.runtime.remote_node import HeadService

    head = types.SimpleNamespace(data_server=types.SimpleNamespace(port=4321))
    key = bytes(multiprocessing.current_process().authkey)

    def reply(peer, local):
        conn = types.SimpleNamespace(peer_ip=peer, local_ip=local)
        return HeadService._h_register_config(head, conn, {}, 0)

    assert reply("127.0.0.1", "127.0.0.1")["ipc_authkey"] == key
    assert reply("10.0.0.5", "10.0.0.5")["ipc_authkey"] == key
    far = reply("10.0.0.9", "10.0.0.5")
    assert "ipc_authkey" not in far
    assert far["data_address"] == "10.0.0.5:4321"


def test_a_new_key_rebuilds_the_transfer_server():
    """An agent that rejoins a restarted head adopts that head's key; a
    transfer server built under the old key could authenticate with no one,
    so it is closed and the next use starts one under the new key. The same
    key keeps the server."""
    import multiprocessing

    from ray_tpu_torch.runtime import device_plane

    proc = multiprocessing.current_process()
    key = bytes(proc.authkey)
    server = device_plane.CudaIpcTransferServer()
    device_plane.install_transfer_server(server)
    try:
        device_plane.rekey_transfer_server()
        assert device_plane.transfer_server() is server and not server._closed
        proc.authkey = b"the-restarted-heads-key"
        device_plane.rekey_transfer_server()
        assert server._closed and device_plane._xfer_server is None
        assert not device_plane._xfer_probed  # the next use builds anew
    finally:
        proc.authkey = key
        server.close()
        device_plane.install_transfer_server(None)
