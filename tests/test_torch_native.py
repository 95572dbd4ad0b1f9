"""The port's native tier (``ray_tpu_torch/native/``) against the JAX
package's (``ray_tpu/native/``).

The scenarios of ``tests/test_native_{store,frames,ids,io}.py`` run through
both packages (``pkg`` = ``ref`` or ``port``), each on its own build of its
own sources: the shm store's plasma lifecycle, the frame codec, the C id
types and the pread pool. Then what only the port has to show: frames cross
between the two codecs in both directions, the two ``_hotpath`` extensions
live in one process, a port id pickles as a ``ray_tpu_torch`` type, the
build runs once under its lock when processes race it, and in this tree the
runtime runs the native tier: the C codec and ids, and a shm store through
which a 1 MiB array and a 1 MiB tensor reach a process worker by
``ShmRef``, whose segment is gone after ``shutdown``.
"""

from __future__ import annotations

import importlib
import os
import pickle
import socket
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"ref": "ray_tpu", "port": "ray_tpu_torch"}
_LEN = struct.Struct("<I")


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return PKGS[request.param]


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _seg(pkg, tag):
    prefix = "/rt_" if pkg == "ray_tpu" else _mod(pkg, "native.shm_store").SEGMENT_PREFIX
    return f"{prefix}{tag}_{os.getpid()}_{os.urandom(4).hex()}"


# --------------------------------------------------------------------------
# the shm store (tests/test_native_store.py)
# --------------------------------------------------------------------------
@pytest.fixture
def store(pkg):
    s = _mod(pkg, "native.shm_store").ShmObjectStore(_seg(pkg, "test"), 4 << 20)
    yield s
    s.close()
    s.unlink()


def _oid(i: int) -> bytes:
    return i.to_bytes(20, "little")


def test_store_put_get_roundtrip(store):
    store.put(_oid(1), b"hello")
    view, meta = store.get(_oid(1))
    assert bytes(view) == b"hello"
    store.release(_oid(1))


def test_store_create_seal_lifecycle(store):
    buf = store.create(_oid(2), 4)
    buf[:] = b"abcd"
    assert store.get(_oid(2)) is None  # not visible until sealed
    assert not store.contains(_oid(2))
    store.seal(_oid(2))
    assert store.contains(_oid(2))


def test_store_duplicate_create_rejected(store):
    store.put(_oid(3), b"x")
    with pytest.raises(FileExistsError):
        store.create(_oid(3), 1)


def test_store_delete_and_pinning(store):
    store.put(_oid(4), b"data")
    store.get(_oid(4))  # pins
    assert not store.delete(_oid(4))  # refcount > 0
    store.release(_oid(4))
    assert store.delete(_oid(4))
    assert not store.contains(_oid(4))


def test_store_lru_eviction_under_pressure(store):
    blob = b"x" * (256 * 1024)
    for i in range(32):
        store.put(_oid(100 + i), blob)
    assert store.num_objects < 32
    assert store.contains(_oid(131))  # the most recent object survives


def test_store_meta_size_roundtrip(store):
    store.put(_oid(5), b"METAdata", meta_size=4)
    view, meta = store.get(_oid(5))
    assert meta == 4 and bytes(view[:meta]) == b"META"
    store.release(_oid(5))


def test_store_cross_process_read(store, pkg):
    arr = np.arange(1000, dtype=np.float64)
    store.put(_oid(6), arr.tobytes())
    code = f"""
import numpy as np
from {pkg}.native.shm_store import ShmObjectStore
s = ShmObjectStore({store.name!r}, create=False)
view, _ = s.get({_oid(6)!r})
arr = np.frombuffer(view, dtype=np.float64)
assert arr.sum() == {arr.sum()!r}, arr.sum()
s.release({_oid(6)!r})
print("child-ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                         timeout=120)
    assert "child-ok" in out.stdout, out.stderr


def test_store_concurrent_open_single_initializer(pkg):
    """N processes race shm_open on one name (a creator and late readers
    that must wait for its initialization): every opener reads the value."""
    name = _seg(pkg, "race")
    creator_code = f"""
import sys, time
from {pkg}.native.shm_store import ShmObjectStore
s = ShmObjectStore({name!r}, 16 << 20)
s.put(b"k" * 20, b"race-proof")
print("created")
sys.stdout.flush()
time.sleep(3)
"""
    reader_code = f"""
import time
from {pkg}.native.shm_store import ShmObjectStore
s = None
for _ in range(500):
    try:
        s = ShmObjectStore({name!r}, create=False)
        break
    except OSError:
        time.sleep(0.01)
assert s is not None, "segment never appeared"
got = None
for _ in range(200):
    got = s.get(b"k" * 20)
    if got is not None:
        break
    time.sleep(0.01)
view, _ = got
assert bytes(view) == b"race-proof", bytes(view)
s.release(b"k" * 20)
print("reader-ok")
"""
    popen = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
    creator = subprocess.Popen([sys.executable, "-c", creator_code], **popen)
    readers = [subprocess.Popen([sys.executable, "-c", reader_code], **popen) for _ in range(3)]
    try:
        for r in readers:
            out, err = r.communicate(timeout=60)
            assert "reader-ok" in out, err
        creator.kill()
    finally:
        for p in readers + [creator]:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=10)
        _mod(pkg, "native.shm_store").ShmObjectStore(name, 1 << 20).unlink()


# --------------------------------------------------------------------------
# the frame codec (tests/test_native_frames.py)
# --------------------------------------------------------------------------
@pytest.fixture
def pair():
    a, b = socket.socketpair()
    yield a, b
    a.close()
    b.close()


def _hp(pkg):
    return _mod(pkg, "native.hotpath")


def test_frames_roundtrip_c_to_c(pair, pkg):
    a, b = pair
    hp = _hp(pkg)
    dec = hp.FrameDecoder()
    payloads = [b"x" * n for n in (0, 1, 5, 1000, 70_000)]
    for p in payloads:
        hp.send_frame(a.fileno(), p)
    for p in payloads:
        assert dec.read_frame(b.fileno()) == p


def test_frames_c_sender_python_reader(pair, pkg):
    a, b = pair
    _hp(pkg).send_frame(a.fileno(), pickle.dumps(("hello", {"k": 1})))
    assert _mod(pkg, "runtime.protocol").recv_msg(b) == ("hello", {"k": 1})


def test_frames_python_sender_c_reader(pair, pkg):
    a, b = pair
    data = pickle.dumps(("msg", {"v": list(range(100))}))
    a.sendall(_LEN.pack(len(data)) + data)
    dec = _hp(pkg).FrameDecoder()
    assert pickle.loads(dec.read_frame(b.fileno())) == ("msg", {"v": list(range(100))})


def test_frames_fragmented_delivery(pair, pkg):
    a, b = pair
    payload = os.urandom(300)
    frame = _LEN.pack(len(payload)) + payload
    got = []
    dec = _hp(pkg).FrameDecoder()
    t = threading.Thread(target=lambda: got.append(dec.read_frame(b.fileno())))
    t.start()
    for i in range(len(frame)):
        a.sendall(frame[i: i + 1])
    t.join(timeout=10)
    assert got == [payload]


def test_frames_burst_drains_without_extra_recv(pair, pkg):
    a, b = pair
    frames = [os.urandom(n) for n in (10, 0, 200, 33)]
    blob = b"".join(_LEN.pack(len(p)) + p for p in frames)
    a.sendall(blob)
    dec = _hp(pkg).FrameDecoder()
    assert dec.read_frame(b.fileno()) == frames[0]
    assert dec.pending() == len(blob) - 4 - len(frames[0])
    for p in frames[1:]:
        assert dec.read_frame(b.fileno()) == p
    assert dec.pending() == 0


def test_frames_large_frame_grows_and_shrinks(pair, pkg):
    a, b = pair
    hp = _hp(pkg)
    payload = os.urandom(8 << 20)
    t = threading.Thread(target=hp.send_frame, args=(a.fileno(), payload))
    t.start()
    dec = hp.FrameDecoder()
    assert dec.read_frame(b.fileno()) == payload
    t.join(timeout=30)
    hp.send_frame(a.fileno(), b"tail")
    assert dec.read_frame(b.fileno()) == b"tail"


def test_frames_eof_raises_connection_error(pair, pkg):
    a, b = pair
    a.close()
    with pytest.raises(ConnectionError):
        _hp(pkg).FrameDecoder().read_frame(b.fileno())


def test_frames_eof_mid_frame_raises(pair, pkg):
    a, b = pair
    a.sendall(_LEN.pack(100) + b"only-some")
    a.close()
    with pytest.raises(ConnectionError):
        _hp(pkg).FrameDecoder().read_frame(b.fileno())


def test_frames_closed_fd_raises_oserror(pair, pkg):
    a, b = pair
    dec = _hp(pkg).FrameDecoder()
    fd = b.fileno()
    b.close()
    with pytest.raises(OSError):
        dec.read_frame(fd)


def test_frames_reader_wrapper_matches_send_msg(pair, pkg):
    a, b = pair
    protocol = _mod(pkg, "runtime.protocol")
    reader = protocol.FrameReader(b)
    protocol.send_msg(a, "result", {"task_id": b"t" * 20, "value": 42})
    assert reader.recv() == ("result", {"task_id": b"t" * 20, "value": 42})


def test_frames_concurrent_senders_one_lock_no_interleave(pair, pkg):
    a, b = pair
    hp = _hp(pkg)
    lock = threading.Lock()
    sent = []

    def sender(tid):
        for i in range(50):
            p = bytes([tid]) * (i + 1)
            with lock:
                sent.append(p)
                hp.send_frame(a.fileno(), p)

    threads = [threading.Thread(target=sender, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    dec = hp.FrameDecoder()
    got = [dec.read_frame(b.fileno()) for _ in range(200)]
    assert sorted(got) == sorted(sent)


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_frames_cross_between_the_two_codecs(pair, direction):
    """One wire format: either package's C sender, the other's C decoder
    and its protocol reader."""
    a, b = pair
    src, dst = ("ray_tpu_torch", "ray_tpu") if direction == "port_to_ref" else (
        "ray_tpu", "ray_tpu_torch")
    payloads = [pickle.dumps(("m", {"i": i, "blob": os.urandom(i * 997)})) for i in range(3)]
    for p in payloads:
        _hp(src).send_frame(a.fileno(), p)
    dec = _hp(dst).FrameDecoder()
    assert [dec.read_frame(b.fileno()) for _ in payloads] == payloads
    # each reader below starts on an empty socket: a C decoder buffers
    # whatever the socket holds, so two readers never share one
    msgs = [("m", {"i": i, "blob": os.urandom(i * 1013)}) for i in range(2)]
    for m in msgs:
        _mod(src, "runtime.protocol").send_msg(a, *m)
    reader = _mod(dst, "runtime.protocol").FrameReader(b)
    assert [reader.recv() for _ in msgs] == msgs
    _mod(src, "runtime.protocol").send_msg(a, "done", {"ok": True})
    assert _mod(dst, "runtime.protocol").recv_msg(b) == ("done", {"ok": True})


# --------------------------------------------------------------------------
# the C ids (tests/test_native_ids.py)
# --------------------------------------------------------------------------
def test_ids_native_tier_is_active(pkg):
    hp, ids = _hp(pkg), _mod(pkg, "core.ids")
    assert ids.TaskID is hp.TaskID and ids.ObjectID is hp.ObjectID
    assert ids.ObjectID.__module__ == f"{pkg}.core.ids"


def test_ids_layouts_and_lineage(pkg):
    hp = _hp(pkg)
    job = hp.JobID.from_int(9)
    assert job.binary() == (9).to_bytes(4, "little") and job.int_value() == 9
    actor = hp.ActorID.of(job)
    assert len(actor.binary()) == 12 and actor.job_id() == job
    t = hp.TaskID.for_actor_task(actor)
    assert len(t.binary()) == 20 and t.actor_id() == actor and t.job_id() == job
    tn = hp.TaskID.for_normal_task(job)
    assert tn.actor_id().is_nil() and tn.job_id() == job
    tc = hp.TaskID.for_actor_creation(actor)
    assert tc.binary()[:8] == b"\x00" * 8 and tc.actor_id() == actor
    assert hp.TaskID.for_driver(job).binary()[:8] == b"\xfe" * 8
    o = hp.ObjectID.for_task_return(t, 3)
    assert o.task_id() == t and o.job_id() == job and o.index() == 3
    assert o.is_return() and not o.is_put()
    p = hp.ObjectID.for_put(t, 3)
    assert p.is_put() and not p.is_return() and p.index() & 0x7FFFFFFF == 3 and p != o
    assert hp.PlacementGroupID.of(job).job_id() == job


def test_ids_task_mint_monotonic_and_unique(pkg):
    hp = _hp(pkg)
    job = hp.JobID.from_int(1)
    a, b = hp.TaskID.for_normal_task(job), hp.TaskID.for_normal_task(job)
    assert a != b
    assert int.from_bytes(a.binary()[:8], "little") < int.from_bytes(b.binary()[:8], "little")


def test_ids_equality_hash_dict_semantics(pkg):
    hp = _hp(pkg)
    t = hp.TaskID.for_normal_task(hp.JobID.from_int(2))
    same = hp.TaskID(t.binary())
    assert t == same and hash(t) == hash(same) and {t: "x"}[same] == "x"
    n = hp.NodeID.from_random()
    assert n != hp.WorkerID(n.binary())
    assert t != t.binary() and t != "not an id"
    assert hp.NodeID(b"\x00" * 16) < hp.NodeID(b"\x01" + b"\x00" * 15)


def test_ids_nil_and_validation(pkg):
    hp = _hp(pkg)
    assert hp.ActorID.nil().is_nil() and hp.ActorID.nil() == hp.ActorID.nil()
    with pytest.raises(ValueError):
        hp.TaskID(b"short")
    assert isinstance(hp.NodeID.from_hex(hp.NodeID.from_random().hex()), hp.NodeID)


def test_ids_pickle_resolves_through_ids_module(pkg):
    hp = _hp(pkg)
    t = hp.TaskID.for_normal_task(hp.JobID.from_int(5))
    blob = pickle.dumps(t, protocol=5)
    assert f"{pkg}.core.ids".encode() in blob
    t2 = pickle.loads(blob)
    assert t2 == t and type(t2) is type(t)


def test_ids_job_counter_ensure_above(pkg):
    hp = _hp(pkg)
    hp.JobID.ensure_above(10_000)
    assert hp.JobID.next().int_value() > 10_000


def test_ids_pure_python_fallback_parity(pkg):
    """A RAY_TPU_PURE_PY_IDS=1 process builds the same ids from the same
    recipe, unpickles the C tier's, and round-trips its own back."""
    hp = _hp(pkg)
    o = hp.ObjectID.for_put(hp.TaskID.for_actor_task(hp.ActorID.of(hp.JobID.from_int(3))), 7)
    script = f"""
import os, pickle, sys
assert os.environ["RAY_TPU_PURE_PY_IDS"] == "1"
from {pkg}.core import ids
assert ids.TaskID.__flags__ & (1 << 9), "expected the pure-Python id tier"
o = pickle.loads(sys.stdin.buffer.read())
assert type(o) is ids.ObjectID
t = o.task_id()
assert o.is_put() and o.index() & 0x7FFFFFFF == 7
job = ids.JobID.from_int(3)
assert t.job_id() == job
assert ids.TaskID.for_driver(job).binary()[:8] == b"\\xfe" * 8
sys.stdout.buffer.write(pickle.dumps(o))
"""
    proc = subprocess.run([sys.executable, "-c", script], input=pickle.dumps(o),
                          capture_output=True, env=dict(os.environ, RAY_TPU_PURE_PY_IDS="1"),
                          cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()
    back = pickle.loads(proc.stdout)
    assert back == o and type(back) is hp.ObjectID


def test_ids_abstract_base_rejects_classmethods(pkg):
    hp = _hp(pkg)
    for m in ("nil", "from_random"):
        with pytest.raises(TypeError):
            getattr(hp.BaseID, m)()
    with pytest.raises(TypeError):
        hp.BaseID.from_hex("00")

    class MyID(hp.BaseID):
        pass

    for m in ("nil", "from_random"):
        with pytest.raises(TypeError):
            getattr(MyID, m)()


def test_two_extensions_one_process_and_their_own_names():
    """Both packages' ``_hotpath`` (one init symbol) load side by side; a
    port id pickles as ``ray_tpu_torch.core.ids`` and never loads as the
    JAX package's class."""
    port, ref = _hp("ray_tpu_torch"), _hp("ray_tpu")
    assert port._mod is not ref._mod and port._mod.__file__ != ref._mod.__file__
    assert port._mod.__name__ == "ray_tpu_torch.native._hotpath"
    assert not port._mod.__file__.startswith(os.path.join(REPO, "ray_tpu", ""))
    assert port.FrameDecoder.__module__ == "ray_tpu_torch.native._hotpath"
    t = port.TaskID.for_normal_task(port.JobID.from_int(4))
    blob = pickle.dumps(t)
    assert b"ray_tpu_torch.core.ids" in blob and b"ray_tpu.core.ids" not in blob
    back = pickle.loads(blob)
    assert type(back) is port.TaskID and type(back) is not ref.TaskID
    assert back != ref.TaskID(t.binary())  # same bytes, another package's type


def test_pure_python_frames_switch():
    code = ("from ray_tpu_torch.runtime import protocol\n"
            "assert protocol._native is None, protocol._native\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120,
                   env=dict(os.environ, RAY_TPU_PURE_PY_FRAMES="1"))


# --------------------------------------------------------------------------
# the pread pool (tests/test_native_io.py)
# --------------------------------------------------------------------------
@pytest.fixture
def pool(pkg):
    p = _mod(pkg, "native.io_pool").IOPool(num_threads=4)
    yield p
    p.close()


def test_io_read_files_in_order(tmp_path, pool):
    paths = []
    for i in range(10):
        p = tmp_path / f"f{i}.bin"
        p.write_bytes(bytes([i]) * (1000 + i))
        paths.append(str(p))
    for i, data in enumerate(pool.read_files(paths)):
        assert data == bytes([i]) * (1000 + i)


def test_io_read_ranges(tmp_path, pool):
    p = tmp_path / "r.bin"
    p.write_bytes(bytes(range(256)))
    out = pool.read_ranges([(str(p), 0, 16), (str(p), 100, 28), (str(p), 250, 20)])
    assert out == [bytes(range(16)), bytes(range(100, 128)), bytes(range(250, 256))]


def test_io_write_then_read(tmp_path, pool):
    p = str(tmp_path / "w.bin")
    payload = os.urandom(65536)
    assert pool.write_file(p, payload) == len(payload)
    assert pool.read_files([p])[0] == payload


def test_io_write_files_concurrent(tmp_path, pool):
    items = [(str(tmp_path / f"w{i}.bin"), os.urandom(1024)) for i in range(8)]
    assert pool.write_files(items) == [1024] * 8
    for path, data in items:
        with open(path, "rb") as f:
            assert f.read() == data


def test_io_missing_file_raises(tmp_path, pool, pkg):
    jid = pool.submit_read(str(tmp_path / "nope.bin"), bytearray(10))
    with pytest.raises(OSError):
        pool.wait(jid)
    with pytest.raises(OSError):
        _mod(pkg, "native.io_pool").file_size(str(tmp_path / "nope.bin"))


def test_io_file_size(tmp_path, pool, pkg):
    p = tmp_path / "s.bin"
    p.write_bytes(b"x" * 12345)
    assert _mod(pkg, "native.io_pool").file_size(str(p)) == 12345


def test_io_many_concurrent_jobs(tmp_path, pool):
    p = tmp_path / "big.bin"
    blob = os.urandom(1 << 20)
    p.write_bytes(blob)
    out = pool.read_ranges([(str(p), i * 4096, 4096) for i in range(256)])
    for i, chunk in enumerate(out):
        assert chunk == blob[i * 4096: (i + 1) * 4096]


def test_io_default_pool_singleton(pkg):
    mod = _mod(pkg, "native.io_pool")
    a, b = mod.default_pool(), mod.default_pool()
    assert a is b and a is not None


def test_io_read_files_missing_second_file_safe(tmp_path, pool):
    ok = tmp_path / "ok.bin"
    ok.write_bytes(b"y" * 4096)
    with pytest.raises(OSError):
        pool.read_files([str(ok), str(tmp_path / "gone.bin")])
    assert bytes(pool.read_files([str(ok)])[0]) == b"y" * 4096


def test_io_iter_reads_early_close_drains(tmp_path, pool):
    paths = []
    for i in range(6):
        p = tmp_path / f"it{i}.bin"
        p.write_bytes(bytes([i]) * 8192)
        paths.append(str(p))
    it = pool.iter_reads([(p, 0, 8192) for p in paths])
    assert bytes(next(it)) == bytes([0]) * 8192
    it.close()
    out = pool.read_files(paths)
    assert all(bytes(b) == bytes([i]) * 8192 for i, b in enumerate(out))


def test_io_default_pool_failure_cached(monkeypatch, pkg):
    mod = _mod(pkg, "native.io_pool")
    monkeypatch.setattr(mod, "_default_pool", None)
    attempts = []

    class Boom:
        def __init__(self, *a, **k):
            attempts.append(1)
            raise OSError("no toolchain")

    monkeypatch.setattr(mod, "IOPool", Boom)
    assert mod.default_pool() is None and mod.default_pool() is None
    assert len(attempts) == 1


def test_io_zero_byte_files(tmp_path, pool):
    empty = tmp_path / "empty.bin"
    empty.write_bytes(b"")
    full = tmp_path / "full.bin"
    full.write_bytes(b"z" * 128)
    out = pool.read_files([str(empty), str(full), str(empty)])
    assert [bytes(b) for b in out] == [b"", b"z" * 128, b""]


def test_io_iter_reads_window_bounds_inflight(tmp_path, pool):
    paths = []
    for i in range(12):
        p = tmp_path / f"w{i}.bin"
        p.write_bytes(bytes([i]) * 256)
        paths.append((str(p), 0, 256))
    out = list(pool.iter_reads(paths, window=2))
    assert [bytes(b)[:1] for b in out] == [bytes([i]) for i in range(12)]


def test_io_write_files_partial_failure_drains(tmp_path, pool):
    ok = str(tmp_path / "ok.bin")
    bad = str(tmp_path / "nodir" / "x.bin")
    with pytest.raises(OSError):
        pool.write_files([(bad, b"a" * 64), (ok, b"b" * 64)])
    assert pool.write_file(ok, b"c" * 64) == 64
    assert not pool._pending_bufs


# --------------------------------------------------------------------------
# the port's build and the runtime on the native tier
# --------------------------------------------------------------------------
def test_racing_processes_build_once_under_the_lock(tmp_path):
    """Three processes ask a fresh build directory for the pool library at
    once: one compiles, the others wait on the lock; all load the same
    file, and no temporary file is left."""
    code = ("import sys\n"
            "from ray_tpu_torch.native import _build\n"
            "_build.BUILD = sys.argv[1]\n"
            "from ray_tpu_torch.native import io_pool\n"
            "print(_build.library_path('io_pool'))\n"
            "print(io_pool.file_size(sys.argv[2]))\n")
    probe = tmp_path / "probe.bin"
    probe.write_bytes(b"p" * 77)
    build = str(tmp_path / "build")
    procs = [subprocess.Popen([sys.executable, "-c", code, build, str(probe)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=180) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    lines = {o.split() and tuple(o.split()) for o, _ in outs}
    assert len(lines) == 1
    lib, size = lines.pop()
    assert lib.startswith(build + os.sep) and size == "77"
    out_dir = os.path.dirname(lib)
    assert sorted(os.listdir(out_dir)) == [".lock", "build.log", "libtpuio.so"]


def test_runtime_runs_the_native_tier_and_bulk_values_go_by_shm(monkeypatch):
    import ray_tpu_torch as rt
    from torch_runtime_tasks import _value_facts

    from ray_tpu_torch.core import ids
    from ray_tpu_torch.native import hotpath
    from ray_tpu_torch.native.shm_store import SEGMENT_PREFIX
    from ray_tpu_torch.runtime import protocol

    assert protocol._native is hotpath
    assert ids.ObjectID is hotpath.ObjectID and ids.TaskID is hotpath.TaskID
    encoded = []
    real = protocol.encode_value

    def spy(value, shm_store, id_factory):
        out = real(value, shm_store, id_factory)
        encoded.append(type(out).__name__)
        return out

    monkeypatch.setattr(protocol, "encode_value", spy)
    arr = np.arange(1 << 18, dtype=np.float32)                        # 1 MiB
    ten = torch.arange(1 << 19, dtype=torch.float32).to(torch.bfloat16)  # 1 MiB
    rt.init(num_cpus=2)
    try:
        cluster = rt.get_cluster()
        assert cluster.shm_store is not None
        name = cluster.shm_store.name
        assert name.startswith(SEGMENT_PREFIX) and os.path.exists("/dev/shm" + name)
        task = rt.remote(_value_facts).options(execution="process")
        got_arr = rt.get(task.remote(arr))
        got_ten = rt.get(task.remote(ten))
        assert encoded == ["ShmRef", "ShmRef"]
    finally:
        rt.shutdown()
    assert got_arr[:4] == ("ndarray", "float32", float(arr.sum()), arr.shape)
    assert got_ten[:4] == ("Tensor", "torch.bfloat16", float(ten.float().sum()), tuple(ten.shape))
    assert got_arr[4] != os.getpid() and got_ten[4] != os.getpid()
    assert not os.path.exists("/dev/shm" + name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int64", "bool"])
def test_tensor_through_the_arena_is_the_in_band_tensor(dtype):
    """``encode_value``/``decode_value`` of a tensor over the arena give
    the tensor the in-band path gives: dtype, shape, grad flag and bits."""
    from ray_tpu_torch.core import serialization
    from ray_tpu_torch.native.shm_store import ShmObjectStore
    from ray_tpu_torch.runtime import protocol

    g = torch.Generator().manual_seed(7)
    src = (torch.randn(600, 512, generator=g) * 10).to(getattr(torch, dtype))  # >= 256 KiB
    if dtype == "float32":
        src.requires_grad_(True)
    store = ShmObjectStore(_seg("ray_tpu_torch", "tensor"), 8 << 20)
    try:
        ids = iter(range(1, 100))
        ref = protocol.encode_value(src, store, lambda: next(ids).to_bytes(20, "little"))
        assert isinstance(ref, protocol.ShmRef)
        got = protocol.decode_value(ref, store)
        band = serialization.get_context().deserialize(serialization.get_context().serialize(src))
        for t in (got, band):
            assert t.dtype == src.dtype and t.shape == src.shape and t.device.type == "cpu"
            assert t.requires_grad == src.requires_grad
        bits = (lambda t: t.detach().view(torch.int16)) if dtype == "bfloat16" else (
            lambda t: t.detach())
        assert torch.equal(bits(got), bits(src)) and torch.equal(bits(band), bits(src))
        del got
    finally:
        store.close()
        store.unlink()
