"""The port's data library (``ray_tpu_torch.data``) against the JAX
package's, scenario by scenario.

Each scenario is a function of one package's runtime and data module
(``rt``, ``rd``) and a scratch directory of its own. It drives the library
as a user would, makes the JAX test's assertions and returns what the user
sees. Each package runs every scenario of a file under one runtime on the
CPU (one ``init`` a package, as the JAX test modules share one), and each
scenario's outputs must be equal: arrays with their dtype and shape, numpy
scalars with their type, strings with the package's name, ids and paths
masked (``_norm`` of ``tests/test_torch_runtime.py``). The scenarios are
those of the JAX package's ``tests/test_data.py``; ``test_iter_jax_batches``
is held as ``iter_device_batches(device="cpu")`` against ``np.asarray`` of
the JAX arrays, bitwise.

Then what is the port's own: a map stage given ``num_gpus`` runs next to the
card in the port and in a CUDA-blind process worker in the JAX package
(F9), the device on-ramp on the CPU and on two gloo ranks against
``iter_jax_batches(sharding=)`` on the virtual devices, and the pumps that
``shutdown`` stops. Task functions are lambdas and nested functions: they
travel to process workers by value (cloudpickle), so a worker imports
neither this module, nor JAX, nor torch.
"""

import gc
import importlib
import math
import os
import threading
import time
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_runtime import _error, _norm  # noqa: E402

PACKAGES = ("ray_tpu", "ray_tpu_torch")


# --------------------------------------------------------------------------
# the harness
# --------------------------------------------------------------------------
def _canon(v):
    """A user-visible output as a comparable value: arrays keep dtype and
    shape, numpy scalars their type, tensors their dtype and shape."""
    if isinstance(v, np.ndarray):
        items = v.tolist()
        if v.dtype == object:
            items = _canon(items)
        return ("ndarray", v.dtype.str, v.shape, items)
    if isinstance(v, np.generic):
        return (type(v).__name__, _canon(v.item()))
    if isinstance(v, torch.Tensor):
        return ("tensor", str(v.dtype), tuple(v.shape), v.tolist())
    if isinstance(v, float) and math.isnan(v):
        return ("float", "nan")
    if isinstance(v, str):
        return _norm(v)
    if isinstance(v, dict):
        return {_canon(k): _canon(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_canon(x) for x in v)
    return v


def _raised(exc):
    return ("raised", _canon(_error(exc)))


def _raises(fn, *args, **kw):
    """What a caller sees when ``fn`` raises (AssertionError if it does not)."""
    try:
        fn(*args, **kw)
    except Exception as exc:  # noqa: BLE001 - the error is the output
        return _canon(_error(exc))
    raise AssertionError(f"{fn!r} did not raise")


def _pumps(prefixes=("to-torch-prefetch", "streaming-split")):
    return [t for t in threading.enumerate() if t.name.startswith(prefixes)]


def _quiesce():
    """Let abandoned iterators close before a runtime goes: a JAX pump's
    late ``get`` would start a new runtime (F6)."""
    gc.collect()
    deadline = time.time() + 10
    while _pumps() and time.time() < deadline:
        time.sleep(0.05)


def run_all(scenarios, tmp_root, init=None):
    """Every scenario through each package under one runtime: {scenario
    name: {package: canonical output, or ("raised", error)}}. Each runs with
    ``preserve_order`` on in this thread (a pump thread has its own
    context: a scenario that iterates there reads one block)."""
    out = {s.__name__: {} for s in scenarios}
    for name in PACKAGES:
        rt = importlib.import_module(name)
        rd = importlib.import_module(name + ".data")
        importlib.import_module(name + ".core.config").reset_config()
        # every task in a process worker (no adaptive move into this
        # process): pyarrow reads on the runtime's task threads here
        # crashed the test process now and then (a segfault inside
        # pyarrow) when other test files had run in it before
        rt.init(**(init or {"num_cpus": 8}), _system_config={"inproc_task_threshold_s": 0})
        try:
            ctx = rd.DataContext.get_current()
            for s in scenarios:
                tmp = tmp_root / name / s.__name__
                tmp.mkdir(parents=True)
                ctx.preserve_order = True  # blocks in dispatch order: comparable streams
                try:
                    out[s.__name__][name] = _canon(s(rt, rd, tmp))
                except pytest.skip.Exception as exc:  # an optional package is absent
                    out[s.__name__][name] = ("skipped", str(exc))
                except Exception as exc:  # noqa: BLE001 - compared below
                    out[s.__name__][name] = _raised(exc)
                    out[s.__name__][name + ":tb"] = traceback.format_exc()
                finally:
                    ctx.preserve_order = False
            _quiesce()
        finally:
            rt.shutdown()
            importlib.import_module(name + ".core.config").reset_config()
    return out


def _tag(out):
    if isinstance(out, tuple) and out and out[0] in ("raised", "skipped"):
        return out[0]
    return None


def check(outputs, scenario):
    got = outputs[scenario.__name__]
    jax_out, port_out = got["ray_tpu"], got["ray_tpu_torch"]
    if _tag(jax_out) == _tag(port_out) == "skipped":
        pytest.skip(port_out[1])
    assert _tag(jax_out) is None, got.get("ray_tpu:tb")
    assert port_out == jax_out, got.get("ray_tpu_torch:tb")


@pytest.fixture(autouse=True)
def _no_runtime_left():
    yield
    for name in PACKAGES:
        assert not importlib.import_module(name).is_initialized(), name


def _rows(ds, key=None):
    rows = ds.take_all()
    return sorted(rows, key=key) if key else rows


# --------------------------------------------------------------------------
# test_data.py
# --------------------------------------------------------------------------
def s_range_count_take(rt, rd, tmp):
    ds = rd.range(100)
    rows = ds.take(5)
    assert ds.count() == 100 and rows == [{"id": i} for i in range(5)]
    return {"count": ds.count(), "take": rows}


def s_range_tensor(rt, rd, tmp):
    rows = rd.range_tensor(8, shape=(2, 2)).take(2)
    assert rows[0]["data"].shape == (2, 2) and (rows[1]["data"] == 1).all()
    return rows


def s_from_items_map_filter(rt, rd, tmp):
    ds = rd.from_items([{"x": i} for i in range(50)])
    out = ds.map(lambda r: {"y": r["x"] * 2}).filter(lambda r: r["y"] % 4 == 0)
    return out.take_all()


def s_map_batches_numpy(rt, rd, tmp):
    out = rd.range(64).map_batches(lambda b: {"sq": b["id"] ** 2}, batch_size=16)
    return out.take_all()


def s_flat_map(rt, rd, tmp):
    out = rd.from_items([{"x": 1}, {"x": 2}]).flat_map(lambda r: [{"x": r["x"]}, {"x": -r["x"]}])
    return out.take_all()


def s_fusion_in_plan(rt, rd, tmp):
    L = importlib.import_module(rd.__name__ + ".logical")
    ds = rd.range(10).map(lambda r: r).map(lambda r: r)
    optimized = L.optimize(ds._logical_op)
    assert isinstance(optimized, L.FusedMap) and len(optimized.stages) == 2
    return [type(optimized).__name__, optimized.name, L.plan_to_string(optimized)]


def s_limit_streaming(rt, rd, tmp):
    ds = rd.range(1000)
    return [ds.take(7), ds.limit(13).count()]


def s_sort(rt, rd, tmp):
    vals = np.random.default_rng(0).permutation(200)
    ds = rd.from_items([{"v": int(v)} for v in vals])
    return [ds.sort("v").take_all(), ds.sort("v", descending=True).take_all()]


def s_random_shuffle_preserves_multiset(rt, rd, tmp):
    rows = rd.range(100).random_shuffle(seed=42).take_all()
    assert sorted(r["id"] for r in rows) == list(range(100))
    return rows


def s_repartition(rt, rd, tmp):
    mat = rd.range(100, parallelism=4).repartition(10).materialize()
    return [mat.num_blocks(), mat.count(), mat.take_all()]


def s_groupby_aggregate(rt, rd, tmp):
    ds = rd.from_items([{"k": i % 3, "v": i} for i in range(30)])
    return _rows(ds.groupby("k").sum("v"), key=lambda r: r["k"])


def s_global_aggregates(rt, rd, tmp):
    ds = rd.from_items([{"v": float(i)} for i in range(10)])
    out = [ds.sum("v"), ds.min("v"), ds.max("v"), ds.mean("v"), ds.std("v")]
    assert out[4] == pytest.approx(np.std(np.arange(10.0), ddof=1))
    return out


def s_unique(rt, rd, tmp):
    return rd.from_items([{"v": i % 4} for i in range(20)]).unique("v")


def s_union_zip(rt, rd, tmp):
    a = rd.from_items([{"x": 1}, {"x": 2}])
    b = rd.from_items([{"x": 3}])
    c = rd.from_items([{"y": 10}, {"y": 20}])
    return [_rows(a.union(b), key=lambda r: r["x"]), a.zip(c).take_all()]


def s_add_drop_select_columns(rt, rd, tmp):
    ds = rd.range(10).add_column("double", lambda b: b["id"] * 2)
    return [ds.take(1), ds.select_columns(["double"]).take(1), ds.drop_columns(["id"]).take(1)]


def s_iter_batches(rt, rd, tmp):
    return list(rd.range(100).iter_batches(batch_size=32))


def s_iter_batches_local_shuffle(rt, rd, tmp):
    ids = []
    for b in rd.range(100).iter_batches(batch_size=50, local_shuffle_buffer_size=100,
                                        local_shuffle_seed=0):
        ids.extend(b["id"].tolist())
    assert sorted(ids) == list(range(100)) and ids != list(range(100))
    return ids


def _device_batches(rt, rd, ds, **kw):
    """The on-ramp's batches as host arrays: ``iter_jax_batches`` (JAX
    arrays, read back by ``np.asarray``) or ``iter_device_batches`` on the
    CPU, with the same dtypes named in each package's own types; bfloat16
    read back widened to float32 (exact), as numpy has no bfloat16."""
    dtypes = kw.pop("dtypes", {})
    if rt.__name__ == "ray_tpu":
        import jax.numpy as jnp

        it = ds.iter_jax_batches(dtypes={k: getattr(jnp, d) for k, d in dtypes.items()}, **kw)
        return [{k: np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v)
                 for k, v in b.items()} for b in it]
    it = ds.iter_device_batches(dtypes={k: getattr(torch, d) for k, d in dtypes.items()},
                                device="cpu", **kw)
    out = []
    for b in it:
        assert all(v.device.type == "cpu" for v in b.values() if isinstance(v, torch.Tensor))
        out.append({k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
                    if isinstance(v, torch.Tensor) else v for k, v in b.items()})
    return out


def s_iter_jax_batches(rt, rd, tmp):
    """test_iter_jax_batches: int64 ids (JAX without x64 keeps 32 bits, so
    both name int32), a float32 column, a cast to bfloat16, the last partial
    batch dropped, and an object column that stays on the host."""
    ds = rd.range(64).add_column("x", lambda b: np.float32(0.5) * b["id"].astype(np.float32))
    batches = _device_batches(rt, rd, ds, batch_size=32, dtypes={"id": "int32"})
    assert batches[0]["id"].shape == (32,)
    feats = np.random.default_rng(5).standard_normal((40, 3)).astype(np.float32)
    ds2 = rd.from_numpy(feats)
    text = rd.from_items([{"s": {"k": i}, "v": i} for i in range(6)])
    assert batches and text.take_batch(3)["s"].dtype == object
    return {"batches": batches,
            "bf16": _device_batches(rt, rd, ds2, batch_size=16, dtypes={"data": "bfloat16"}),
            "f32": _device_batches(rt, rd, ds2, batch_size=16),
            "object_col": _device_batches(rt, rd, text, batch_size=3, dtypes={"v": "int32"})}


def s_split_and_streaming_split(rt, rd, tmp):
    shards = rd.range(100, parallelism=4).split(4)
    its = rd.range(100, parallelism=4).streaming_split(2)
    per = [sum(len(b["id"]) for b in it.iter_batches(batch_size=None)) for it in its]
    assert sum(per) == 100
    return {"split": [s.count() for s in shards], "streaming_total": sum(per)}


def s_actor_pool_map_batches(rt, rd, tmp):
    class AddConst:
        def __init__(self, c=100):
            self.c = c

        def __call__(self, batch):
            return {"v": batch["id"] + self.c}

    ds = rd.range(40).map_batches(AddConst, batch_size=10, concurrency=2, fn_constructor_args=(100,))
    return _rows(ds, key=lambda r: r["v"])


def s_csv_json_roundtrip(rt, rd, tmp):
    ds = rd.from_items([{"a": i, "b": float(i) / 2} for i in range(20)])
    ds.write_csv(str(tmp / "csv"))
    ds.write_json(str(tmp / "json"))
    back_csv = rd.read_csv(str(tmp / "csv"))
    back_json = rd.read_json(str(tmp / "json"))
    return [back_csv.count(), _rows(back_csv, key=lambda r: r["a"]), back_json.count(),
            _rows(back_json, key=lambda r: r["a"]), sorted(os.listdir(tmp / "csv"))]


def s_numpy_roundtrip(rt, rd, tmp):
    rd.from_numpy(np.arange(12).reshape(12, 1)).write_numpy(str(tmp / "np"))
    back = rd.read_numpy(str(tmp / "np"))
    return [back.count(), back.take_all()]


def s_map_groups(rt, rd, tmp):
    block_mod = rd.__name__ + ".block"

    def top1(group):
        acc = importlib.import_module(block_mod).BlockAccessor(group)
        return [max(acc.iter_rows(), key=lambda r: r["v"])]

    ds = rd.from_items([{"k": i % 2, "v": i} for i in range(10)])
    return _rows(ds.groupby("k").map_groups(top1), key=lambda r: r["k"])


def s_train_test_split(rt, rd, tmp):
    train, test = rd.range(100).train_test_split(0.2)
    return [train.count(), test.count(), test.take_all()]


def s_stats_after_execution(rt, rd, tmp):
    ds = rd.range(50)
    before = ds.stats()
    ds.count()
    return [before, "tasks" in ds.stats()]


def s_read_text(rt, rd, tmp):
    p = tmp / "a.txt"
    p.write_text("alpha\nbeta\n\ngamma\n")
    return rd.read_text(str(p)).take_all()


def s_read_binary_files(rt, rd, tmp):
    (tmp / "x.bin").write_bytes(b"\x00\x01\x02")
    (tmp / "y.bin").write_bytes(b"abc")
    rows = sorted(rd.read_binary_files(str(tmp), include_paths=True).take_all(),
                  key=lambda r: r["path"])
    return [(os.path.basename(r["path"]), r["bytes"]) for r in rows]


def s_read_images(rt, rd, tmp):
    Image = pytest.importorskip("PIL.Image")
    for i, color in enumerate([(255, 0, 0), (0, 255, 0)]):
        Image.new("RGB", (8, 6), color).save(tmp / f"img{i}.png")
    rows = rd.read_images(str(tmp), size=(4, 4), mode="RGB").take_all()
    return sorted((r["image"] for r in rows), key=lambda a: a.tobytes())


def _tar(path, payloads):
    import io
    import tarfile

    with tarfile.open(path, "w") as tf:
        for name, payload in payloads.items():
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            tf.addfile(info, io.BytesIO(payload))


def s_read_webdataset(rt, rd, tmp):
    import json

    payloads = {}
    for key, label in [("sample_a", 3), ("sample_b", 7)]:
        payloads.update({f"{key}.txt": f"caption for {key}".encode(),
                         f"{key}.cls": str(label).encode(),
                         f"{key}.json": json.dumps({"k": key}).encode()})
    _tar(tmp / "shard-000.tar", payloads)
    return sorted(rd.read_webdataset(str(tmp / "shard-000.tar")).take_all(),
                  key=lambda r: r["__key__"])


def s_read_webdataset_dotted_dirs_and_multipart_exts(rt, rd, tmp):
    import io

    buf = io.BytesIO()
    np.save(buf, np.arange(6, dtype=np.int32))
    _tar(tmp / "shard-dotted.tar", {"v1.0/a.txt": b"hello", "v1.0/a.seg.npy": buf.getvalue(),
                                    "v1.0/a.cls": b"-1"})
    return rd.read_webdataset(str(tmp / "shard-dotted.tar")).take_all()


def s_write_read_parquet_roundtrip(rt, rd, tmp):
    pytest.importorskip("pyarrow")
    rd.from_items([{"a": i, "b": float(i) * 0.5} for i in range(100)]).write_parquet(str(tmp / "pq"))
    return _rows(rd.read_parquet(str(tmp / "pq")), key=lambda r: r["a"])


def s_read_sql_sqlite(rt, rd, tmp):
    import sqlite3

    db = str(tmp / "t.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE users (id INTEGER, name TEXT, score REAL)")
    conn.executemany("INSERT INTO users VALUES (?, ?, ?)", [(i, f"u{i}", i * 1.5) for i in range(10)])
    conn.commit()
    conn.close()
    ds = rd.read_sql("SELECT * FROM users ORDER BY id", lambda: sqlite3.connect(db))
    ds2 = rd.read_sql("SELECT * FROM users", lambda: sqlite3.connect(db),
                      shard_queries=["SELECT * FROM users WHERE id < 5",
                                     "SELECT * FROM users WHERE id >= 5"])
    return [ds.take_all(), _rows(ds2, key=lambda r: r["id"])]


def s_read_text_crlf_newlines(rt, rd, tmp):
    p = tmp / "crlf.txt"
    p.write_bytes(b"alpha\r\nbeta\rgamma\n")
    return rd.read_text(str(p)).take_all()


def s_preserve_order_reorders_skewed_completions(rt, rd, tmp):
    def slow_first(b):
        import time as _time

        if int(np.asarray(b["id"])[0]) == 0:
            _time.sleep(0.4)
        return b

    ctx = rd.DataContext.get_current()
    ds = rd.range(4, parallelism=4)
    ctx.preserve_order = True
    try:
        ordered = [r["id"] for r in ds.map_batches(slow_first, batch_format="numpy").take_all()]
    finally:
        ctx.preserve_order = False
    rows = [r["id"] for r in ds.map_batches(slow_first, batch_format="numpy").take_all()]
    return [ordered, sorted(rows)]


def s_partition_by_hash_stable_across_processes(rt, rd, tmp):
    import json
    import subprocess
    import sys

    code = (
        "import json\n"
        f"from {rd.__name__}.shuffle import _stable_key_hash\n"
        "keys = ['alpha', 'beta', '\\u03b4elta', b'raw', 2, 2.0, True, 2.5, -7, None, ('t', 1)]\n"
        "print(json.dumps([_stable_key_hash(k) % 8 for k in keys]))\n"
    )

    def run(seed):
        env = dict(os.environ, PYTHONHASHSEED=str(seed), JAX_PLATFORMS="cpu")
        out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        return json.loads(out.stdout)

    a, b = run(1), run(4242)
    assert a == b and a[4] == a[5] == a[6]
    return a


def s_groupby_string_keys_one_group_per_key(rt, rd, tmp):
    ds = rd.from_items([{"k": f"key-{i % 5}", "v": 1} for i in range(200)], parallelism=8)
    rows = _rows(ds.groupby("k").sum("v"), key=lambda r: r["k"])
    assert len(rows) == 5
    return rows


DATA_SCENARIOS = [
    s_range_count_take, s_range_tensor, s_from_items_map_filter, s_map_batches_numpy,
    s_flat_map, s_fusion_in_plan, s_limit_streaming, s_sort,
    s_random_shuffle_preserves_multiset, s_repartition, s_groupby_aggregate,
    s_global_aggregates, s_unique, s_union_zip, s_add_drop_select_columns, s_iter_batches,
    s_iter_batches_local_shuffle, s_iter_jax_batches, s_split_and_streaming_split,
    s_actor_pool_map_batches, s_csv_json_roundtrip, s_numpy_roundtrip, s_map_groups,
    s_train_test_split, s_stats_after_execution, s_read_text, s_read_binary_files,
    s_read_images, s_read_webdataset, s_read_webdataset_dotted_dirs_and_multipart_exts,
    s_write_read_parquet_roundtrip, s_read_sql_sqlite, s_read_text_crlf_newlines,
    s_preserve_order_reorders_skewed_completions, s_partition_by_hash_stable_across_processes,
    s_groupby_string_keys_one_group_per_key,
]


@pytest.fixture(scope="module")
def data_outputs(tmp_path_factory):
    return run_all(DATA_SCENARIOS, tmp_path_factory.mktemp("data"))


@pytest.mark.parametrize("scenario", DATA_SCENARIOS, ids=lambda f: f.__name__[2:])
def test_data_matches_jax(scenario, data_outputs):
    check(data_outputs, scenario)


# --------------------------------------------------------------------------
# the port's own: the device on-ramp
# --------------------------------------------------------------------------
def test_iter_jax_batches_raises_and_names_its_counterpart():
    import ray_tpu_torch as rt
    from ray_tpu_torch.exceptions import NotPortedError

    rt.init(num_cpus=2)
    try:
        ds = rt.data.range(8)
        with pytest.raises(NotPortedError, match="iter_device_batches"):
            next(ds.iter_jax_batches(batch_size=4))
        with pytest.raises(NotPortedError, match="iter_device_batches"):
            next(ds.iterator().iter_jax_batches(batch_size=4))
    finally:
        rt.shutdown()


def test_iter_device_batches_without_a_device_refuses_the_cpu(monkeypatch):
    import ray_tpu_torch as rt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rt.init(num_cpus=2)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(rt.data.range(8).iter_device_batches(batch_size=4))
    finally:
        rt.shutdown()


def test_iter_device_batches_casts_and_keeps_rows_of_the_host_batches():
    """Each device batch is the host ``iter_batches`` batch, cast as named."""
    import ray_tpu_torch as rt

    rt.init(num_cpus=2)
    try:
        tokens = np.random.default_rng(0).integers(0, 32000, (30, 16), dtype=np.int32)
        ds = rt.data.from_numpy(tokens).random_shuffle(seed=3).materialize()
        host = list(ds.iter_batches(batch_size=6, drop_last=True))
        dev = list(ds.iter_device_batches(batch_size=6, dtypes={"data": torch.int64},
                                          device="cpu", drop_last=True))
        assert len(dev) == len(host) == 5
        for h, d in zip(host, dev):
            assert d["data"].dtype == torch.int64
            assert torch.equal(d["data"], torch.from_numpy(h["data"]).long())
        assert sorted(np.concatenate([h["data"] for h in host]).tolist()) == \
            sorted(tokens.tolist())
    finally:
        rt.shutdown()


def _on_ramp_rank(rows: int, batch: int):
    """One gloo rank: its dp block of every batch of a seeded table."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.parallel.mesh import Mesh, named_sharding

    table = np.arange(rows * 4, dtype=np.int32).reshape(rows, 4) * 3 - 7
    mesh = Mesh(np.arange(2), ("dp",))
    rt.init(num_cpus=1)
    try:
        ds = rt.data.from_numpy(table)
        return [b["data"].numpy().tolist() for b in ds.iter_device_batches(
            batch_size=batch, device="cpu", sharding=named_sharding(mesh, "dp"))]
    finally:
        rt.shutdown()


def test_sharded_on_ramp_matches_jax_shards_on_two_gloo_ranks():
    """Each rank keeps its rows of every batch: rank r's block equals the
    r-th addressable shard of ``iter_jax_batches(sharding=NamedSharding(mesh,
    P("dp")))`` on two virtual devices, and the host batch's rows."""
    import jax
    from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec

    import ray_tpu as jrt
    from ray_tpu_torch.parallel.launch import run_ranks

    rows, batch = 24, 8
    table = np.arange(rows * 4, dtype=np.int32).reshape(rows, 4) * 3 - 7
    mesh = JMesh(np.array(jax.devices()[:2]), ("dp",))
    jrt.init(num_cpus=2)
    try:
        jax_blocks = [[], []]
        for b in jrt.data.from_numpy(table).iter_jax_batches(
                batch_size=batch, sharding=NamedSharding(mesh, PartitionSpec("dp"))):
            shards = sorted(b["data"].addressable_shards, key=lambda s: s.index[0].start or 0)
            for r, s in enumerate(shards):
                jax_blocks[r].append(np.asarray(s.data).tolist())
    finally:
        jrt.shutdown()
    per_rank = run_ranks(_on_ramp_rank, 2, rows, batch, device="cpu", timeout_s=180)
    assert per_rank == jax_blocks
    for r in range(2):
        want = [table[i * batch + r * batch // 2: i * batch + (r + 1) * batch // 2].tolist()
                for i in range(rows // batch)]
        assert per_rank[r] == want


# --------------------------------------------------------------------------
# F9: a map stage that asks for a GPU
# --------------------------------------------------------------------------
def _where_map_runs(rt, rd):
    """Where each kind of map stage given ``num_gpus=0.5`` runs (the JAX
    package's ``map_batches`` takes the keyword in ``**kw`` and drops it):
    whether in the driver, and whether the card is hidden there."""
    def facts(batch):
        import os as _os

        return {"pid": np.full(len(batch["id"]), _os.getpid()),
                "hidden": np.full(len(batch["id"]), _os.environ.get("CUDA_VISIBLE_DEVICES") == "")}

    class Facts:
        def __call__(self, batch):
            return facts(batch)

    out = {}
    for kind, fn, extra in (("task", facts, {}), ("actor", Facts, {"concurrency": 2})):
        rows = rd.range(8, parallelism=4).map_batches(fn, num_gpus=0.5, **extra).take_all()
        pids = {int(r["pid"]) for r in rows}
        out[kind] = {"in_driver": pids == {os.getpid()}, "card_hidden": all(
            bool(r["hidden"]) for r in rows)}
    return out


def test_gpu_map_stages_run_next_to_the_card_in_the_port_only():
    """F9. The port: a task-pool map with ``num_gpus`` runs as a thread of
    the driver, and an actor-pool ``_MapWorker`` with it is an in-process
    GPU actor; neither hides the card. The JAX package: the stage runs in a
    process worker (its actor pool makes default actors, its task pool tiers
    unknown functions into workers, whose chip is hidden by
    ``JAX_PLATFORMS=cpu``)."""
    outs = {}
    for name in PACKAGES:
        rt = importlib.import_module(name)
        rt.init(num_cpus=4, num_gpus=1)
        try:
            outs[name] = _where_map_runs(rt, importlib.import_module(name + ".data"))
        finally:
            rt.shutdown()
    assert outs["ray_tpu_torch"] == {"task": {"in_driver": True, "card_hidden": False},
                                     "actor": {"in_driver": True, "card_hidden": False}}
    assert outs["ray_tpu"]["task"]["in_driver"] is False
    assert outs["ray_tpu"]["actor"]["in_driver"] is False


def test_num_gpus_reaches_the_resources_and_fuses_as_max():
    import ray_tpu_torch as rt
    from ray_tpu_torch.data import logical as L
    from ray_tpu_torch.data.executor import plan

    rt.init(num_cpus=4, num_gpus=1)
    try:
        rd = rt.data
        ds = rd.range(4).map_batches(lambda b: b, num_gpus=0.25).map_batches(lambda b: b,
                                                                             num_gpus=0.5)
        fused = L.optimize(ds._logical_op)
        assert isinstance(fused, L.FusedMap) and fused.num_gpus == 0.5
        op = plan(fused, rd.DataContext.get_current())
        assert op._map_task._resources == {"CPU": 1, "GPU": 0.5}
        assert op._map_task._execution == "thread"
        cpu_only = plan(L.optimize(rd.range(4).map_batches(lambda b: b)._logical_op),
                        rd.DataContext.get_current())
        assert cpu_only._map_task._execution == "auto" and "GPU" not in cpu_only._map_task._resources
        # a stage that asks for more GPUs than the node has waits, as any task
        assert sorted(r["id"] for r in ds.take_all()) == [0, 1, 2, 3]
    finally:
        rt.shutdown()


# --------------------------------------------------------------------------
# F6: the pumps stop at shutdown
# --------------------------------------------------------------------------
def test_shutdown_stops_split_producers_and_prefetch_pumps():
    """An unread ``streaming_split`` and an abandoned ``to_torch`` prefetch
    keep their threads alive; ``shutdown`` stops and joins them while the
    runtime is up, so none starts a new one, and a reader of the split
    learns that the runtime went."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.data import iterator

    rt.init(num_cpus=2)
    try:
        ds = rt.data.range(400, parallelism=40)
        left, right = ds.streaming_split(2)
        first = next(left.iter_batches(batch_size=None))
        tds = iter(rt.data.from_items([{"a": float(i), "y": 0.0} for i in range(64)]).to_torch(
            label_column="y", batch_size=4, prefetch_batches=1))
        next(tds)
        assert len(_pumps()) == 2 and len(iterator._live_pumps) == 2
    finally:
        rt.shutdown()
    assert _pumps() == [] and iterator._live_pumps == set()
    assert not rt.is_initialized()
    assert len(first["id"]) == 10
    with pytest.raises(RuntimeError, match="shut down"):
        for _ in right.iter_batches(batch_size=None):
            pass
    time.sleep(0.3)
    assert not rt.is_initialized()


def test_importing_the_data_library_loads_no_torch():
    import subprocess
    import sys

    code = (
        "import sys, ray_tpu_torch, ray_tpu_torch.data, ray_tpu_torch.data.llm_inference, "
        "ray_tpu_torch.data.preprocessors, ray_tpu_torch.data.datasource_lakes\n"
        "assert ray_tpu_torch.data is sys.modules['ray_tpu_torch.data']\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'ray_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), check=True, timeout=120)


def test_data_exports_the_jax_names():
    import ray_tpu.data as jd
    import ray_tpu_torch as rt

    td = rt.data
    assert sorted(td.__all__) == sorted(jd.__all__)
    for name in jd.__all__:
        assert hasattr(td, name), name
    jax_mods = {n[:-3] for n in os.listdir(os.path.dirname(jd.__file__)) if n.endswith(".py")}
    port_mods = {n[:-3] for n in os.listdir(os.path.dirname(td.__file__)) if n.endswith(".py")}
    assert jax_mods == port_mods
