"""The rest of the port's data library against the JAX package's, scenario
by scenario, with the harness of ``tests/test_torch_data.py`` (one runtime
a package for each group, outputs compared with dtypes and types): the
scenarios of the JAX package's ``tests/test_data_api_tail.py``,
``test_preprocessors.py`` (``preserve_order`` on, as its fixture sets
it, and as the harness sets it for every scenario), ``test_push_shuffle.py``, ``test_datasources_ext.py`` and
``test_datasource_lakes.py``. A scenario whose optional package (PIL,
pyarrow, pandas, tensorflow, ``datasets``) is absent skips in both.
"""

import importlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_data import _no_runtime_left, _pumps, _raises, _rows, check, run_all  # noqa: E402,F401


# --------------------------------------------------------------------------
# test_data_api_tail.py
# --------------------------------------------------------------------------
def s_metadata_surface(rt, rd, tmp):
    ds = rd.range(10)
    copy = ds.copy()
    assert isinstance(ds.context(), rd.DataContext) and copy is not ds
    return [ds.names(), ds.columns(), ds.types(), copy.count()]


def s_input_files(rt, rd, tmp):
    rd.range(10).write_csv(str(tmp / "files"))
    files = rd.read_csv(str(tmp / "files")).input_files()
    assert files and all(f.endswith(".csv") for f in files)
    return [sorted(os.path.basename(f) for f in files), rd.from_items([1, 2]).input_files()]


def s_random_sample(rt, rd, tmp):
    ds = rd.range(2000)
    n = rd.Dataset.count(ds.random_sample(0.5, seed=7))
    assert 700 < n < 1300
    return [n, ds.random_sample(0.5, seed=7).count(), ds.random_sample(0.5, seed=7).take(10),
            _raises(ds.random_sample, 1.5)]


def s_randomize_block_order(rt, rd, tmp):
    return rd.range(100, parallelism=10).randomize_block_order(seed=3).take_all()


def s_split_at_indices(rt, rd, tmp):
    ds = rd.range(100, parallelism=7)
    parts = ds.split_at_indices([30, 65])
    return [[p.count() for p in parts], [p.take_all() for p in parts],
            _raises(ds.split_at_indices, [50, 20])]


def s_split_proportionately(rt, rd, tmp):
    parts = rd.range(100, parallelism=4).split_proportionately([0.7, 0.2])
    return [[p.count() for p in parts], [p.take(3) for p in parts]]


def s_refs_consumption(rt, rd, tmp):
    ds = rd.range(40, parallelism=4)
    arrays = rt.get(ds.to_numpy_refs(column="id"))
    dfs = rt.get(ds.to_pandas_refs())
    return [len(ds.get_internal_block_refs()), arrays, [len(d) for d in dfs],
            [d["id"].tolist() for d in dfs]]


def s_from_refs_roundtrip(rt, rd, tmp):
    pd = pytest.importorskip("pandas")
    ds = rd.from_numpy_refs([rt.put(np.arange(5)), rt.put(np.arange(5, 10))], column="v")
    df_refs = [rt.put(pd.DataFrame({"x": [1, 2]})), rt.put(pd.DataFrame({"x": [3]}))]
    ds2 = rd.from_pandas_refs(df_refs)
    return [ds.sum("v"), ds.take_all(), ds2.count(), ds2.sum("x")]


def s_lineage_serialization(rt, rd, tmp):
    ds = rd.range(25).map_batches(lambda b: {"id": b["id"] * 2})
    revived = rd.Dataset.deserialize_lineage(ds.serialize_lineage())
    mat = ds.materialize()
    return [ds.has_serializable_lineage(), revived.count(), revived.sum("id"),
            mat.has_serializable_lineage(), _raises(mat.serialize_lineage)]


def s_to_torch(rt, rd, tmp):
    ds = rd.from_items([{"x": float(i), "y": float(i % 2)} for i in range(16)], parallelism=1)
    return list(ds.to_torch(label_column="y", feature_columns=["x"], batch_size=4))


def s_random_access_dataset(rt, rd, tmp):
    ds = rd.from_items([{"key": i, "val": i * 10} for i in range(200)])
    rad = ds.to_random_access_dataset("key", num_workers=4)
    out = [rt.get(rad.get_async(17)), rt.get(rad.get_async(199)), rt.get(rad.get_async(-5)),
           rad.multiget([3, 150, 9999, 42]), "workers=4" in rad.stats(),
           rd.range(50, parallelism=4).count()]
    for w in rad._workers:
        rt.kill(w)
    return out


def s_write_images_roundtrip(rt, rd, tmp):
    Image = pytest.importorskip("PIL.Image")
    imgs = [np.full((8, 8, 3), i * 20, np.uint8) for i in range(4)]
    rd.from_items([{"image": im} for im in imgs]).write_images(str(tmp / "imgs"), column="image")
    files = sorted(os.listdir(tmp / "imgs"))
    return [files, [np.asarray(Image.open(tmp / "imgs" / f)) for f in files]]


def s_write_webdataset_roundtrip(rt, rd, tmp):
    rows = [{"__key__": f"sample{i:03d}", "txt": f"hello {i}", "cls": i, "npy": np.arange(3) + i}
            for i in range(6)]
    rd.from_items(rows).write_webdataset(str(tmp / "wds"))
    shards = [str(tmp / "wds" / f) for f in sorted(os.listdir(tmp / "wds"))]
    back = sorted(rd.read_webdataset(shards).take_all(), key=lambda r: r["__key__"])
    return [[os.path.basename(s) for s in shards], back]


def s_read_parquet_bulk(rt, rd, tmp):
    pytest.importorskip("pyarrow")
    p = tmp / "pq"
    rd.range(30, parallelism=3).write_parquet(str(p))
    files = sorted(str(p / f) for f in os.listdir(p) if f.endswith(".parquet"))
    ds = rd.read_parquet_bulk(files)
    return [ds.count(), _rows(ds, key=lambda r: r["id"])]


def s_read_file_groups_through_the_io_pool(rt, rd, tmp):
    """More files than read tasks: each task reads its group through the
    native pread pool (the port's ``native/io_pool.py``), in order."""
    (tmp / "txt").mkdir()
    for i in range(12):
        (tmp / "txt" / f"part-{i:02d}.txt").write_text(
            "".join(f"f{i}-l{j}\n" for j in range(i % 3 + 1)))
    rd.from_numpy(np.arange(40, dtype=np.int32).reshape(20, 2)).repartition(6).write_numpy(
        str(tmp / "np"))
    return [_rows(rd.read_text(str(tmp / "txt"), parallelism=3), key=lambda r: r["text"]),
            _rows(rd.read_numpy(str(tmp / "np"), parallelism=2), key=lambda r: int(r["data"][0]))]


def s_gated_interop_raises_actionably(rt, rd, tmp):
    ds = rd.range(4)
    return [_raises(fn) for fn in (ds.to_dask, ds.to_mars, ds.to_modin, ds.to_spark)] + [
        _raises(ds.write_mongo, "mongodb://x", "db", "coll"),
        _raises(ds.write_bigquery, "proj", "ds"), _raises(rd.from_dask, None),
        _raises(rd.read_avro, ["f.avro"])]


def s_compat_surface_actor_pool_sinks_schema(rt, rd, tmp):
    ds = rd.range(8, parallelism=4).map_batches(
        lambda b: {"id": np.asarray(b["id"]) * 2}, batch_format="numpy",
        compute=rd.ActorPoolStrategy(size=2))
    out = [_rows(ds, key=lambda r: r["id"])]

    class JsonlSink(rd.RowBasedFileDatasink):
        def __init__(self):
            super().__init__(file_extension="jsonl")

        def write_row_to_file(self, row, file):
            file.write((json.dumps({k: int(v) for k, v in row.items()}) + "\n").encode())

    rd.range(4, parallelism=2).write_datasink(JsonlSink(), path=str(tmp / "sink"))
    rows = []
    for p in sorted((tmp / "sink").glob("part-*.jsonl")):
        rows += [json.loads(line) for line in p.read_text().splitlines()]
    out.append(sorted(r["id"] for r in rows))
    schema = rd.range(3).schema()
    out.append([type(schema).__name__, schema.names, list(schema), repr(schema)])
    ctx = rd.DataContext.get_current()
    assert rd.DatasetContext is rd.DataContext
    ctx.execution_options.preserve_order = True
    try:
        out.append(ctx.preserve_order)
    finally:
        ctx.preserve_order = False
    out.append(ctx.execution_options.preserve_order)
    ctx.execution_options.resource_limits = rd.ExecutionResources(
        cpu=1, object_store_memory=64 * 1024 * 1024)
    try:
        out.append(_rows(rd.range(8, parallelism=4).map_batches(lambda b: b, batch_format="numpy"),
                         key=lambda r: r["id"]))
    finally:
        ctx.execution_options.resource_limits = rd.ExecutionResources()
    return out


def s_iterator_schema_and_stats(rt, rd, tmp):
    it = rd.from_items([{"a": float(i), "label": i % 2} for i in range(8)]).iterator()
    return [it.schema(), isinstance(it.stats(), str)]


def s_iterator_to_torch_packs_features_and_label(rt, rd, tmp):
    ds = rd.from_items([{"a": float(i), "b": float(2 * i), "label": float(i % 2)}
                        for i in range(8)], parallelism=1)
    out = list(ds.iterator().to_torch(label_column="label", batch_size=4))
    feats2, label2 = next(iter(ds.iterator().to_torch(
        feature_columns={"x": ["a"], "y": ["b", "a"]}, batch_size=8)))
    return [out, feats2, label2]


def s_to_torch_dtype_list_prefetch_and_dataset_delegation(rt, rd, tmp):
    ds = rd.from_items([{"a": float(i), "b": float(3 * i), "label": float(i)} for i in range(8)],
                       parallelism=1)
    tds = ds.iterator().to_torch(label_column="label", feature_columns=["a", "b"],
                                 feature_column_dtypes=[torch.float64, torch.float32],
                                 batch_size=4, prefetch_batches=2)
    out = [list(tds), next(iter(ds.to_torch(label_column="label", batch_size=4)))]
    out.append(_raises(lambda: next(iter(ds.iterator().to_torch(
        label_column="label", feature_columns=["a", "b"], unsqueeze_feature_tensors=False,
        batch_size=4)))))
    left, right = ds.streaming_split(2)
    out.append(left.schema())
    out.append(sum(len(b["a"]) for b in left.iter_batches(batch_size=4))
               + sum(len(b["a"]) for b in right.iter_batches(batch_size=4)))
    return out


def s_to_torch_prefetch_shuts_down_on_early_stop(rt, rd, tmp):
    import gc
    import time

    ds = rd.from_items([{"a": float(i), "label": 0.0} for i in range(64)], parallelism=1)
    firsts = []
    for _ in range(5):
        it = iter(ds.to_torch(label_column="label", batch_size=4, prefetch_batches=1))
        firsts.append(next(it))
        del it
    gc.collect()
    deadline = time.time() + 5
    while _pumps(("to-torch-prefetch",)) and time.time() < deadline:
        time.sleep(0.1)
    return [firsts, len(_pumps(("to-torch-prefetch",)))]


def s_to_torch_grouped_feature_columns(rt, rd, tmp):
    ds = rd.from_items([{"a": float(i), "b": float(2 * i), "c": float(3 * i), "label": 1.0}
                        for i in range(4)], parallelism=1)
    return [next(iter(ds.to_torch(label_column="label", feature_columns=[["a", "b"], ["c"]],
                                  batch_size=4))),
            next(iter(ds.to_torch(label_column="label", feature_columns=[["a", "b"], ["c"]],
                                  feature_column_dtypes=[torch.float64, torch.float32],
                                  batch_size=4))),
            _raises(ds.to_torch, feature_columns=[["a"], ["b"]],
                    feature_column_dtypes=[torch.float32], batch_size=4),
            _raises(ds.to_torch, feature_columns=["a", ["b"]], batch_size=4)]


def s_to_torch_warns_on_dropped_non_numeric_columns(rt, rd, tmp):
    ds = rd.from_items([{"name": f"r{i}", "a": float(i), "label": 0.0} for i in range(4)],
                       parallelism=1)
    with pytest.warns(UserWarning, match="name") as rec:
        feats, _ = next(iter(ds.to_torch(label_column="label", batch_size=4)))
    return [feats, [str(w.message) for w in rec]]


def s_to_torch_skips_object_columns_and_rejects_bad_dtype_spec(rt, rd, tmp):
    import warnings

    ds = rd.from_items([{"name": f"row{i}", "a": float(i), "label": 0.0} for i in range(4)],
                       parallelism=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        feats, _ = next(iter(ds.to_torch(label_column="label", batch_size=4)))
    return [feats,
            _raises(lambda: next(iter(ds.to_torch(feature_columns={"x": ["a"]},
                                                  feature_column_dtypes=[torch.float32],
                                                  batch_size=4)))),
            _raises(lambda: next(iter(ds.to_torch(
                feature_columns=["a"], feature_column_dtypes=[torch.float32, torch.float64],
                batch_size=4))))]


API_TAIL = [
    s_metadata_surface, s_input_files, s_random_sample, s_randomize_block_order,
    s_split_at_indices, s_split_proportionately, s_refs_consumption, s_from_refs_roundtrip,
    s_lineage_serialization, s_to_torch, s_random_access_dataset, s_write_images_roundtrip,
    s_write_webdataset_roundtrip, s_read_parquet_bulk, s_read_file_groups_through_the_io_pool,
    s_gated_interop_raises_actionably,
    s_compat_surface_actor_pool_sinks_schema, s_iterator_schema_and_stats,
    s_iterator_to_torch_packs_features_and_label,
    s_to_torch_dtype_list_prefetch_and_dataset_delegation,
    s_to_torch_prefetch_shuts_down_on_early_stop, s_to_torch_grouped_feature_columns,
    s_to_torch_warns_on_dropped_non_numeric_columns,
    s_to_torch_skips_object_columns_and_rejects_bad_dtype_spec,
]


# --------------------------------------------------------------------------
# test_preprocessors.py
# --------------------------------------------------------------------------
def _pp(rd):
    return importlib.import_module(rd.__name__ + ".preprocessors")


def s_standard_scaler_fit_and_batch_parity(rt, rd, tmp):
    ds = rd.from_items([{"x": float(i), "y": float(2 * i)} for i in range(10)])
    scaler = _pp(rd).StandardScaler(["x"])
    out = scaler.fit_transform(ds).take_all()
    b = scaler.transform_batch({"x": np.array([4.5]), "y": np.array([0.0])})
    return [out, b, scaler.stats_]


def s_unfitted_raises(rt, rd, tmp):
    return _raises(_pp(rd).StandardScaler(["x"]).transform_batch, {"x": np.array([1.0])})


def s_minmax_and_discretizer(rt, rd, tmp):
    pp = _pp(rd)
    ds = rd.from_items([{"x": float(i)} for i in range(11)])
    mm = pp.MinMaxScaler(["x"]).fit(ds)
    kb = pp.KBinsDiscretizer(["x"], bins=5, strategy="uniform").fit(ds)
    kq = pp.KBinsDiscretizer(["x"], bins=2, strategy="quantile").fit(ds)
    return [mm.transform(ds).take_all(), kb.transform(ds).take_all(), kq.transform(ds).take_all(),
            mm.stats_, kb.stats_, kq.stats_]


def s_encoders(rt, rd, tmp):
    pp = _pp(rd)
    ds = rd.from_items([{"c": v} for v in ["b", "a", "c", "a"]])
    enc = pp.OrdinalEncoder(["c"]).fit(ds)
    oh = pp.OneHotEncoder(["c"]).fit(ds)
    return [enc.transform(ds).take_all(), enc.transform_batch({"c": np.array(["zz"])}),
            oh.transform(ds).take_all(), oh.transform_batch({"c": np.array(["zz"])}),
            pp.LabelEncoder("c").fit_transform(ds).take_all()]


def s_imputer_strategies(rt, rd, tmp):
    pp = _pp(rd)
    ds = rd.from_items([{"x": 1.0}, {"x": float("nan")}, {"x": 3.0}])
    dsm = rd.from_items([{"c": "a"}, {"c": "b"}, {"c": "a"}, {"c": None}])
    return [pp.SimpleImputer(["x"], strategy="mean").fit(ds).transform(ds).take_all(),
            pp.SimpleImputer(["x"], strategy="constant", fill_value=9.0).transform_batch(
                {"x": np.array([np.nan])}),
            pp.SimpleImputer(["c"], strategy="most_frequent").fit(dsm).transform(dsm).take_all(),
            _raises(pp.SimpleImputer(["c"], strategy="most_frequent").fit,
                    rd.from_items([{"c": None}, {"c": None}]))]


def s_normalizer_concatenator_chain(rt, rd, tmp):
    pp = _pp(rd)
    ds = rd.from_items([{"a": 3.0, "b": 4.0, "keep": 7}])
    ds2 = rd.from_items([{"a": float(i), "b": float(i)} for i in range(4)])
    chain = pp.Chain(pp.MinMaxScaler(["a", "b"]), pp.Concatenator(["a", "b"], "vec"))
    return [pp.Normalizer(["a", "b"], norm="l2").transform(ds).take_all(),
            pp.Concatenator(["a", "b"], output_column_name="vec").transform(ds).take_all(),
            chain.fit_transform(ds2).take_all(),
            chain.transform_batch({"a": np.array([0.0]), "b": np.array([3.0])})]


def s_batch_mapper(rt, rd, tmp):
    bm = _pp(rd).BatchMapper(lambda b: {"x": np.asarray(b["x"]) * 10})
    return bm.transform(rd.from_items([{"x": 2}])).take_all()


def s_text_pipeline(rt, rd, tmp):
    pp = _pp(rd)
    ds = rd.from_items([{"t": "the cat sat"}, {"t": "the dog sat down"}])
    cv = pp.CountVectorizer(["t"]).fit(ds)
    fh = pp.FeatureHasher(["t"], num_features=32)
    return [cv.transform(ds).take_all(), cv.stats_,
            pp.CountVectorizer(["t"], max_features=2).fit(ds).stats_,
            fh.transform_batch({"t": np.array(["cat cat dog"])})]


def s_tokenizer_cells_stay_lists_even_when_uniform(rt, rd, tmp):
    tk = _pp(rd).Tokenizer(["t"])
    b = tk.transform_batch({"t": np.array(["a b", "c d"])})
    assert b["t"].ndim == 1 and b["t"].dtype == object
    return [b, tk.transform(rd.from_items([{"t": "a b"}, {"t": "c d"}])).take_all()]


PREPROCESSORS = [
    s_standard_scaler_fit_and_batch_parity, s_unfitted_raises, s_minmax_and_discretizer,
    s_encoders, s_imputer_strategies, s_normalizer_concatenator_chain, s_batch_mapper,
    s_text_pipeline, s_tokenizer_cells_stay_lists_even_when_uniform,
]


# --------------------------------------------------------------------------
# test_push_shuffle.py
# --------------------------------------------------------------------------
def _blocks(n_blocks, rows_per_block, seed=0):
    rng = np.random.default_rng(seed)
    return [{"k": rng.integers(0, 1000, rows_per_block), "v": rng.random(rows_per_block)}
            for _ in range(n_blocks)]


def _shuffle(rd):
    return importlib.import_module(rd.__name__ + ".shuffle")


def _keys(rt, out_refs):
    out = rt.get(out_refs)
    return np.concatenate([b["k"] for b in out if len(b.get("k", ()))])


def s_push_shuffle_schedule_structure(rt, rd, tmp):
    sh = _shuffle(rd)
    rd.DataContext.get_current().use_push_based_shuffle = True
    blocks = _blocks(12, 100)
    out_refs, metas = sh.run_exchange([rt.put(b) for b in blocks], kind="sort", n_parts=6, key="k")
    sched = sh.last_push_schedule
    got = _keys(rt, out_refs)
    np.testing.assert_array_equal(got, np.sort(np.concatenate([b["k"] for b in blocks])))
    return [vars(sched), got, [m.num_rows for m in metas]]


def s_push_vs_pull_same_result(rt, rd, tmp):
    sh = _shuffle(rd)
    ctx = rd.DataContext.get_current()
    results = {}
    for mode in (True, False):
        ctx.use_push_based_shuffle = mode
        out_refs, _ = sh.run_exchange([rt.put(b) for b in _blocks(8, 64, seed=3)], kind="sort",
                                      n_parts=4, key="k")
        results[mode] = _keys(rt, out_refs)
    ctx.use_push_based_shuffle = True
    np.testing.assert_array_equal(results[True], results[False])
    return results[True]


def s_dataset_sort_and_groupby_ride_push_shuffle(rt, rd, tmp):
    sh = _shuffle(rd)
    rd.DataContext.get_current().use_push_based_shuffle = True
    sh.last_push_schedule = None
    ds = rd.from_items([{"k": int(i % 5), "v": float(i)} for i in range(1000)]).repartition(8)
    sorted_rows = ds.sort("k").take_all()
    pushed = sh.last_push_schedule is not None
    return [[r["k"] for r in sorted_rows], pushed,
            _rows(ds.groupby("k").sum("v"), key=lambda r: r["k"])]


def s_push_shuffle_bench_smoke(rt, rd, tmp):
    sh = _shuffle(rd)
    rng = np.random.default_rng(0)
    blocks = [{"k": rng.integers(0, 1 << 30, 1 << 17), "v": rng.random(1 << 17)} for _ in range(16)]
    ctx = rd.DataContext.get_current()
    digests = {}
    for mode in (True, False):
        ctx.use_push_based_shuffle = mode
        out_refs, _ = sh.run_exchange([rt.put(b) for b in blocks], kind="sort", n_parts=8, key="k")
        keys = _keys(rt, out_refs)
        digests[mode] = [len(keys), int(keys[0]), int(keys[-1]), int(keys.sum() % (1 << 61))]
    ctx.use_push_based_shuffle = True
    return digests


PUSH_SHUFFLE = [s_push_shuffle_schedule_structure, s_push_vs_pull_same_result,
                s_dataset_sort_and_groupby_ride_push_shuffle, s_push_shuffle_bench_smoke]


# --------------------------------------------------------------------------
# test_datasources_ext.py
# --------------------------------------------------------------------------
def s_tfrecords_raw_bytes(rt, rd, tmp):
    pytest.importorskip("tensorflow")
    rd.from_items([{"x": i} for i in range(5)]).write_tfrecords(str(tmp / "tfr"))
    raw = rd.read_tfrecords(str(tmp / "tfr"), decode_examples=False).take_all()
    assert all(isinstance(r["bytes"], bytes) for r in raw)
    return sorted(r["bytes"] for r in raw)


def s_from_torch(rt, rd, tmp):
    class DS(torch.utils.data.Dataset):
        def __len__(self):
            return 10

        def __getitem__(self, i):
            return torch.tensor([i, i + 1]), i % 2

    rows = rd.from_torch(DS()).take_all()
    return sorted((list(r["item"]), int(r["label"])) for r in rows)


def s_from_tf(rt, rd, tmp):
    tf = pytest.importorskip("tensorflow")
    tfds = tf.data.Dataset.from_tensor_slices({"a": np.arange(6), "b": np.arange(6) * 2.0})
    return sorted((int(r["a"]), float(r["b"])) for r in rd.from_tf(tfds).take_all())


def s_from_huggingface(rt, rd, tmp):
    hf = pytest.importorskip("datasets")
    rows = rd.from_huggingface(hf.Dataset.from_dict({"text": ["a", "b", "c"], "n": [1, 2, 3]}))
    return rows.take_all()


def s_mongo_bigquery_gated(rt, rd, tmp):
    out = []
    try:
        import pymongo  # noqa: F401

        rd.read_mongo("mongodb://localhost:1/x", "db", "coll")
        out.append("mongo lazy")
    except ImportError as exc:
        out.append(str(exc))
    try:
        from google.cloud import bigquery  # noqa: F401

        rd.read_bigquery("proj", dataset="d.t")
        out.append("bigquery lazy")
    except ImportError as exc:
        out.append(str(exc))
    return out


def s_iter_tf_batches_and_to_tf(rt, rd, tmp):
    tf = pytest.importorskip("tensorflow")
    ds = rd.from_items([{"x": float(i), "y": i % 2} for i in range(64)])
    batches = [{k: v.numpy() for k, v in b.items()} for b in ds.iter_tf_batches(batch_size=16)]
    feats, labels = next(iter(ds.to_tf("x", "y", batch_size=32)))
    return [batches, feats.numpy(), labels.numpy(), labels.dtype in (tf.int64, tf.int32)]


def s_datasource_tail_gated(rt, rd, tmp):
    out = []
    for ds in (rd.read_hudi("/tmp/nonexistent_hudi"),
               rd.read_delta_sharing_tables("/tmp/profile.json#share.schema.table"),
               rd.read_clickhouse("t", "clickhouse://localhost:1/db")):
        out.append(_raises(ds.take_all))
    assert not os.environ.get("DATABRICKS_HOST")
    out.append(_raises(rd.read_databricks_tables, warehouse_id="w", table="t"))
    out.append(_raises(rd.read_databricks_tables, warehouse_id="w"))
    return out


def s_dataset_stats_per_op_format(rt, rd, tmp):
    ds = rd.range(200, parallelism=4).map_batches(lambda b: {"x": b["id"] * 2})
    ds.materialize()
    report = ds.stats()
    return [w in report for w in ("Operator", "tasks executed", "Remote wall time", "min,",
                                  "total", "Output num rows per block")] + [
        [line.split(":")[0] for line in report.splitlines()]]


DATASOURCES_EXT = [s_tfrecords_raw_bytes, s_from_torch, s_from_tf, s_from_huggingface,
                   s_mongo_bigquery_gated, s_iter_tf_batches_and_to_tf, s_datasource_tail_gated,
                   s_dataset_stats_per_op_format]


# --------------------------------------------------------------------------
# test_datasource_lakes.py
# --------------------------------------------------------------------------
def _make_ds(rd, n=100):
    return rd.range(n).map(lambda row: {"id": row["id"], "bucket": int(row["id"] % 4)})


def _delta_log(path):
    log = os.path.join(path, "_delta_log")
    out = []
    for commit in sorted(os.listdir(log)):
        if commit.endswith(".json"):
            with open(os.path.join(log, commit)) as f:
                out.append((commit, sorted(next(iter(json.loads(line))) for line in f)))
    return out


def s_delta_write_read_roundtrip(rt, rd, tmp):
    pytest.importorskip("pyarrow")
    path = str(tmp / "delta_table")
    _make_ds(rd, 50).write_delta(path)
    return [_delta_log(path), _rows(rd.read_delta(path), key=lambda r: r["id"])]


def s_delta_append_and_overwrite(rt, rd, tmp):
    pytest.importorskip("pyarrow")
    path = str(tmp / "delta_table")
    _make_ds(rd, 10).write_delta(path)
    _make_ds(rd, 10).write_delta(path, mode="append")
    n = len(rd.read_delta(path).take_all())
    _make_ds(rd, 5).write_delta(path, mode="overwrite")
    return [n, _rows(rd.read_delta(path), key=lambda r: r["id"]), _delta_log(path)]


def s_delta_column_projection(rt, rd, tmp):
    pytest.importorskip("pyarrow")
    path = str(tmp / "delta_table")
    _make_ds(rd, 20).write_delta(path)
    return _rows(rd.read_delta(path, columns=["bucket"]), key=lambda r: r["bucket"])


def s_delta_rejects_non_table(rt, rd, tmp):
    return _raises(lambda: rd.read_delta(str(tmp / "nope")).take_all())["type"]


def s_lance_gated_or_roundtrip(rt, rd, tmp):
    try:
        import lance  # noqa: F401
    except ImportError:
        return [_raises(lambda: rd.read_lance(str(tmp / "t.lance")).take_all()),
                _raises(lambda: _make_ds(rd, 5).write_lance(str(tmp / "t.lance")))]
    _make_ds(rd, 30).write_lance(str(tmp / "t.lance"))
    return _rows(rd.read_lance(str(tmp / "t.lance")), key=lambda r: r["id"])


def s_iceberg_gated(rt, rd, tmp):
    try:
        import pyiceberg  # noqa: F401
    except ImportError:
        return _raises(lambda: rd.read_iceberg("db.table").take_all())
    pytest.skip("pyiceberg installed; gating path not applicable")


def s_hive_partitioned_parquet_roundtrip(rt, rd, tmp):
    pytest.importorskip("pyarrow")
    path = str(tmp / "hive")
    _make_ds(rd, 40).write_parquet(path, partition_cols=["bucket"])
    return [sorted(d for d in os.listdir(path) if d.startswith("bucket=")),
            _rows(rd.read_parquet(path), key=lambda r: r["id"])]


def s_hash_partitioned_parquet_write(rt, rd, tmp):
    pytest.importorskip("pyarrow")
    path = str(tmp / "hashed")
    _make_ds(rd, 64).write_parquet(path, partition_by={"column": "id", "mode": "hash",
                                                       "num_partitions": 4})
    with open(os.path.join(path, "_partition_spec.json")) as f:
        spec = json.load(f)
    return [spec, sorted(d for d in os.listdir(path) if d.startswith("hash=")),
            _rows(rd.read_parquet(path), key=lambda r: r["id"])]


def s_range_partitioned_parquet_write_is_ordered(rt, rd, tmp):
    pq = pytest.importorskip("pyarrow.parquet")
    path = str(tmp / "ranged")
    _make_ds(rd, 100).write_parquet(path, partition_by={"column": "id", "mode": "range",
                                                        "num_partitions": 4})
    with open(os.path.join(path, "_partition_spec.json")) as f:
        spec = json.load(f)
    parts = sorted(d for d in os.listdir(path) if d.startswith("range="))
    ranges = []
    for part in parts:
        vals = []
        for f in sorted(os.listdir(os.path.join(path, part))):
            vals += pq.read_table(os.path.join(path, part, f))["id"].to_pylist()
        ranges.append((min(vals), max(vals)))
    return [spec, parts, ranges, _rows(rd.read_parquet(path), key=lambda r: r["id"])]


LAKES = [s_delta_write_read_roundtrip, s_delta_append_and_overwrite, s_delta_column_projection,
         s_delta_rejects_non_table, s_lance_gated_or_roundtrip, s_iceberg_gated,
         s_hive_partitioned_parquet_roundtrip, s_hash_partitioned_parquet_write,
         s_range_partitioned_parquet_write_is_ordered]


GROUPS = {"api_tail": API_TAIL, "preprocessors": PREPROCESSORS, "push_shuffle": PUSH_SHUFFLE,
          "datasources_ext": DATASOURCES_EXT, "lakes": LAKES}


@pytest.fixture(scope="module")
def tail_outputs(tmp_path_factory):
    scenarios = [s for group in GROUPS.values() for s in group]
    return run_all(scenarios, tmp_path_factory.mktemp("data_tail"))


@pytest.mark.parametrize("scenario", [pytest.param(s, id=f"{g}-{s.__name__[2:]}")
                                      for g, group in GROUPS.items() for s in group])
def test_data_tail_matches_jax(scenario, tail_outputs):
    check(tail_outputs, scenario)


@pytest.mark.full
def test_tfrecords_roundtrip_matches_jax(tmp_path):
    """``test_datasources_ext.py::test_tfrecords_roundtrip`` (the JAX test's
    slow tier: its process workers import TensorFlow)."""

    def s_tfrecords_roundtrip(rt, rd, tmp):
        pytest.importorskip("tensorflow")
        rd.from_items([{"x": int(i), "y": float(i) / 2, "name": f"row{i}"}
                       for i in range(50)]).write_tfrecords(str(tmp / "tfr"))
        return sorted(rd.read_tfrecords(str(tmp / "tfr")).take_all(), key=lambda r: r["x"])

    check(run_all([s_tfrecords_roundtrip], tmp_path), s_tfrecords_roundtrip)
