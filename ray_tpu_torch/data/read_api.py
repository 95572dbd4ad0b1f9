"""Dataset constructors (parity: python/ray/data/read_api.py).

The port's copy of ``ray_tpu/data/read_api.py``: the same behaviour, imports
renamed to ``ray_tpu_torch``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np

from ray_tpu_torch.data import logical as L
from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.dataset import Dataset
from ray_tpu_torch.data.datasource import (
    BinaryDatasource,
    BlocksDatasource,
    CSVDatasource,
    Datasource,
    ImageDatasource,
    ItemsDatasource,
    JSONDatasource,
    NumpyDatasource,
    ParquetDatasource,
    RangeDatasource,
    SQLDatasource,
    TextDatasource,
    WebDatasetDatasource,
)


def _parallelism(override: int = -1) -> int:
    return override if override > 0 else DataContext.get_current().read_parallelism


def range(n: int, *, parallelism: int = -1) -> Dataset:  # noqa: A001
    return Dataset(L.Read(RangeDatasource(n), _parallelism(parallelism)))


def range_tensor(n: int, *, shape: tuple = (1,), parallelism: int = -1) -> Dataset:
    return Dataset(L.Read(RangeDatasource(n, tensor_shape=tuple(shape)), _parallelism(parallelism)))


def from_items(items: List[Any], *, parallelism: int = -1) -> Dataset:
    return Dataset(L.Read(ItemsDatasource(list(items)), _parallelism(parallelism)))


def from_numpy(arrays: Union[np.ndarray, List[np.ndarray]], *, column: str = "data") -> Dataset:
    if isinstance(arrays, np.ndarray):
        arrays = [arrays]
    blocks: List[Block] = [{column: a} for a in arrays]
    return Dataset(L.Read(BlocksDatasource(blocks), len(blocks)))


def from_blocks(blocks: List[Any]) -> Dataset:
    return Dataset(L.Read(BlocksDatasource([BlockAccessor.for_block(b).to_block() for b in blocks]), len(blocks)))


def from_pandas(dfs) -> Dataset:
    if not isinstance(dfs, list):
        dfs = [dfs]
    return from_blocks(dfs)


def from_arrow(tables) -> Dataset:
    if not isinstance(tables, list):
        tables = [tables]
    return from_blocks(tables)


def _from_refs(refs: List[Any]) -> Dataset:
    """Build a MaterializedDataset from already-stored block-convertible
    refs: each is normalized to a Block by a remote task.  num_returns=2
    keeps the normalized blocks in the store — the driver fetches only the
    metadata (the *_refs APIs exist precisely so payloads never transit
    the driver)."""
    import ray_tpu_torch

    from ray_tpu_torch.data.dataset import MaterializedDataset

    @ray_tpu_torch.remote
    def normalize(obj):
        block = BlockAccessor.for_block(obj).to_block()
        return block, BlockAccessor(block).get_metadata()

    task = normalize.options(num_returns=2)
    block_refs, meta_refs = [], []
    for r in refs:
        b, m = task.remote(r)
        block_refs.append(b)
        meta_refs.append(m)
    return MaterializedDataset(block_refs, ray_tpu_torch.get(meta_refs))


def from_numpy_refs(refs, *, column: str = "data") -> Dataset:
    """Refs to ndarrays (or dicts of ndarrays) -> Dataset
    (parity: from_numpy_refs)."""
    if not isinstance(refs, list):
        refs = [refs]

    import ray_tpu_torch

    from ray_tpu_torch.data.dataset import MaterializedDataset

    @ray_tpu_torch.remote
    def normalize(obj):
        block = {column: obj} if isinstance(obj, np.ndarray) else BlockAccessor.for_block(obj).to_block()
        return block, BlockAccessor(block).get_metadata()

    task = normalize.options(num_returns=2)
    block_refs, meta_refs = [], []
    for r in refs:
        b, m = task.remote(r)
        block_refs.append(b)
        meta_refs.append(m)
    return MaterializedDataset(block_refs, ray_tpu_torch.get(meta_refs))


def from_pandas_refs(refs) -> Dataset:
    """Refs to pandas DataFrames -> Dataset (parity: from_pandas_refs)."""
    return _from_refs(refs if isinstance(refs, list) else [refs])


def from_arrow_refs(refs) -> Dataset:
    """Refs to pyarrow Tables -> Dataset (parity: from_arrow_refs)."""
    return _from_refs(refs if isinstance(refs, list) else [refs])


def from_dask(df) -> Dataset:
    raise ImportError(
        "from_dask requires the dask package, which is not installed in "
        "this environment; from_pandas(df.compute()) is the native path"
    )


def from_mars(df) -> Dataset:
    raise ImportError("from_mars requires the mars package, which is not installed")


def from_modin(df) -> Dataset:
    raise ImportError(
        "from_modin requires the modin package, which is not installed; "
        "from_pandas(df._to_pandas()) is the native path"
    )


def from_spark(df, *, parallelism: int = -1) -> Dataset:
    raise ImportError(
        "from_spark requires pyspark, which is not installed; "
        "df.write.parquet + read_parquet is the native path"
    )


def read_avro(paths, *, parallelism: int = -1, **kw) -> Dataset:
    raise ImportError(
        "read_avro requires the fastavro package, which is not installed "
        "in this environment; convert with fastavro to parquet/jsonl and "
        "use read_parquet/read_json"
    )


def read_csv(paths, *, parallelism: int = -1, **kw) -> Dataset:
    return Dataset(L.Read(CSVDatasource(paths, **kw), _parallelism(parallelism)))


def read_json(paths, *, parallelism: int = -1, **kw) -> Dataset:
    return Dataset(L.Read(JSONDatasource(paths, **kw), _parallelism(parallelism)))


def read_numpy(paths, *, parallelism: int = -1, **kw) -> Dataset:
    return Dataset(L.Read(NumpyDatasource(paths, **kw), _parallelism(parallelism)))


def read_parquet(paths, *, parallelism: int = -1, **kw) -> Dataset:
    return Dataset(L.Read(ParquetDatasource(paths, **kw), _parallelism(parallelism)))


def read_parquet_bulk(paths, *, parallelism: int = -1, **kw) -> Dataset:
    """Many small parquet files, one task per file, no directory expansion
    or footer prefetch on the driver (parity: read_parquet_bulk)."""
    if isinstance(paths, str):
        paths = [paths]
    return Dataset(
        L.Read(ParquetDatasource(list(paths), **kw), max(len(paths), _parallelism(parallelism)))
    )


def read_datasource(datasource: Datasource, *, parallelism: int = -1) -> Dataset:
    return Dataset(L.Read(datasource, _parallelism(parallelism)))


def read_text(paths, *, parallelism: int = -1, **kw) -> Dataset:
    return read_datasource(TextDatasource(paths, **kw), parallelism=parallelism)


def read_binary_files(paths, *, include_paths: bool = False, parallelism: int = -1, **kw) -> Dataset:
    return read_datasource(
        BinaryDatasource(paths, include_paths=include_paths, **kw), parallelism=parallelism
    )


def read_images(paths, *, size=None, mode=None, include_paths: bool = False, parallelism: int = -1, **kw) -> Dataset:
    return read_datasource(
        ImageDatasource(paths, size=size, mode=mode, include_paths=include_paths, **kw),
        parallelism=parallelism,
    )


def read_webdataset(paths, *, parallelism: int = -1, **kw) -> Dataset:
    return read_datasource(WebDatasetDatasource(paths, **kw), parallelism=parallelism)


def read_sql(sql: str, connection_factory, *, shard_queries=None, parallelism: int = -1) -> Dataset:
    """Rows of a DB-API query as a Dataset (parity: read_api.read_sql).

    ``connection_factory`` is a zero-arg callable returning a DB-API
    connection (e.g. ``lambda: sqlite3.connect(path)``). Pass
    ``shard_queries`` (a list of non-overlapping queries) to read in
    parallel; a single query reads serially.
    """
    return read_datasource(
        SQLDatasource(sql, connection_factory, shard_queries=shard_queries),
        parallelism=parallelism,
    )


def read_tfrecords(paths, *, decode_examples: bool = True, parallelism: int = -1, **kw) -> Dataset:
    """TFRecord files (parity: read_api read_tfrecords); payloads decode as
    tf.train.Example feature dicts (requires tensorflow) or raw bytes."""
    from ray_tpu_torch.data.datasource import TFRecordDatasource

    return Dataset(
        L.Read(TFRecordDatasource(paths, decode_examples=decode_examples, **kw), _parallelism(parallelism))
    )


def read_delta(table_path: str, *, columns=None, parallelism: int = -1) -> Dataset:
    """Delta Lake table via native _delta_log replay (parity:
    delta-sharing/deltalake readers; no deltalake dependency needed)."""
    from ray_tpu_torch.data.datasource_lakes import DeltaDatasource

    return read_datasource(DeltaDatasource(table_path, columns=columns), parallelism=parallelism)


def read_lance(uri: str, *, columns=None, filter=None, parallelism: int = -1) -> Dataset:
    """Lance dataset, fragment-parallel (parity: lance_datasource.py;
    requires the lance package)."""
    from ray_tpu_torch.data.datasource_lakes import LanceDatasource

    return read_datasource(
        LanceDatasource(uri, columns=columns, filter=filter), parallelism=parallelism
    )


def read_iceberg(table_identifier: str, *, catalog_kwargs=None, row_filter=None,
                 selected_fields=None, parallelism: int = -1) -> Dataset:
    """Iceberg table via pyiceberg scan planning (parity:
    iceberg_datasource.py; requires pyiceberg)."""
    from ray_tpu_torch.data.datasource_lakes import IcebergDatasource

    return read_datasource(
        IcebergDatasource(
            table_identifier, catalog_kwargs=catalog_kwargs,
            row_filter=row_filter, selected_fields=selected_fields,
        ),
        parallelism=parallelism,
    )


def read_hudi(table_uri: str, *, options=None, parallelism: int = -1) -> Dataset:
    """Apache Hudi table, file-slice-parallel (parity: read_hudi /
    hudi_datasource.py; requires the hudi package)."""
    from ray_tpu_torch.data.datasource_lakes import HudiDatasource

    return read_datasource(HudiDatasource(table_uri, options=options), parallelism=parallelism)


def read_delta_sharing_tables(url: str, *, limit=None, version=None,
                              json_predicate_hints=None, parallelism: int = -1) -> Dataset:
    """Shared Delta table through a Delta Sharing server, file-parallel
    (parity: read_delta_sharing_tables; requires delta-sharing).  ``url``
    is ``<profile-file>#<share>.<schema>.<table>``."""
    from ray_tpu_torch.data.datasource_lakes import DeltaSharingDatasource

    return read_datasource(
        DeltaSharingDatasource(
            url, limit=limit, version=version, json_predicate_hints=json_predicate_hints
        ),
        parallelism=parallelism,
    )


def read_clickhouse(table: str, dsn: str, *, columns=None, filter=None,
                    order_by=None, client_kwargs=None, parallelism: int = -1) -> Dataset:
    """ClickHouse table/query as arrow blocks (parity: read_clickhouse;
    requires clickhouse-connect).  ``order_by`` enables sharded parallel
    reads."""
    from ray_tpu_torch.data.datasource_lakes import ClickHouseDatasource

    return read_datasource(
        ClickHouseDatasource(
            table, dsn, columns=columns, filter=filter,
            order_by=order_by, client_kwargs=client_kwargs,
        ),
        parallelism=parallelism,
    )


def read_databricks_tables(*, warehouse_id: str, table: Optional[str] = None,
                           query: Optional[str] = None, catalog=None, schema=None,
                           host=None, token=None, parallelism: int = -1) -> Dataset:
    """Databricks UC table via the SQL Statement Execution API (parity:
    read_databricks_tables; needs DATABRICKS_HOST/TOKEN)."""
    from ray_tpu_torch.data.datasource_lakes import DatabricksUCDatasource

    if (table is None) == (query is None):
        raise ValueError("pass exactly one of table= or query=")
    return read_datasource(
        DatabricksUCDatasource(
            warehouse_id=warehouse_id,
            query=query or f"SELECT * FROM {table}",
            catalog=catalog, schema=schema, host=host, token=token,
        ),
        parallelism=parallelism,
    )


def read_mongo(uri: str, database: str, collection: str, *, pipeline=None, parallelism: int = -1) -> Dataset:
    """MongoDB collection (parity: read_mongo; requires pymongo)."""
    from ray_tpu_torch.data.datasource import MongoDatasource

    return Dataset(
        L.Read(MongoDatasource(uri, database, collection, pipeline), _parallelism(parallelism))
    )


def read_bigquery(project_id: str, *, query=None, dataset=None, parallelism: int = -1) -> Dataset:
    """BigQuery query/table (parity: read_bigquery; requires google-cloud-bigquery)."""
    from ray_tpu_torch.data.datasource import BigQueryDatasource

    return Dataset(
        L.Read(BigQueryDatasource(project_id, query=query, dataset=dataset), _parallelism(parallelism))
    )


def from_torch(torch_dataset, *, parallelism: int = -1) -> Dataset:
    """Materialize a torch.utils.data.Dataset (map-style) or iterable
    (parity: from_torch)."""
    import builtins

    if hasattr(torch_dataset, "__getitem__") and hasattr(torch_dataset, "__len__"):
        rows = [torch_dataset[i] for i in builtins.range(len(torch_dataset))]
    else:
        rows = list(torch_dataset)
    items = []
    for row in rows:
        if isinstance(row, tuple) and len(row) == 2:
            items.append({"item": _to_numpy(row[0]), "label": _to_numpy(row[1])})
        else:
            items.append(_to_numpy(row))
    return from_items(items, parallelism=parallelism)


def from_tf(tf_dataset, *, parallelism: int = -1) -> Dataset:
    """Materialize a tf.data.Dataset (parity: from_tf)."""
    items = []
    for elem in tf_dataset.as_numpy_iterator():
        if isinstance(elem, dict):
            items.append(elem)
        elif isinstance(elem, tuple) and len(elem) == 2:
            items.append({"item": elem[0], "label": elem[1]})
        else:
            items.append(elem)
    return from_items(items, parallelism=parallelism)


def from_huggingface(hf_dataset) -> Dataset:
    """A Hugging Face datasets.Dataset rides in as Arrow (parity:
    from_huggingface).  Materialized through ``with_format("arrow")`` — NOT
    the raw ``.data`` table — so select/filter/shuffle views (which live in
    the dataset's ``_indices``) are honored."""
    table = hf_dataset.with_format("arrow")[:]
    return from_arrow(table)


def _to_numpy(x):
    if hasattr(x, "numpy"):
        try:
            return x.numpy()
        except Exception:  # noqa: BLE001
            return x
    return x
