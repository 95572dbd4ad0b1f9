"""ray_tpu_torch.data: lazy streaming distributed datasets.

The port's copy of ``ray_tpu/data``, the reference's Ray Data
(``python/ray/data/``, SURVEY §2.4) rebuilt over the port's runtime:
columnar-numpy blocks, a logical plan with fusion rules, a streaming
executor with backpressure over the task fabric, two-stage push-style
shuffles, batch LLM inference (``LLMPredictor`` on the port's engine), and
an ``iter_device_batches`` consumption path that stages batches onto the
GPU (optionally sharded over a mesh), where the JAX package has
``iter_jax_batches``. A map stage given ``num_gpus`` runs next to the card.
Importing it imports no torch: CPU workers run map tasks without it.
"""

from ray_tpu_torch.data.aggregate import AggregateFn, Count, Max, Mean, Min, Std, Sum, Unique
from ray_tpu_torch.data.block import Block, BlockAccessor, BlockMetadata
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.dataset import Dataset, GroupedData, MaterializedDataset
from ray_tpu_torch.data.datasource import Datasource, ReadTask
from ray_tpu_torch.data.iterator import DataIterator
from ray_tpu_torch.data.read_api import (
    from_arrow,
    from_arrow_refs,
    from_blocks,
    from_dask,
    from_mars,
    from_modin,
    from_numpy_refs,
    from_pandas_refs,
    from_spark,
    from_huggingface,
    from_items,
    from_numpy,
    from_pandas,
    from_tf,
    from_torch,
    range,
    range_tensor,
    read_avro,
    read_binary_files,
    read_csv,
    read_datasource,
    read_images,
    read_json,
    read_numpy,
    read_bigquery,
    read_clickhouse,
    read_databricks_tables,
    read_delta,
    read_delta_sharing_tables,
    read_hudi,
    read_iceberg,
    read_lance,
    read_mongo,
    read_parquet,
    read_parquet_bulk,
    read_sql,
    read_text,
    read_tfrecords,
    read_webdataset,
)
from ray_tpu_torch.data.llm_inference import LLMPredictor, clear_engine_cache
from ray_tpu_torch.data import preprocessors
from ray_tpu_torch.data.compute import ActorPoolStrategy, NodeIdStr, Schema, set_progress_bars
from ray_tpu_torch.data.context import ExecutionOptions, ExecutionResources
from ray_tpu_torch.data.datasource import (
    BlockBasedFileDatasink,
    Datasink,
    RowBasedFileDatasink,
)
from ray_tpu_torch.data.iterator import DataIterator as DatasetIterator
from ray_tpu_torch.data.preprocessors import Preprocessor

# legacy alias (the reference kept DatasetContext as a deprecated name)
DatasetContext = DataContext

__all__ = [
    "AggregateFn",
    "LLMPredictor",
    "preprocessors",
    "ActorPoolStrategy",
    "NodeIdStr",
    "Schema",
    "set_progress_bars",
    "ExecutionOptions",
    "ExecutionResources",
    "Datasink",
    "BlockBasedFileDatasink",
    "RowBasedFileDatasink",
    "DatasetIterator",
    "DatasetContext",
    "Preprocessor",
    "clear_engine_cache",
    "Block",
    "BlockAccessor",
    "BlockMetadata",
    "Count",
    "DataContext",
    "DataIterator",
    "Dataset",
    "Datasource",
    "GroupedData",
    "MaterializedDataset",
    "Max",
    "Mean",
    "Min",
    "ReadTask",
    "Std",
    "Sum",
    "Unique",
    "from_arrow",
    "from_arrow_refs",
    "from_dask",
    "from_mars",
    "from_modin",
    "from_numpy_refs",
    "from_pandas_refs",
    "from_spark",
    "from_huggingface",
    "from_tf",
    "from_torch",
    "from_blocks",
    "from_items",
    "from_numpy",
    "from_pandas",
    "range",
    "range_tensor",
    "read_binary_files",
    "read_csv",
    "read_datasource",
    "read_json",
    "read_numpy",
    "read_images",
    "read_avro",
    "read_parquet",
    "read_parquet_bulk",
    "read_bigquery",
    "read_clickhouse",
    "read_databricks_tables",
    "read_delta",
    "read_delta_sharing_tables",
    "read_hudi",
    "read_iceberg",
    "read_lance",
    "read_mongo",
    "read_sql",
    "read_text",
    "read_tfrecords",
    "read_webdataset",
]
