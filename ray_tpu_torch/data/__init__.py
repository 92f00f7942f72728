"""ray_tpu_torch.data: distributed datasets and the training input, the port
of ``ray_tpu/data`` (reference: ray.data).

The streaming ``Dataset``: lazy per-block task execution over the port's
shared-memory object store, in blocks of the port's own columnar ``Table``
(``block.py``), read from files, SQL or HuggingFace (``datasources.py``),
feeding a trainer's workers through ``split`` / ``get_dataset_shard`` and
the card through ``Dataset.iter_device_batches``. Beside it, the native
token-file loader (``token_loader``), the counterpart of
``ray_tpu/data/token_loader.py``, which loads lazily: the Dataset's
tasks import this package and load no torch.
"""

from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.data.datasources import (
    from_huggingface,
    read_sql,
    read_tfrecords,
    read_webdataset,
    write_tfrecords,
    write_webdataset,
)
from ray_tpu_torch.data.dataset import (
    Dataset,
    GroupedData,
    from_blocks,
    from_items,
    from_numpy,
    from_pandas,
    range,
    read_binary_files,
    read_csv,
    read_json,
    read_parquet,
    read_text,
)

_TOKEN_LOADER = ("TokenFileLoader", "to_device", "write_token_file")


def __getattr__(name):
    if name in _TOKEN_LOADER:
        from ray_tpu_torch.data import token_loader

        return getattr(token_loader, name)
    raise AttributeError(name)


__all__ = [
    "Dataset",
    "GroupedData",
    "DataContext",
    "Block",
    "BlockAccessor",
    "range",
    "from_blocks",
    "from_items",
    "from_pandas",
    "from_numpy",
    "read_parquet",
    "read_csv",
    "read_json",
    "read_text",
    "read_tfrecords",
    "read_webdataset",
    "read_sql",
    "from_huggingface",
    "write_tfrecords",
    "write_webdataset",
    "read_binary_files",
    "TokenFileLoader",
    "to_device",
    "write_token_file",
]
