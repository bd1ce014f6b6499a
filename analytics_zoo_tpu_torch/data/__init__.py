"""Input pipeline of the port: ``XShards``, the file readers, ``ImageSet``
and ``TextSet``, the in-memory array feed, the prefetch thread, the
streaming feed over the native queue (worker threads or forked processes
writing into a shared-memory slot pool), the foreign-pipeline feeds
(tf.data, torch datasets, iterators) and the device augmentation chain."""

from .augment import (DeviceAugment, DeviceNormalize, DeviceRandomCrop,
                      DeviceRandomFlip)
from .feed import DataFeed, FeedBase, PlacedBatch, PrefetchIterator, as_feed
from .readers import (FileReadahead, read_csv, read_json, read_npz,
                      read_parquet)
from .shards import XShards
from .shm_pool import ShmBatchPool, SlotBatch
from .stream import StreamingDataFeed, make_placer
from .image import (ImageSet, ImageResize, ImageCenterCrop, ImageRandomCrop,
                    ImageRandomFlip, ImageNormalize, ImageBrightness,
                    ImageContrast, ImageSaturation, ImageColorJitter)
from .text import TextSet
from .interop import (IterableDataFeed, from_iterator, from_tf_dataset,
                      from_torch_dataset, from_torch_dataloader)

# reference-parity namespace: zoo.orca.data.pandas.read_csv
from . import readers as pandas  # noqa: F401

__all__ = ["XShards", "DataFeed", "FeedBase", "PlacedBatch",
           "PrefetchIterator", "as_feed", "read_csv", "read_json",
           "read_npz", "read_parquet", "pandas", "FileReadahead",
           "StreamingDataFeed", "make_placer", "ShmBatchPool", "SlotBatch",
           "DeviceAugment", "DeviceNormalize", "DeviceRandomCrop",
           "DeviceRandomFlip", "ImageSet", "ImageResize", "ImageCenterCrop",
           "ImageRandomCrop", "ImageRandomFlip", "ImageNormalize",
           "ImageBrightness", "ImageContrast", "ImageSaturation",
           "ImageColorJitter", "TextSet", "IterableDataFeed",
           "from_iterator", "from_tf_dataset", "from_torch_dataset",
           "from_torch_dataloader"]
