"""Input pipeline of the port: the in-memory array feed, the prefetch
thread, the streaming feed over the native queue (worker threads or
forked processes writing into a shared-memory slot pool) and the device
augmentation chain."""

from .augment import (DeviceAugment, DeviceNormalize, DeviceRandomCrop,
                      DeviceRandomFlip)
from .feed import DataFeed, FeedBase, PlacedBatch, PrefetchIterator, as_feed
from .shm_pool import ShmBatchPool, SlotBatch
from .stream import StreamingDataFeed, make_placer

__all__ = ["DataFeed", "FeedBase", "PlacedBatch", "PrefetchIterator",
           "as_feed", "StreamingDataFeed", "make_placer", "ShmBatchPool",
           "SlotBatch", "DeviceAugment", "DeviceNormalize",
           "DeviceRandomCrop", "DeviceRandomFlip"]
