"""Input pipeline of the port (the in-memory array feed and the device
augmentation chain so far)."""

from .augment import (DeviceAugment, DeviceNormalize, DeviceRandomCrop,
                      DeviceRandomFlip)
from .feed import DataFeed, as_feed

__all__ = ["DataFeed", "as_feed", "DeviceAugment", "DeviceNormalize",
           "DeviceRandomCrop", "DeviceRandomFlip"]
