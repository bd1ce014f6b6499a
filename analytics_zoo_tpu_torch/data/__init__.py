"""Input pipeline of the port (the in-memory array feed so far)."""

from .feed import DataFeed, as_feed

__all__ = ["DataFeed", "as_feed"]
