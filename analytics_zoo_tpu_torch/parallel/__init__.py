"""Parallelism of the port: so far the sharded embedding engine
(``embedding``: deduped gather, sparse row updates, the row-sharding rule;
one card).  Sharding over a mesh waits for ROADMAP Queue 1 item 7."""

from .embedding import (SPARSE_LEAF, ShardedEmbedding, ShardingRule,
                        dedup_lookup, embedding_row_rules, lookup_stats)

__all__ = ["SPARSE_LEAF", "ShardedEmbedding", "ShardingRule",
           "dedup_lookup", "embedding_row_rules", "lookup_stats"]
