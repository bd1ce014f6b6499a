"""Parallelism of the port over the mesh of process ranks
(``core/context.py``):

- :mod:`sharding`: the parameter-sharding rules (tensor parallel, FSDP)
  by path pattern, trimmed to the mesh, and where each piece lives;
- :mod:`util`: the batch-shard geometry and the quantized gradient
  all-reduce (``grad_compression``);
- :mod:`embedding`: the sharded embedding engine (deduped gather, sparse
  row updates, the row-sharding rule).

Ring attention, the pipeline and the MoE layer are ROADMAP Queue 1 item 9.
"""

from .embedding import (SPARSE_LEAF, ShardedEmbedding, dedup_lookup,
                        embedding_row_rules, lookup_stats)
from .sharding import (P, PartitionSpec, ShardingRule, fsdp_rules,
                       infer_param_specs, tensor_parallel_rules)
from .util import (GRAD_COMPRESSION, allreduce_compressed, batch_shard_count,
                   batch_shard_spec, compressed_allreduce, grad_wire_bytes,
                   quantize_int8)

__all__ = ["GRAD_COMPRESSION", "P", "PartitionSpec", "SPARSE_LEAF",
           "ShardedEmbedding", "ShardingRule", "allreduce_compressed",
           "batch_shard_count", "batch_shard_spec", "compressed_allreduce",
           "dedup_lookup", "embedding_row_rules", "fsdp_rules",
           "grad_wire_bytes", "infer_param_specs", "lookup_stats",
           "quantize_int8", "tensor_parallel_rules"]
