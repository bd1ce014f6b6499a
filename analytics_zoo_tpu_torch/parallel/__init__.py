"""Parallelism of the port over the mesh of process ranks
(``core/context.py``):

- :mod:`sharding`: the parameter-sharding rules (tensor parallel, FSDP)
  by path pattern, trimmed to the mesh, and where each piece lives;
- :mod:`ring_attention`: sequence parallelism over the ``seq`` axis (the
  flash kernels on each held chunk, K/V rotating around the ring);
- :mod:`moe`: the mixture-of-experts layer, its experts split over the
  ``expert`` axis;
- :mod:`pipeline`: GPipe pipeline parallelism over the ``pipe`` axis;
- :mod:`util`: the batch-shard geometry and the quantized gradient
  all-reduce (``grad_compression``);
- :mod:`embedding`: the sharded embedding engine (deduped gather, sparse
  row updates, the row-sharding rule, tables by rows over the processes);
- :mod:`comm`: the point-to-point and gather traffic these modules send
  over a group (staged through the host for gloo on CUDA tensors).
"""

from .embedding import (SPARSE_LEAF, ShardedEmbedding, dedup_lookup,
                        embedding_row_rules, lookup_stats)
from .moe import MoE
from .pipeline import pipeline_apply, stacked_stage_init
from .ring_attention import ring_attention, ring_self_attention
from .sharding import (P, PartitionSpec, ShardingRule, fsdp_rules,
                       infer_param_specs, shard_variables,
                       tensor_parallel_rules)
from .util import (GRAD_COMPRESSION, allreduce_compressed, batch_shard_count,
                   batch_shard_spec, compressed_allreduce, grad_wire_bytes,
                   quantize_int8)

__all__ = ["GRAD_COMPRESSION", "MoE", "P", "PartitionSpec", "SPARSE_LEAF",
           "ShardedEmbedding", "ShardingRule", "allreduce_compressed",
           "batch_shard_count", "batch_shard_spec", "compressed_allreduce",
           "dedup_lookup", "embedding_row_rules", "fsdp_rules",
           "grad_wire_bytes", "infer_param_specs", "lookup_stats",
           "pipeline_apply", "quantize_int8", "ring_attention",
           "ring_self_attention", "shard_variables", "stacked_stage_init",
           "tensor_parallel_rules"]
