"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (port of ``analytics_zoo_tpu.ops``)."""

from .flash_attention import (flash_attention, flash_attention_bwd,
                              flash_attention_bwd_reference,
                              flash_attention_fwd,
                              flash_attention_fwd_reference, mha_reference)
from .fused_bn import (bn_train, bn_train_bwd, bn_train_bwd_reference,
                       bn_train_fwd, bn_train_fwd_reference, bn_train_plain)
from .fused_xent import (fused_softmax_xent, fused_xent_bwd,
                         fused_xent_bwd_reference, fused_xent_fwd,
                         fused_xent_reference)

__all__ = ["flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_reference", "flash_attention_fwd",
           "flash_attention_fwd_reference", "mha_reference", "bn_train",
           "bn_train_bwd", "bn_train_bwd_reference", "bn_train_fwd",
           "bn_train_fwd_reference", "bn_train_plain", "fused_softmax_xent",
           "fused_xent_bwd", "fused_xent_bwd_reference", "fused_xent_fwd",
           "fused_xent_reference"]
