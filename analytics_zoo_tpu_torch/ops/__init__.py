"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (port of ``analytics_zoo_tpu.ops``)."""

from .flash_attention import (flash_attention, flash_attention_bwd,
                              flash_attention_bwd_reference,
                              flash_attention_fwd,
                              flash_attention_fwd_reference, mha_reference)

__all__ = ["flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_reference", "flash_attention_fwd",
           "flash_attention_fwd_reference", "mha_reference"]
