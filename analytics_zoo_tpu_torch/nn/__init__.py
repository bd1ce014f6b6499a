"""Layers of the port (``torch.nn.Module``s with the JAX package's names
and parameter layouts), its losses and its metrics: every name of
``analytics_zoo_tpu.nn`` but ``Module`` and ``Scope``, for which
``torch.nn.Module`` stands."""

from . import activations, initializers, losses, metrics, quant
from .attention import (FLASH_AUTO_MIN_SEQ, MultiHeadAttention,
                        TransformerLayer, causal_mask, dot_product_attention)
from .functional import Input, Model, SymbolicTensor
from .layers import (Activation, Add, AveragePooling2D, BatchNormalization,
                     Concatenate, Conv1D, Conv2D, Dense, Dropout, Embedding,
                     Flatten, GlobalAveragePooling1D, GlobalAveragePooling2D,
                     GlobalMaxPooling1D, GlobalMaxPooling2D, Lambda,
                     LayerNormalization, MaxPooling2D, Multiply, Remat,
                     Reshape, ScaledWSConv2D, Sequential, ZeroPadding2D,
                     scaled_ws_kernel, seed_dropout)
from .layers_extra import (ELU, AveragePooling1D, AveragePooling3D, Average,
                           Conv2DTranspose, Conv3D, Cropping1D, Cropping2D,
                           Cropping3D, DepthwiseConv2D, Dot, GaussianDropout,
                           GaussianNoise, GlobalAveragePooling3D,
                           GlobalMaxPooling3D, Highway, LeakyReLU,
                           LocallyConnected1D, Masking, MaxoutDense,
                           MaxPooling1D, MaxPooling3D, Maximum, Minimum,
                           Narrow, Permute, PReLU, RepeatVector, Select,
                           SeparableConv2D, SpatialDropout1D,
                           SpatialDropout2D, SpatialDropout3D, Squeeze,
                           SReLU, Subtract, ThresholdedReLU, UpSampling1D,
                           UpSampling2D, UpSampling3D, ZeroPadding1D,
                           ZeroPadding3D)
from .layers_zoo import (CMul, LRN2D, ActivityRegularization, AddConstant,
                         AlphaDropout, CAdd, Conv1DTranspose,
                         Conv3DTranspose, ConvLSTM2D, ConvLSTM3D, Cos, Exp,
                         GaussianSampler, HardShrink, HardTanh, Identity,
                         LocallyConnected2D, Log, Merge, MulConstant,
                         Negative, Power, ResizeBilinear, Scale,
                         SeparableConv1D, Softmax, SoftShrink, Sqrt, Square,
                         Threshold, WordEmbedding, merge)
from .module import apply_with_taps, param_count
from .recurrent import GRU, LSTM, Bidirectional, SimpleRNN, TimeDistributed

# Keras-1 spellings (``analytics_zoo_tpu/nn/__init__.py``), so ported
# scripts keep their names
Convolution1D = Conv1D
Convolution2D = Conv2D
Convolution3D = Conv3D
Deconvolution2D = Conv2DTranspose
Deconvolution3D = Conv3DTranspose
AtrousConvolution1D = Conv1D   # dilation= covers the atrous variants
AtrousConvolution2D = Conv2D
ShareConvolution2D = Conv2D
SeparableConvolution2D = SeparableConv2D
SparseEmbedding = Embedding
SparseDense = Dense

__all__ = [
    "activations", "initializers", "losses", "metrics", "quant",
    "param_count", "apply_with_taps",
    "Dense", "Embedding", "Dropout", "Flatten", "Reshape", "Activation",
    "Lambda", "Conv1D", "Conv2D", "MaxPooling2D", "AveragePooling2D",
    "GlobalAveragePooling2D", "GlobalMaxPooling2D", "GlobalAveragePooling1D",
    "GlobalMaxPooling1D", "ZeroPadding2D", "BatchNormalization",
    "LayerNormalization", "Concatenate", "Add", "Multiply", "Sequential",
    "Remat", "ScaledWSConv2D", "scaled_ws_kernel", "seed_dropout",
    "LSTM", "GRU", "SimpleRNN", "Bidirectional", "TimeDistributed",
    "MultiHeadAttention", "TransformerLayer", "dot_product_attention",
    "causal_mask", "FLASH_AUTO_MIN_SEQ",
    # layers_extra
    "Conv3D", "Conv2DTranspose", "DepthwiseConv2D", "SeparableConv2D",
    "LocallyConnected1D", "MaxPooling1D", "AveragePooling1D",
    "MaxPooling3D", "AveragePooling3D", "GlobalAveragePooling3D",
    "GlobalMaxPooling3D", "UpSampling1D", "UpSampling2D", "UpSampling3D",
    "ZeroPadding1D", "ZeroPadding3D", "Cropping1D", "Cropping2D",
    "RepeatVector", "Permute", "Masking", "SpatialDropout1D",
    "SpatialDropout2D", "SpatialDropout3D", "GaussianNoise",
    "GaussianDropout", "LeakyReLU", "ELU", "ThresholdedReLU", "PReLU",
    "Average", "Maximum", "Minimum", "Subtract", "Dot", "Highway",
    "MaxoutDense", "Cropping3D", "SReLU", "Select", "Narrow", "Squeeze",
    # the functional graph API
    "Input", "Model", "SymbolicTensor",
    # layers_zoo
    "ConvLSTM2D", "LocallyConnected2D", "Conv3DTranspose", "Conv1DTranspose",
    "SeparableConv1D", "AlphaDropout", "Softmax", "ActivityRegularization",
    "LRN2D", "Cos", "Identity", "Exp", "Log", "Sqrt", "Square", "Power",
    "Negative", "AddConstant", "MulConstant", "Scale", "Threshold",
    "HardShrink", "SoftShrink", "WordEmbedding", "Merge", "merge",
    "ConvLSTM3D", "CAdd", "CMul", "HardTanh", "GaussianSampler",
    "ResizeBilinear",
    # Keras-1 spellings
    "Convolution1D", "Convolution2D", "Convolution3D", "Deconvolution2D",
    "Deconvolution3D", "AtrousConvolution1D", "AtrousConvolution2D",
    "ShareConvolution2D", "SeparableConvolution2D", "SparseEmbedding",
    "SparseDense",
]
