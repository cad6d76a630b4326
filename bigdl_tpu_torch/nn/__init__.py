"""Layers of the PyTorch port, under the JAX package's parameter keys."""

from bigdl_tpu_torch.nn.attention import (MultiHeadAttention,
                                          TransformerBlock, TransformerLM,
                                          dot_product_attention)
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import Container, Module
from bigdl_tpu_torch.nn.normalization import LayerNorm

__all__ = ["Container", "LayerNorm", "Linear", "Module",
           "MultiHeadAttention", "TransformerBlock", "TransformerLM",
           "dot_product_attention"]
