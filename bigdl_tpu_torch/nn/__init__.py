"""Layers of the PyTorch port, under the JAX package's parameter keys."""

from bigdl_tpu_torch.nn.attention import (MultiHeadAttention,
                                          TransformerBlock, TransformerLM,
                                          dot_product_attention)
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion,
                                          CrossEntropyCriterion,
                                          FusedSoftmaxCrossEntropyCriterion,
                                          TimeDistributedCriterion)
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import (Container, Criterion, Module,
                                       frozen_param_mask, has_frozen)
from bigdl_tpu_torch.nn.normalization import LayerNorm

__all__ = ["ClassNLLCriterion", "Container", "Criterion",
           "CrossEntropyCriterion", "FusedSoftmaxCrossEntropyCriterion",
           "LayerNorm", "Linear", "Module", "MultiHeadAttention",
           "TimeDistributedCriterion", "TransformerBlock", "TransformerLM",
           "dot_product_attention", "frozen_param_mask", "has_frozen"]
