"""Layers of the PyTorch port, under the JAX package's parameter keys."""

from bigdl_tpu_torch.nn.attention import (MultiHeadAttention,
                                          TransformerBlock, TransformerLM,
                                          dot_product_attention)
from bigdl_tpu_torch.nn.containers import (CAddTable, CDivTable, CMaxTable,
                                           CMinTable, CMulTable, Concat,
                                           ConcatTable, CSubTable,
                                           FlattenTable, JoinTable,
                                           MapTable, ParallelTable, Remat,
                                           ScanLayers, SelectTable,
                                           Sequential,
                                           checkpoint_policy_names,
                                           resolve_checkpoint_policy)
from bigdl_tpu_torch.nn.criterion import (AbsCriterion, BCECriterion,
                                          BCEWithLogitsCriterion,
                                          ClassNLLCriterion,
                                          CosineEmbeddingCriterion,
                                          CrossEntropyCriterion,
                                          DistKLDivCriterion,
                                          FusedSoftmaxCrossEntropyCriterion,
                                          HingeEmbeddingCriterion, L1Cost,
                                          KullbackLeiblerDivergenceCriterion,
                                          MarginCriterion, MSECriterion,
                                          MultiCriterion,
                                          MultiLabelSoftMarginCriterion,
                                          ParallelCriterion,
                                          SmoothL1Criterion,
                                          TimeDistributedCriterion)
from bigdl_tpu_torch.nn.criterion_extras import (
    CategoricalCrossEntropy, ClassSimplexCriterion, CosineDistanceCriterion,
    CosineProximityCriterion, DiceCoefficientCriterion, DotProductCriterion,
    GaussianCriterion, KLDCriterion, L1HingeEmbeddingCriterion,
    MarginRankingCriterion, MeanAbsolutePercentageCriterion,
    MeanSquaredLogarithmicCriterion, MultiLabelMarginCriterion,
    MultiMarginCriterion, PGCriterion, PoissonCriterion,
    SmoothL1CriterionWithWeights, SoftMarginCriterion, SoftmaxWithCriterion,
    TimeDistributedMaskCriterion, TransformerCriterion)
from bigdl_tpu_torch.nn.embedding import LookupTable
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import (Container, Criterion, Module,
                                       frozen_param_mask, has_frozen)
from bigdl_tpu_torch.nn.normalization import LayerNorm

__all__ = [
    "AbsCriterion", "BCECriterion", "BCEWithLogitsCriterion", "CAddTable",
    "CDivTable", "CMaxTable", "CMinTable", "CMulTable", "CSubTable",
    "CategoricalCrossEntropy", "ClassNLLCriterion", "ClassSimplexCriterion",
    "Concat", "ConcatTable", "Container", "CosineDistanceCriterion",
    "CosineEmbeddingCriterion", "CosineProximityCriterion", "Criterion",
    "CrossEntropyCriterion", "DiceCoefficientCriterion",
    "DistKLDivCriterion", "DotProductCriterion", "FlattenTable",
    "FusedSoftmaxCrossEntropyCriterion", "GaussianCriterion",
    "HingeEmbeddingCriterion", "JoinTable", "KLDCriterion",
    "KullbackLeiblerDivergenceCriterion", "L1Cost",
    "L1HingeEmbeddingCriterion", "LayerNorm", "Linear", "LookupTable",
    "MSECriterion", "MapTable", "MarginCriterion", "MarginRankingCriterion",
    "MeanAbsolutePercentageCriterion", "MeanSquaredLogarithmicCriterion",
    "Module", "MultiCriterion", "MultiHeadAttention",
    "MultiLabelMarginCriterion", "MultiLabelSoftMarginCriterion",
    "MultiMarginCriterion", "PGCriterion", "ParallelCriterion",
    "ParallelTable", "PoissonCriterion", "Remat", "ScanLayers",
    "SelectTable", "Sequential", "SmoothL1Criterion",
    "SmoothL1CriterionWithWeights", "SoftMarginCriterion",
    "SoftmaxWithCriterion", "TimeDistributedCriterion",
    "TimeDistributedMaskCriterion", "TransformerBlock", "TransformerCriterion",
    "TransformerLM", "checkpoint_policy_names", "dot_product_attention",
    "frozen_param_mask", "has_frozen", "resolve_checkpoint_policy"]
