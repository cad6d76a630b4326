"""Host-side data pipeline of the port (numpy, no device work)."""

from bigdl_tpu_torch.dataset.dataset import (AbstractDataSet, LocalDataSet,
                                             TransformedDataSet,
                                             array_dataset)
from bigdl_tpu_torch.dataset.minibatch import (MiniBatch, PaddingParam,
                                               Sample, samples_to_minibatch)
from bigdl_tpu_torch.dataset.prefetch import PrefetchDataSet
from bigdl_tpu_torch.dataset.transformer import (ChainedTransformer,
                                                 FnTransformer, Normalizer,
                                                 SampleToMiniBatch,
                                                 Transformer)

__all__ = ["AbstractDataSet", "ChainedTransformer", "FnTransformer",
           "LocalDataSet", "MiniBatch", "Normalizer", "PaddingParam",
           "PrefetchDataSet", "Sample", "SampleToMiniBatch",
           "TransformedDataSet", "Transformer", "array_dataset",
           "samples_to_minibatch"]
