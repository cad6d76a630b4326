"""Model families of the PyTorch port."""

from bigdl_tpu_torch.models.transformer import (CONFIGS, synthetic_corpus,
                                                transformer_lm)

__all__ = ["CONFIGS", "synthetic_corpus", "transformer_lm"]
