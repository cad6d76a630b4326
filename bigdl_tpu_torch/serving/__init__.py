"""Serving of the PyTorch port: the coalescing engine (predict through a
CUDA graph per batch and length rung, weight staging, canary, shadow and
refresh in place), continuous-batching generation over a contiguous or
paged KV cache (fp32 or int8 blocks), speculative decoding with the int8
twin, and sampling."""

from bigdl_tpu_torch.serving.buckets import BucketLadder
from bigdl_tpu_torch.serving.engine import (EngineDraining, ServeFuture,
                                            ServingEngine)
from bigdl_tpu_torch.serving.generation import (GenerateFuture,
                                                GenerateScheduler,
                                                PagedGenerateScheduler,
                                                SpeculativeScheduler)
from bigdl_tpu_torch.serving.paging import BlockAllocator, BlockPoolExhausted
from bigdl_tpu_torch.serving.sampling import SamplingParams

__all__ = ["BlockAllocator", "BlockPoolExhausted", "BucketLadder",
           "EngineDraining", "GenerateFuture", "GenerateScheduler",
           "PagedGenerateScheduler", "SamplingParams", "ServeFuture",
           "ServingEngine", "SpeculativeScheduler"]
