"""Serving of the PyTorch port: the coalescing engine, continuous-batching
generation over a contiguous or paged KV cache, and sampling."""

from bigdl_tpu_torch.serving.buckets import BucketLadder
from bigdl_tpu_torch.serving.engine import (EngineDraining, ServeFuture,
                                            ServingEngine)
from bigdl_tpu_torch.serving.generation import (GenerateFuture,
                                                GenerateScheduler,
                                                PagedGenerateScheduler)
from bigdl_tpu_torch.serving.paging import BlockAllocator, BlockPoolExhausted
from bigdl_tpu_torch.serving.sampling import SamplingParams

__all__ = ["BlockAllocator", "BlockPoolExhausted", "BucketLadder",
           "EngineDraining", "GenerateFuture", "GenerateScheduler",
           "PagedGenerateScheduler", "SamplingParams", "ServeFuture",
           "ServingEngine"]
