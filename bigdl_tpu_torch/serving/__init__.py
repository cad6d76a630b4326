"""Serving of the PyTorch port: the coalescing engine (predict through a
CUDA graph per batch and length rung, weight staging, canary, shadow and
refresh in place), continuous-batching generation over a contiguous or
paged KV cache (fp32 or int8 blocks), speculative decoding with the int8
twin, and sampling; the fleet around it: the binary wire
(``transport.py``), subprocess workers (``worker.py``), the replicated
front end with breakers, retries, hedging, shedding and its supervisor
(``fleet.py``), and the versioned registry with staged rollouts
(``deploy.py``)."""

from bigdl_tpu_torch.serving.buckets import BucketLadder
from bigdl_tpu_torch.serving.deploy import (ModelRegistry, ModelVersion,
                                            RolloutController,
                                            snapshot_digest)
from bigdl_tpu_torch.serving.engine import (EngineDraining, ServeFuture,
                                            ServingEngine)
from bigdl_tpu_torch.serving.fleet import (CircuitBreaker,
                                           FleetOverloadedError,
                                           FleetSupervisor,
                                           FleetUnavailableError,
                                           InProcessReplica, ServingFleet,
                                           SubprocessReplica)
from bigdl_tpu_torch.serving.generation import (GenerateFuture,
                                                GenerateScheduler,
                                                PagedGenerateScheduler,
                                                SpeculativeScheduler)
from bigdl_tpu_torch.serving.paging import BlockAllocator, BlockPoolExhausted
from bigdl_tpu_torch.serving.sampling import SamplingParams
from bigdl_tpu_torch.serving.transport import (ReplicaCallError,
                                               WireAuthError, WireClient,
                                               WireError, WireFrameError,
                                               WirePool, WireProtocolError,
                                               WireVersionError)
from bigdl_tpu_torch.serving.worker import ReplicaServer

__all__ = ["BlockAllocator", "BlockPoolExhausted", "BucketLadder",
           "CircuitBreaker", "EngineDraining", "FleetOverloadedError",
           "FleetSupervisor", "FleetUnavailableError", "GenerateFuture",
           "GenerateScheduler", "InProcessReplica", "ModelRegistry",
           "ModelVersion", "PagedGenerateScheduler", "ReplicaCallError",
           "ReplicaServer", "RolloutController", "SamplingParams",
           "ServeFuture", "ServingEngine", "ServingFleet",
           "SpeculativeScheduler", "SubprocessReplica", "WireAuthError",
           "WireClient", "WireError", "WireFrameError", "WirePool",
           "WireProtocolError", "WireVersionError", "snapshot_digest"]
