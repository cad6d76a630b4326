"""Observability of the PyTorch port: the device-memory ledger
(``memory.py``).  Spans, request tracing, health statistics and the
metrics bridge are ROADMAP A8."""

from bigdl_tpu_torch.observability.memory import (MemoryLedger,
                                                  device_memory_stats,
                                                  is_oom_error, tree_bytes)

__all__ = ["MemoryLedger", "device_memory_stats", "is_oom_error",
           "tree_bytes"]
