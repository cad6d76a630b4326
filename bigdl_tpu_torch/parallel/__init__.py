"""Data parallelism of the PyTorch port: collectives over a
``torch.distributed`` process group and the ZeRO-1 flat parameter plane
(counterparts of the JAX package's ``shard_map`` collectives and
``parallel/zero.py``)."""

from bigdl_tpu_torch.parallel.collectives import Collectives, PMean
from bigdl_tpu_torch.parallel.zero import (FlatParamSpace, rank_rows,
                                           refit_flat_plane,
                                           repartition_ef_residual)

__all__ = ["Collectives", "FlatParamSpace", "PMean", "rank_rows",
           "refit_flat_plane", "repartition_ef_residual"]
