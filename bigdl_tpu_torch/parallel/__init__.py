"""Parallelism of the PyTorch port: collectives over a
``torch.distributed`` process group, named meshes, the ZeRO-1 flat
parameter plane (counterparts of the JAX package's ``shard_map``
collectives, ``jax.sharding.Mesh`` and ``parallel/zero.py``), and the
model-parallel strategies' modules (``tp``, ``sequence``,
``ring_attention``, ``ulysses``, ``ep``, ``pp``, ``reshard``; imported
by name)."""

from bigdl_tpu_torch.parallel.collectives import (AllToAll, Collectives,
                                                  CopyToAxis, PMean,
                                                  PPermute, ReduceFromAxis)
from bigdl_tpu_torch.parallel.mesh import Mesh
from bigdl_tpu_torch.parallel.zero import (FlatParamSpace, rank_rows,
                                           refit_flat_plane,
                                           repartition_ef_residual)

__all__ = ["AllToAll", "Collectives", "CopyToAxis", "FlatParamSpace",
           "Mesh", "PMean", "PPermute", "ReduceFromAxis", "rank_rows",
           "refit_flat_plane", "repartition_ef_residual"]
