"""Collectives over a ``torch.distributed`` process group: the port's
counterparts of ``jax.lax.psum_scatter(tiled=True)``,
``all_gather(tiled=True)``, ``all_to_all`` (split and concatenated on
axis 0, tiled), ``psum`` and ``pmean`` over a mesh axis.  A world of
``n`` ranks, one process each, stands for one JAX process over a mesh
of ``n`` devices on the ``"data"`` axis.

Two routes, chosen once, by the backend's name, in ``Collectives``:

- **NCCL** (the card): each operation is the native primitive
  (``reduce_scatter_tensor``, ``all_gather_into_tensor``,
  ``all_to_all_single``, ``all_reduce``), which a CUDA graph can capture.
- **gloo** (the CPU, and ranks sharing one card): every operation is
  composed from ``all_reduce``, because gloo takes only ``broadcast``
  and ``all_reduce`` for CUDA tensors and, depending on the version,
  lacks ``reduce_scatter`` and ``all_to_all`` for CPU tensors.  A
  reduce-scatter is an ``all_reduce`` and then this rank's slice; an
  all-gather is an ``all_reduce`` of a plane that is zero outside this
  rank's chunk; an all-to-all is an ``all_reduce`` of an (``n``, ``n``,
  chunk) plane in which this rank fills its own row, read back by
  column.  A sum with zeros is exact, so the gathered and exchanged
  values are the senders' bits.  The gloo route runs eagerly: a CUDA
  graph cannot capture it.

Neither route gives way to the other: the backend decides.
"""

import torch
import torch.distributed as dist


class Collectives:
    """The collectives of one process group (``group=None``: the default
    group).  ``rank`` and ``world`` are this process's place in it;
    ``native`` is True on NCCL.  Inputs are flat or ``(n, ...)`` tensors
    on the group's device; outputs are new tensors unless ``out`` is
    given."""

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        self.native = self.backend == "nccl"

    def _all_reduce(self, x):
        dist.all_reduce(x, group=self.group)
        return x

    def psum(self, x):
        """The sum of ``x`` over the ranks."""
        return self._all_reduce(x.clone())

    def pmean(self, x):
        """The mean of ``x`` over the ranks."""
        return self.psum(x) / self.world

    def psum_scatter(self, x):
        """``x`` (``n * c`` elements, flat) summed over the ranks; this
        rank keeps elements ``[rank * c, (rank + 1) * c)``."""
        c = x.numel() // self.world
        if self.native:
            out = torch.empty(c, dtype=x.dtype, device=x.device)
            dist.reduce_scatter_tensor(out, x.reshape(-1), group=self.group)
            return out
        total = self._all_reduce(x.reshape(-1).clone())
        return total[self.rank * c:(self.rank + 1) * c].clone()

    def all_gather(self, chunk, out=None):
        """Every rank's ``chunk`` (flat, ``c`` elements) in rank order,
        ``n * c`` elements.  ``out`` may hold ``chunk`` as its own slice
        ``[rank * c, (rank + 1) * c)`` (gathered in place)."""
        c = chunk.numel()
        if out is None:
            out = torch.empty(c * self.world, dtype=chunk.dtype,
                              device=chunk.device)
        lo, hi = self.rank * c, (self.rank + 1) * c
        if self.native:
            dist.all_gather_into_tensor(out, chunk.reshape(-1),
                                        group=self.group)
            return out
        out[lo:hi].copy_(chunk.reshape(-1))
        out[:lo].zero_()
        out[hi:].zero_()
        return self._all_reduce(out)

    def all_to_all(self, x):
        """``x`` of shape ``(n, ...)``: row ``j`` goes to rank ``j``; row
        ``i`` of the result is rank ``i``'s row ``rank``."""
        if self.native:
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x.contiguous(), group=self.group)
            return out
        plane = torch.zeros((self.world, *x.shape), dtype=x.dtype,
                            device=x.device)
        plane[self.rank].copy_(x)
        return self._all_reduce(plane)[:, self.rank].clone()

    def broadcast(self, x, src=0):
        """``x`` in place, from rank ``src``."""
        dist.broadcast(x, src, group=self.group)
        return x

    def barrier(self, device):
        """Every rank has reached this call."""
        self._all_reduce(torch.zeros(1, device=device))


class PMean(torch.autograd.Function):
    """``pmean`` whose gradient is a ``pmean`` of the incoming gradient,
    as JAX differentiates ``lax.pmean`` inside ``shard_map``
    (``bigdl_tpu/nn/normalization.py:83-87``)."""

    @staticmethod
    def forward(ctx, x, collectives):
        ctx.collectives = collectives
        return collectives.pmean(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.collectives.pmean(g.contiguous()), None
