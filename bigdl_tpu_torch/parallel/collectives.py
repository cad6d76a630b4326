"""Collectives over a ``torch.distributed`` process group: the port's
counterparts of ``jax.lax.psum_scatter(tiled=True)``,
``all_gather(tiled=True)``, ``all_to_all`` (split and concatenated on
axis 0, tiled), ``psum`` and ``pmean`` over a mesh axis.  A world of
``n`` ranks, one process each, stands for one JAX process over a mesh
of ``n`` devices on the ``"data"`` axis.

Two routes, chosen once, by the backend's name, in ``Collectives``:

- **NCCL** (the card): each operation is the native primitive
  (``reduce_scatter_tensor``, ``all_gather_into_tensor``,
  ``all_to_all_single``, ``all_reduce``, ``batch_isend_irecv``), which
  a CUDA graph can capture.
- **gloo** (the CPU, and ranks sharing one card): every operation is
  composed from ``all_reduce``, because gloo takes only ``broadcast``
  and ``all_reduce`` for CUDA tensors and, depending on the version,
  lacks ``reduce_scatter`` and ``all_to_all`` for CPU tensors.  A
  reduce-scatter is an ``all_reduce`` and then this rank's slice; an
  all-gather is an ``all_reduce`` of a plane that is zero outside this
  rank's chunk; an all-to-all is an ``all_reduce`` of an (``n``, ``n``,
  chunk) plane in which this rank fills its own row, read back by
  column; a ``ppermute`` is an ``all_reduce`` of an (``n``, ...) plane
  in which this rank fills its destination's row; a ``pmax`` is the
  maximum over a gathered plane.  A sum with zeros is exact, so the gathered and exchanged
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

    def pmax(self, x):
        """The elementwise maximum of ``x`` over the ranks."""
        if self.native:
            out = x.clone()
            dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
            return out
        return self.all_gather(x.reshape(-1)).reshape(
            self.world, *x.shape).amax(dim=0)

    def all_to_all_tiled(self, x, split_axis, concat_axis):
        """``lax.all_to_all(x, axis, split_axis, concat_axis,
        tiled=True)``: ``x`` cut into ``n`` equal pieces along
        ``split_axis``, piece ``j`` sent to rank ``j``, and the pieces
        received joined along ``concat_axis`` in rank order."""
        n = self.world
        if x.shape[split_axis] % n:
            raise ValueError(f"all_to_all: axis {split_axis} of size "
                             f"{x.shape[split_axis]} does not split into "
                             f"{n} pieces")
        rows = torch.stack(x.chunk(n, dim=split_axis))
        got = self.all_to_all(rows)
        return torch.cat(got.unbind(0), dim=concat_axis)

    def ppermute(self, x, perm):
        """``lax.ppermute``: ``perm`` lists ``(source, destination)``
        pairs of ranks; this rank sends ``x`` to its destination and
        returns what its source sent, zeros when none sends to it."""
        dst = [d for s, d in perm if s == self.rank]
        src = [s for s, d in perm if d == self.rank]
        if len(set(s for s, _ in perm)) != len(perm) \
                or len(set(d for _, d in perm)) != len(perm):
            raise ValueError(f"ppermute: {perm} is not a permutation")
        x = x.contiguous()
        if dst and dst[0] == self.rank:
            return x.clone()
        if self.native:
            out = torch.zeros_like(x)
            ops = []
            if dst:
                ops.append(dist.P2POp(dist.isend, x, self._peer(dst[0]),
                                      self.group))
            if src:
                ops.append(dist.P2POp(dist.irecv, out, self._peer(src[0]),
                                      self.group))
            for req in dist.batch_isend_irecv(ops) if ops else ():
                req.wait()
            return out
        plane = torch.zeros((self.world, *x.shape), dtype=x.dtype,
                            device=x.device)
        if dst:
            plane[dst[0]].copy_(x)
        return self._all_reduce(plane)[self.rank].clone()

    def _peer(self, r):
        return r if self.group is None else \
            dist.get_global_rank(self.group, r)

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


class CopyToAxis(torch.autograd.Function):
    """Identity forward; the gradient is summed over the ranks (the
    input of a region whose ranks each compute a part: Megatron's
    column-parallel input, the expert branch of an MoE)."""

    @staticmethod
    def forward(ctx, x, collectives):
        ctx.collectives = collectives
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.collectives.psum(g.contiguous()), None


class ReduceFromAxis(torch.autograd.Function):
    """``psum`` forward; the gradient passes unchanged (the output of a
    row-parallel region, each rank's copy of it receiving the same
    gradient)."""

    @staticmethod
    def forward(ctx, x, collectives):
        return collectives.psum(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return g, None


class PPermute(torch.autograd.Function):
    """``ppermute`` whose gradient travels the inverse permutation, the
    transpose ``jax.grad`` takes of ``lax.ppermute``."""

    @staticmethod
    def forward(ctx, x, collectives, perm):
        ctx.collectives = collectives
        ctx.inverse = [(d, s) for s, d in perm]
        return collectives.ppermute(x, perm)

    @staticmethod
    def backward(ctx, g):
        return ctx.collectives.ppermute(g, ctx.inverse), None, None


class AllToAll(torch.autograd.Function):
    """Tiled ``all_to_all`` whose gradient is the inverse exchange
    (split and concatenation axes swapped)."""

    @staticmethod
    def forward(ctx, x, collectives, split_axis, concat_axis):
        ctx.collectives = collectives
        ctx.axes = (split_axis, concat_axis)
        return collectives.all_to_all_tiled(x, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return (ctx.collectives.all_to_all_tiled(g, concat_axis,
                                                 split_axis),
                None, None, None)
