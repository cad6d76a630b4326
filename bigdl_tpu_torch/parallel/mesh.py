"""Named meshes over a ``torch.distributed`` world: the port's
counterpart of ``jax.sharding.Mesh`` as ``Engine.build_mesh`` makes it
(``bigdl_tpu/utils/engine.py``), and of the axis binding that
``shard_map`` gives a program.

A mesh of shape ``(a, b, ...)`` over a world of ``a * b * ...`` ranks
lays the ranks out row-major, as JAX lays out its devices: rank ``r``
sits at ``numpy.unravel_index(r, shape)``.  Each axis has one process
group per line of ranks that differ only along it (``dist.new_group``,
made once, in the same order on every rank, as ``new_group`` requires),
and ``collectives(axis, ...)`` is a ``parallel.collectives.Collectives``
over this rank's line (or plane, for several axes).

A module that names an axis (``MultiHeadAttention(seq_axis_name=...)``)
finds its collectives through ``axis_collectives(name)`` while a mesh is
bound (``with mesh.bound(): ...``), as a JAX module's ``lax.axis_index``
resolves only inside ``shard_map``: outside, the name is unbound and the
lookup raises.
"""

import contextlib

import numpy as np
import torch.distributed as dist

from bigdl_tpu_torch.parallel.collectives import Collectives

#: the bound mesh: a process-wide binding, not a thread's, because the
#: autograd engine's threads recompute rematerialised layers
_BOUND = {"mesh": None}


class Mesh:
    """``shape`` (ints) over ``axis_names`` (strs) on the process group
    ``group`` (None: the default group).  ``mesh.shape`` maps each name
    to its size, as JAX's ``Mesh.shape`` does; ``axis_names`` keeps the
    order; ``coords`` is this rank's place."""

    def __init__(self, shape, axis_names, group=None):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(str(a) for a in axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names "
                             f"{axis_names} differ in length")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis name in {axis_names}")
        world = dist.get_world_size(group)
        if int(np.prod(shape)) != world:
            raise ValueError(f"mesh shape {shape} holds {int(np.prod(shape))}"
                             f" devices, but the world has {world} ranks")
        self.group = group
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.rank = dist.get_rank(group)
        self._global = [dist.get_global_rank(group, r) if group is not None
                        else r for r in range(world)]
        self.coords = dict(zip(axis_names, (int(c) for c in np.unravel_index(
            self.rank, shape))))
        self._colls = {}
        for name in axis_names:
            self._make((name,))

    def _make(self, axes):
        """The groups of ``axes`` (every rank makes every line's group,
        in one order) and this rank's ``Collectives``."""
        dims = [self.axis_names.index(a) for a in axes]
        sizes = tuple(self.shape[a] for a in self.axis_names)
        grid = np.arange(int(np.prod(sizes))).reshape(sizes)
        rest = [i for i in range(len(sizes)) if i not in dims]
        lines = np.transpose(grid, rest + dims).reshape(
            -1, int(np.prod([sizes[d] for d in dims])))
        mine = None
        for line in lines:
            ranks = [self._global[int(r)] for r in line]
            g = dist.new_group(ranks)
            if self.rank in line:
                mine = g
        self._colls[axes] = Collectives(mine)

    def collectives(self, *axes):
        """The ``Collectives`` over ``axes`` (one or more names, in mesh
        order within the result: a rank's index is row-major over them).
        A combination not made at construction is made here, which every
        rank must reach alike."""
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"{a!r} is not an axis of the mesh "
                                 f"{self.axis_names}")
        axes = tuple(a for a in self.axis_names if a in axes)
        if axes not in self._colls:
            self._make(axes)
        return self._colls[axes]

    def axis_index(self, name):
        """This rank's coordinate on ``name`` (``lax.axis_index``)."""
        return self.coords[name]

    def axis_size(self, name):
        return self.shape[name]

    @property
    def size(self):
        return int(np.prod(list(self.shape.values())))

    @contextlib.contextmanager
    def bound(self):
        """Bind this mesh's axis names for the length of the block (a
        strategy step runs its model inside)."""
        prev = _BOUND["mesh"]
        _BOUND["mesh"] = self
        try:
            yield self
        finally:
            _BOUND["mesh"] = prev

    def __repr__(self):
        axes = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        return f"Mesh({axes})"


def bound_mesh():
    """The mesh bound by ``Mesh.bound()``, or None."""
    return _BOUND["mesh"]


def axis_collectives(name):
    """The bound mesh's ``Collectives`` over the axis ``name``; raises
    when no mesh binds it (JAX: "unbound axis name")."""
    mesh = bound_mesh()
    if mesh is None or name not in mesh.shape:
        raise NameError(
            f"unbound axis name: {name!r} (run the model inside a "
            f"strategy step over a mesh with that axis, or build it "
            f"without the axis)")
    return mesh.collectives(name)


def axis_index(name):
    axis_collectives(name)
    return bound_mesh().axis_index(name)

