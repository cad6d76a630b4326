"""ZeRO-1 flat-parameter chunking (counterpart of
``bigdl_tpu/parallel/zero.py``: ``FlatParamSpace`` :34,
``refit_flat_plane`` :74, ``repartition_ef_residual`` :103,
``stage_batch_global`` :130).

Every parameter lies in one flat fp32 vector, padded so that ``n``
ranks each own ``chunk_size`` contiguous elements: each rank reduces the
gradient of its chunk, runs the optimizer on it alone (so the optimizer
state is sharded 1/n per rank) and the all-gather rebuilds the
replicated vector.

The leaves lie in the JAX tree's order (``jax.tree.leaves`` of the
parameter dict, keys sorted at every level: ``optim_method.ravel_order``
of the ``named_parameters()`` names), not in ``named_parameters()``
order, so a ``model_params_flat`` of either package is the same bytes.

``bind(model)`` makes each parameter of ``model`` a view into one flat
storage and each gradient a view into another: the backward accumulates
into the flat gradient, the update writes the parameters' chunk in place
and the all-gather writes the flat parameters in place, with no copy per
step.
"""

import numpy as np
import torch
import torch.nn.functional as F


class FlatParamSpace:
    """Bijection between a ``{name: tensor}`` parameter dict and a padded
    flat fp32 vector.  ``block_size > 1`` rounds each chunk up to whole
    quantization blocks: the padding is the least multiple of
    ``num_chunks * block_size`` that holds every parameter."""

    def __init__(self, params, num_chunks, block_size=1):
        from bigdl_tpu_torch.optim.optim_method import ravel_order

        self.names = ravel_order(params)
        self.shapes = [tuple(params[n].shape) for n in self.names]
        self.sizes = [int(np.prod(s, dtype=np.int64)) for s in self.shapes]
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)])
        self.true_size = int(self.offsets[-1])
        self.num_chunks = int(num_chunks)
        self.block_size = max(1, int(block_size))
        unit = self.num_chunks * self.block_size
        self.padded_size = (self.true_size + unit - 1) // unit * unit
        self.chunk_size = self.padded_size // self.num_chunks

    def flatten(self, params):
        """``{name: tensor}`` -> padded flat fp32 vector."""
        first = params[self.names[0]]
        flat = torch.zeros(self.padded_size, dtype=torch.float32,
                           device=first.device)
        for name, lo, hi in self._spans():
            flat[lo:hi].copy_(params[name].detach().reshape(-1))
        return flat

    def unflatten(self, flat):
        """Padded flat vector -> ``{name: view}`` (numpy arrays give
        numpy views)."""
        return {name: flat[lo:hi].reshape(shape)
                for (name, lo, hi), shape in zip(self._spans(), self.shapes)}

    def chunk(self, flat, index):
        """Rank ``index``'s chunk of ``flat`` (a view)."""
        return flat[index * self.chunk_size:(index + 1) * self.chunk_size]

    def _spans(self):
        return ((n, int(self.offsets[i]), int(self.offsets[i + 1]))
                for i, n in enumerate(self.names))

    @torch.no_grad()
    def bind(self, model):
        """``(params_flat, grad_flat)``: flat storages on the model's
        device holding its current parameters; every parameter becomes a
        view into ``params_flat`` and its gradient a view into
        ``grad_flat`` (zeros).  ``bind_grads`` sets the gradient views
        again after something dropped them.

        A model binds once: while its parameters are still views of the
        planes an earlier bind of this layout made, those planes are
        kept, so the tensors that the model's captured graphs read stay
        where they are.  A first bind, or one of another layout, moves
        every parameter into new storage and so drops the graphs of the
        model's eval steps (``optim.validation.reset_compiled_eval_steps``),
        which read the old storage: each shape captures again on its next
        call."""
        from bigdl_tpu_torch.optim.validation import \
            reset_compiled_eval_steps

        params = dict(model.named_parameters())
        held = model.__dict__.setdefault("_flat_planes", _BoundPlanes())
        layout = (tuple(self.names), tuple(self.shapes), self.padded_size)
        if held.get("layout") == layout and \
                self._views_of(params, held["params"]):
            params_flat, grad_flat = held["params"], held["grads"]
            grad_flat.zero_()
        else:
            params_flat = self.flatten(params)
            grad_flat = torch.zeros_like(params_flat)
            for name, view in self.unflatten(params_flat).items():
                params[name].data = view
            held.update(layout=layout, params=params_flat, grads=grad_flat)
            reset_compiled_eval_steps(model)
        self._grads = [(params[name], view) for name, view in
                       self.unflatten(grad_flat).items()]
        self.bind_grads()
        return params_flat, grad_flat

    def _views_of(self, params, params_flat):
        """Whether every parameter is its view of ``params_flat``."""
        for name, view in self.unflatten(params_flat).items():
            p = params[name]
            if p.dtype != view.dtype or p.device != view.device or \
                    p.data_ptr() != view.data_ptr() or \
                    p.stride() != view.stride():
                return False
        return True

    def bind_grads(self):
        for p, g in self._grads:
            if p.grad is None or p.grad.data_ptr() != g.data_ptr():
                p.grad = g

    def unbind_grads(self):
        for p, _ in self._grads:
            p.grad = None


class _BoundPlanes(dict):
    """The flat planes a model's parameters are views of (``bind``),
    kept on the model; a copy of the model (``copy.deepcopy``, pickling)
    starts without them, as its parameters are its own."""

    def __deepcopy__(self, memo):
        return _BoundPlanes()

    def __reduce__(self):
        return _BoundPlanes, ()


def refit_flat_plane(a, padded_size, true_size=None):
    """A flat-plane leaf saved under one chunk layout, fitted to another
    (an n -> m resume, or a change of block rounding): the layouts hold
    the same ``true_size`` elements and differ only in trailing padding,
    so the last axis is zero-padded or truncated.  A scalar, or a vector
    that already fits, passes through; truncating below ``true_size``
    raises.  Numpy arrays stay numpy, tensors stay tensors."""
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
    if a.ndim < 1 or a.shape[-1] == padded_size:
        return a
    if a.shape[-1] > padded_size:
        if true_size is not None and padded_size < true_size:
            raise ValueError(
                f"cannot refit a {a.shape[-1]}-element flat plane onto "
                f"padded size {padded_size} < true size {true_size}: "
                "the target layout holds fewer parameters than the "
                "snapshot")
        return a[..., :padded_size]
    pad = padded_size - a.shape[-1]
    if isinstance(a, torch.Tensor):
        return F.pad(a, (0, pad))
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)])


def repartition_ef_residual(ef, true_size, num_chunks, padded_size):
    """The error-feedback residual plane (one row per rank) onto another
    rank count: the rows are summed (the total correction is what the
    trajectory depends on), the old padding dropped, and row ``j`` of the
    result takes the sum's values in rank ``j``'s chunk, zeros elsewhere.
    Numpy in, numpy out, as the JAX function."""
    ef = np.asarray(ef, np.float32)
    if ef.ndim != 2:
        raise ValueError(f"EF residual plane must be 2-D, got {ef.shape}")
    total = ef.sum(axis=0)[:min(int(true_size), ef.shape[1])]
    total = np.pad(total, (0, int(padded_size) - total.size))
    out = np.zeros((int(num_chunks), int(padded_size)), np.float32)
    chunk = int(padded_size) // int(num_chunks)
    for j in range(int(num_chunks)):
        out[j, j * chunk:(j + 1) * chunk] = total[j * chunk:(j + 1) * chunk]
    return out


def rank_rows(tree, rank, world):
    """Rank ``rank``'s rows of a global batch (arrays, tuples or lists of
    them; None passes): rows ``rank * B / n`` to ``(rank + 1) * B / n``,
    the counterpart of ``stage_batch_global``'s data-axis sharding."""
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(rank_rows(t, rank, world) for t in tree)
    rows = tree.shape[0] // world
    return tree[rank * rows:(rank + 1) * rows]
