"""The step the model-parallel strategies share (``parallel/tp.py``,
``sequence.py``, ``ep.py``): the port's counterpart of the jitted
``step(params, opt_state, x, y, rng)`` bodies of the JAX package's
``make_tp_train_step``, ``make_sp_train_step`` and
``make_ep_train_step``; and the pieces ``parallel/pp.py``'s pipeline
step takes from it (``refuse_frozen``, ``step_dropout_key``,
``reduce_flat``, ``logical_sq_norm``).

One step on this rank: the forward and backward of the rank's model
(its local copy under tp and ep, the model itself under sp) inside the
bound mesh, so its collectives (``CopyToAxis``, ``ReduceFromAxis``,
``PPermute``, ``AllToAll``) and their transposes run in the step; the
gradients in fp32; their mean over the data-like axes (one all-reduce
of the flat gradient); the method's update on this rank's parameters
(sharded leaves update their shard, as JAX's optimizer state inherits
the parameter shardings); the loss's mean over the same axes.  Clipping
is the optimizer's (``optim/strategy_optimizer._ClippingMethod``), its
global norm summed over the logical tree by ``logical_sq_norm``.

Each rank seeds its own loss's backward with 1, and each collective's
transpose carries the gradient between ranks, so rank r's gradient of a
replicated parameter is the gradient of the sum of the ranks' losses
with respect to r's copy, and their mean over the data-like axes is the
gradient of the global mean loss: what ``jax.grad`` of JAX's one global
program gives.
"""

import torch
from torch.func import functional_call

from bigdl_tpu_torch.nn import dropout as _dropout
from bigdl_tpu_torch.optim.train_step import _cast_params, _cast_tree
from bigdl_tpu_torch.utils.random_generator import RNG

#: offset of a rank's dropout key: its index times this odd constant
_KEY_STRIDE = 0x9E3779B1


def refuse_frozen(model):
    from bigdl_tpu_torch.nn.module import has_frozen

    if has_frozen(model):
        raise NotImplementedError(
            "freeze() is honored by make_train_step and the "
            "DistriOptimizer flat-chunk step; this model-parallel engine "
            "does not mask frozen parameters yet -- unfreeze() before "
            "building, or train with LocalOptimizer/DistriOptimizer")


def logical_sq_norm(grads, sharded):
    """The squared norm of the logical gradient tree: ``sharded`` maps a
    name to the ``Collectives`` its leaf is sharded over (its squares
    are summed over those ranks); every other leaf is replicated and
    counted once."""
    total = None
    by_axis = {}
    for name, g in grads.items():
        sq = g.float().square().sum()
        coll = sharded.get(name)
        if coll is None:
            total = sq if total is None else total + sq
        else:
            key = id(coll)
            prev = by_axis.get(key, (coll, None))[1]
            by_axis[key] = (coll, sq if prev is None else prev + sq)
    for coll, sq in by_axis.values():
        sq = coll.psum(sq)
        total = sq if total is None else total + sq
    return total


def reduce_flat(tensors, collectives, mean=False):
    """Every value of the dict ``tensors`` replaced by its sum (with
    ``mean``: its mean) over ``collectives``, through one all-reduce of
    their concatenation (the new values are views of its result)."""
    names = list(tensors)
    flat = collectives.psum(torch.cat([tensors[k].reshape(-1)
                                       for k in names]))
    if mean:
        flat /= collectives.world
    at = 0
    for k in names:
        n = tensors[k].numel()
        tensors[k] = flat[at:at + n].view_as(tensors[k])
        at += n


def step_dropout_key(model, key_index=0):
    """The step's dropout key for ``model`` (None when no module of it
    draws a mask): drawn from the port's random stream, offset by
    ``key_index`` (a rank's place on the axes whose ranks see different
    rows) times an odd constant."""
    if not _dropout.uses_dropout(model):
        return None
    _dropout.salt_by_path(model)
    key = _dropout.new_step_key(RNG.next_generator(),
                                next(model.parameters()).device)
    return key.add_(int(key_index) * _KEY_STRIDE)


def make_mesh_train_step(model, loss_fn, optim_method, mesh,
                         reduce_axes=(), key_index=0, cast=_cast_params,
                         compute_dtype=None, forward_kw=None):
    """``step(opt_state, input, target) -> (opt_state, loss)`` on this
    rank's ``model``.  The forward (``model(input, **forward_kw)``; in a
    compute dtype through ``functional_call`` on ``cast``'s copies of
    the fp32 masters) runs inside the bound mesh, its output cast to
    fp32, and ``loss_fn(output, target) -> (total, reported)``; the
    gradient of ``total`` and ``reported`` are averaged over
    ``reduce_axes``.  ``step.live`` and ``step.dropout_key`` are what
    ``optim.graphs.CompiledTrainStep`` reads; ``key_index`` offsets the
    dropout key (a rank's place on the axes whose ranks see different
    rows)."""
    params = dict(model.named_parameters())
    red = mesh.collectives(*reduce_axes) if reduce_axes else None
    kw = dict(forward_kw or {})
    key = step_dropout_key(model, key_index)

    def step(opt_state, input, target):
        model.train()
        model.zero_grad(set_to_none=True)
        with mesh.bound(), _dropout.step_key(key):
            if compute_dtype is None:
                out = model(input, **kw)
            else:
                out = functional_call(model, cast(params, compute_dtype),
                                      (_cast_tree(input, compute_dtype),),
                                      kw)
            total, loss = loss_fn(_cast_tree(out, torch.float32), target)
            total.backward()
        if key is not None:
            key.add_(1)
        grads = {k: p.grad.float() if p.grad is not None
                 else torch.zeros_like(p) for k, p in params.items()}
        with torch.no_grad():
            loss = loss.detach().float()
            if red is not None and red.world > 1:
                reduce_flat(grads, red, mean=True)
                loss = red.pmean(loss)
        optim_method.update(grads, opt_state, params)
        return opt_state, loss

    step.dropout_key = key
    step.live = []
    return step
