"""Sequence-parallel (and data x sequence) training (counterpart of
``bigdl_tpu/parallel/sequence.py``: ``make_sp_train_step`` :23,
``make_sp_eval_step`` :70, ``shard_tokens`` :92).

The activations are sharded over the ``seq`` mesh axis: each rank holds
its ``(data, seq)`` block of the batch, the model's attention runs as a
ring or as Ulysses (``MultiHeadAttention(seq_axis_name=...,
seq_mode=...)``), every other layer is position-local, and each rank's
loss (K4/K5 over its own tokens and the full vocabulary) and gradient
are averaged over ``(data, seq)``.  The parameters and the optimizer
state are replicated, as in JAX.
"""

import torch

from bigdl_tpu_torch.parallel.strategy_step import (make_mesh_train_step,
                                                    refuse_frozen)


def _axes(data_axis, seq_axis):
    return tuple(a for a in (data_axis, seq_axis) if a is not None)


def make_sp_train_step(model, criterion, optim_method, mesh,
                       seq_axis="seq", data_axis=None, compute_dtype=None):
    """``step(opt_state, x, y) -> (opt_state, loss)`` on this rank's
    ``(data, seq)`` block (``shard_tokens``); ``model`` is built with
    ``seq_axis_name=seq_axis``.  The loss and the gradients are the
    means over ``(data_axis, seq_axis)`` (equal token counts a block, so
    the mean of the blocks' gradients is the gradient of the global mean
    loss)."""
    refuse_frozen(model)
    axes = _axes(data_axis, seq_axis)
    key_index = 0
    for a in axes:
        key_index = key_index * mesh.axis_size(a) + mesh.axis_index(a)

    def loss_fn(out, target):
        value = criterion.apply(out, target)
        return value, value

    return make_mesh_train_step(model, loss_fn, optim_method, mesh,
                                reduce_axes=axes, key_index=key_index,
                                compute_dtype=compute_dtype)


def _gather_blocks(local, mesh, axis, dim):
    """Every rank's ``local`` of ``axis`` joined along ``dim`` in rank
    order."""
    coll = mesh.collectives(axis)
    if coll.world == 1:
        return local
    parts = coll.all_gather(local.contiguous().reshape(-1)).reshape(
        coll.world, *local.shape)
    return torch.cat(parts.unbind(0), dim=dim)


def make_sp_eval_step(model, mesh, seq_axis="seq", data_axis=None,
                      compute_dtype=None):
    """``fwd(x_block) -> fp32 logits`` of the whole ``(B, T, V)`` batch,
    on every rank: the forward of this rank's block inside the bound
    mesh (the model's attention needs its axis), the blocks gathered
    over ``seq`` and ``data``."""
    from bigdl_tpu_torch.optim.train_step import make_eval_step

    eval_step = make_eval_step(model, compute_dtype)

    def fwd(x):
        with mesh.bound():
            out = eval_step(x)
        out = _gather_blocks(out, mesh, seq_axis, 1)
        if data_axis is not None:
            out = _gather_blocks(out, mesh, data_axis, 0)
        return out

    return fwd


def shard_tokens(x, mesh, seq_axis="seq", data_axis=None):
    """This rank's ``(data, seq)`` block of a host token array ``(B, T,
    ...)``: rows of its ``data_axis`` coordinate, columns of its
    ``seq_axis`` one."""
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return type(x)(shard_tokens(t, mesh, seq_axis, data_axis) for t in x)
    if data_axis is not None:
        n, i = mesh.axis_size(data_axis), mesh.axis_index(data_axis)
        rows = x.shape[0] // n
        x = x[i * rows:(i + 1) * rows]
    n, i = mesh.axis_size(seq_axis), mesh.axis_index(seq_axis)
    cols = x.shape[1] // n
    return x[:, i * cols:(i + 1) * cols]
