"""Tensor parallelism (counterpart of ``bigdl_tpu/parallel/tp.py``:
``TRANSFORMER_TP_RULES`` :24, ``sharding_for_params`` :35,
``shard_params`` :51, ``make_tp_train_step`` :56,
``init_opt_state_sharded`` :106).

JAX annotates the parameters with ``NamedSharding``s over a ``"model"``
mesh axis and lets GSPMD insert the collectives.  Here each rank of the
``"model"`` axis trains a local copy of ``TransformerLM`` holding its
shards (``tp_local_model``), whose modules run the Megatron layout
themselves (``nn/attention.py``): column-parallel ``qkv`` and ``fc1``,
row-parallel ``out`` and ``fc2`` with one ``ReduceFromAxis`` a
sub-layer and ``CopyToAxis`` on each parallel region's input, the head
vocabulary-sharded and its loss the vocabulary-parallel K4/K5
(``ops.cross_entropy.vocab_parallel_cross_entropy``).  LayerNorms,
``wte``, ``wpe`` and the row-parallel biases are replicated.

The rules are JAX's regexes, matched on the JAX key paths
(``keystr``: ``['block0']['attn']['qkv_weight']``); a rule whose
dimension count differs from the leaf's leaves it replicated, as JAX's
does.  One layout differs inside: JAX's ``P("model", None)`` on
``qkv_weight (3d, d)`` cuts the 3d rows contiguously and GSPMD re-lays
them out for the head reshape, where the port cuts **by heads inside
each of q, k and v** (``_shard_leaf``), so K1 runs on whole local heads.
That is internal: every tree the port saves, loads or finalizes is the
logical one, in JAX's keys and shapes, and ``gather_params`` inverts
``shard_params`` bit for bit.
"""

import copy
import re

import torch

from bigdl_tpu_torch.utils.errors import UnsupportedFeatureError

#: path-regex -> per-dim sharding over the model axis (JAX's table)
TRANSFORMER_TP_RULES = [
    (r"qkv_weight", ("model", None)),     # column parallel (heads sharded)
    (r"qkv_bias", ("model",)),
    (r"out_weight", (None, "model")),     # row parallel
    (r"fc1'\]\['weight", ("model", None)),
    (r"fc1'\]\['bias", ("model",)),
    (r"fc2'\]\['weight", (None, "model")),
    (r"\['head'\]$", ("model", None)),    # vocab-sharded lm head
]


def keystr(path):
    """JAX's ``keystr`` of a dict-key path: ``['a']['b']``."""
    return "".join(f"[{k!r}]" for k in path)


def spec_for(path, ndim, rules):
    """The partition spec of the leaf at ``path`` (a tuple of axis names
    and None per dimension; ``()`` replicated): the first rule whose
    regex matches, if its dimension count is the leaf's."""
    name = keystr(path)
    for pattern, dims in rules:
        if re.search(pattern, name):
            return tuple(dims) if len(dims) == ndim else ()
    return ()


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, (*path, k))
        elif not (isinstance(v, (tuple, list)) and not v):
            yield (*path, k), v


def _map_tree(fn, tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _map_tree(fn, v, (*path, k))
        elif isinstance(v, (tuple, list)) and not v:
            out[k] = v
        else:
            out[k] = fn((*path, k), v)
    return out


def sharding_for_params(params, mesh=None, rules=TRANSFORMER_TP_RULES):
    """-> the tree of partition specs matching ``rules`` by parameter
    path (``mesh`` is accepted for JAX's signature; a spec names axes)."""
    return _map_tree(lambda p, leaf: spec_for(p, len(leaf.shape), rules),
                     params)


def _sharded_dim(spec, axis):
    dims = [i for i, a in enumerate(spec) if a == axis]
    return dims[0] if dims else None


def _is_qkv(path):
    return path[-1] in ("qkv_weight", "qkv_bias")


def _shard_leaf(path, leaf, spec, axis, rank, n):
    """This rank's piece of a logical leaf: its ``n``-th part along the
    sharded dimension, by heads inside each of q, k and v for the fused
    projection."""
    leaf = torch.as_tensor(leaf)
    dim = _sharded_dim(spec, axis)
    if dim is None or n == 1:
        return leaf
    size = leaf.shape[dim]
    if _is_qkv(path):
        part = leaf.unflatten(0, (3, size // 3))
        c = part.shape[1] // n
        return part[:, rank * c:(rank + 1) * c].flatten(0, 1)
    c = size // n
    return leaf.narrow(dim, rank * c, c)


def _gather_leaf(path, local, spec, collectives, axis="model"):
    """The logical leaf from every rank's piece (the inverse of
    ``_shard_leaf``; the gathered values are the pieces' bits)."""
    dim = _sharded_dim(spec, axis)
    n = collectives.world
    if dim is None or n == 1:
        return local
    parts = collectives.all_gather(local.contiguous().reshape(-1)).reshape(
        n, *local.shape)
    if _is_qkv(path):
        parts = parts.unflatten(1, (3, local.shape[0] // 3))
        return parts.transpose(0, 1).reshape(-1, *local.shape[1:])
    return torch.cat(parts.unbind(0), dim=dim)


def check_divisible(params, rules, n, axis="model"):
    for path, leaf in _leaves(params):
        spec = spec_for(path, len(leaf.shape), rules)
        dim = _sharded_dim(spec, axis)
        if dim is None:
            continue
        size = leaf.shape[dim] // (3 if _is_qkv(path) else 1)
        if size % n:
            raise ValueError(
                f"{keystr(path)}: dimension {dim} of {tuple(leaf.shape)} "
                f"does not split over {n} ranks of {axis!r}")


def shard_params(params, mesh, rules=TRANSFORMER_TP_RULES, axis="model"):
    """The logical tree (JAX keys and shapes; numpy or tensors) -> this
    rank's shards of it."""
    coll = mesh.collectives(axis)
    check_divisible(params, rules, coll.world, axis)
    return _map_tree(lambda p, leaf: _shard_leaf(
        p, leaf, spec_for(p, len(leaf.shape), rules), axis, coll.rank,
        coll.world), params)


def gather_params(local, logical_shapes, mesh, rules=TRANSFORMER_TP_RULES,
                  axis="model"):
    """Every rank's shards -> the logical tree (on every rank).  The
    specs are those of ``logical_shapes`` (a tree of leaves with
    ``.shape``, the logical tree itself or its shapes): a shard's rank
    is its leaf's, but not always its rule's dimension count."""
    coll = mesh.collectives(axis)
    specs = {p: spec_for(p, len(leaf.shape), rules)
             for p, leaf in _leaves(logical_shapes)}
    return _map_tree(lambda p, leaf: _gather_leaf(
        p, torch.as_tensor(leaf), specs[p], coll, axis), local)


def local_copy(model, shards):
    """A copy of ``model`` whose parameters are the leaves of ``shards``
    (a tree of every parameter, nested like ``parameters_tree()``),
    sharing no parameter with ``model``."""
    memo = {id(p): None for p in model.parameters()}
    twin = copy.deepcopy(model, memo)
    for path, t in _leaves(shards):
        owner, _, key = ".".join(path).rpartition(".")
        twin.get_submodule(owner)._parameters[key] = torch.nn.Parameter(
            t.detach().clone())
    return twin


def param_specs(model, rules):
    """``{parameter name: spec}`` of ``model``'s logical parameters."""
    return {name: spec_for(tuple(name.split(".")), p.dim(), rules)
            for name, p in model.named_parameters()}


def tp_local_model(model, mesh, rules=TRANSFORMER_TP_RULES, axis="model"):
    """This rank's copy of ``model`` (an unrolled ``TransformerLM``) with
    its shards and the tensor-parallel hooks set: ``num_heads / P``
    local heads, ``tp`` the axis's collectives on the attention, the
    blocks and the model, ``vocab_offset`` the first class of the head's
    shard.  ``tp_specs`` maps each parameter to its spec."""
    from bigdl_tpu_torch.nn.attention import (MultiHeadAttention,
                                              TransformerBlock,
                                              TransformerLM)

    if [(p, tuple(d)) for p, d in rules] != TRANSFORMER_TP_RULES:
        raise UnsupportedFeatureError(
            "custom tp rules: the port's tensor-parallel modules run the "
            "Megatron layout of TRANSFORMER_TP_RULES")
    if not isinstance(model, TransformerLM):
        raise UnsupportedFeatureError(
            f"strategy='tp' trains TransformerLM (the rules' Megatron "
            f"layout), not {type(model).__name__}")
    if model.scan is not None:
        raise UnsupportedFeatureError(
            "strategy='tp' on the scan_layers layout: JAX's rules leave "
            "every stacked leaf replicated there; build the model "
            "unrolled (scan_layers=False)")
    coll = mesh.collectives(axis)
    n, r = coll.world, coll.rank
    heads = model.blocks[0].attn.num_heads
    if heads % n:
        raise ValueError(f"num_heads {heads} is not divisible by the "
                         f"{axis!r} axis size {n}")
    local = local_copy(model, shard_params(model.parameters_tree(), mesh,
                                           rules, axis))
    for m in local.modules():
        if isinstance(m, MultiHeadAttention):
            m.num_heads //= n
            m.tp = coll
        elif isinstance(m, TransformerBlock):
            m.tp = coll
    local.tp = coll
    local.vocab_offset = r * (model.vocab_size // n)
    local.tp_specs = param_specs(model, rules)
    return local


def vocab_parallel_criterion(criterion, collectives, offset, vocab):
    """``criterion`` over the vocabulary shard a tensor-parallel head
    gives: ``FusedSoftmaxCrossEntropyCriterion`` and
    ``CrossEntropyCriterion`` (without class weights), bare or in
    ``TimeDistributedCriterion``, become the vocabulary-parallel K4/K5
    with the criterion's label clipping into ``[0, vocab)`` and its mean
    or sum.  Another criterion would need the gathered ``(N, V)``
    logits, which this layout never forms: it is refused."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.ops.cross_entropy import \
        vocab_parallel_cross_entropy

    inner = criterion
    if isinstance(inner, nn.TimeDistributedCriterion):
        inner = inner.criterion
    ok = isinstance(inner, nn.FusedSoftmaxCrossEntropyCriterion) or (
        isinstance(inner, nn.CrossEntropyCriterion)
        and inner.inner.weights is None)
    if not ok:
        raise UnsupportedFeatureError(
            f"strategy='tp' shards the LM head over the vocabulary and "
            f"takes its loss as the vocabulary-parallel cross-entropy; "
            f"{type(inner).__name__} would need the gathered (N, V) "
            f"logits")
    size_average = inner.size_average

    def apply(logits, target):
        flat = logits.reshape(-1, logits.shape[-1])
        y = target.reshape(-1).long().clamp(0, vocab - 1)
        losses = vocab_parallel_cross_entropy(flat, y, offset, collectives)
        return losses.mean() if size_average else losses.sum()

    return apply


def make_tp_train_step(local, criterion, optim_method, mesh,
                       data_axis="data", compute_dtype=None):
    """``step(opt_state, input, target) -> (opt_state, loss)`` on a
    tensor-parallel rank's copy (``tp_local_model``): the batch is this
    rank's rows of the ``data_axis`` (None: no data axis), the loss the
    vocabulary-parallel criterion, the gradients averaged over
    ``data_axis`` and each shard updated where it lives (JAX's
    optimizer state inherits the parameter shardings).  Frozen modules
    are refused, as JAX refuses them."""
    from bigdl_tpu_torch.parallel.strategy_step import (make_mesh_train_step,
                                                        refuse_frozen)

    refuse_frozen(local)
    coll = local.tp
    loss = vocab_parallel_criterion(criterion, coll, local.vocab_offset,
                                    local.vocab_size)

    def loss_fn(out, target):
        value = loss(out, target)
        return value, value

    axes = (data_axis,) if data_axis is not None else ()
    return make_mesh_train_step(
        local, loss_fn, optim_method, mesh, reduce_axes=axes,
        key_index=mesh.axis_index(data_axis) if data_axis else 0,
        compute_dtype=compute_dtype)


def sharded_collectives(specs, mesh, axis="model"):
    """``{name: Collectives}`` of the leaves ``specs`` shard over
    ``axis`` (``strategy_step.logical_sq_norm``'s argument)."""
    coll = mesh.collectives(axis)
    return {name: coll for name, spec in specs.items()
            if _sharded_dim(spec, axis) is not None}


def init_opt_state_sharded(optim_method, local_params):
    """The method's state over this rank's shards: moments shard like
    their parameters, scalars replicated."""
    return optim_method.init_state(local_params)
