"""The weight bridge: a JAX ``TransformerLM`` parameter tree, fp32 or
int8-quantized, with numpy leaves (``jax.tree.map(np.asarray,
params)``), into the port's modules;
and the optimizer-state bridge, so a JAX run can be carried across
mid-training, for every method of ``optim.optim_method``.  Both go the
other way too (``to_jax_params``, ``to_jax_opt_state``): numpy trees in
the JAX keys and the model's own layout, which is what the port's
checkpoints hold, so a checkpoint written by either package resumes in
the other.

Both JAX layouts load into both of the port's (``TransformerLM``
unrolled, ``"block{i}"``, or ``scan_layers``, one stacked ``"blocks"``
entry): a tree of the model's layout loads as it is, the other layout
crosses through ``stack_block_params`` / ``unstack_block_params`` (a
``Fused`` state's flat vectors are reordered, given the parameter tree).
Keys and shapes are checked leaf by leaf
(``Module.load_parameters_tree``).

``nn.moe.MoETransformerLM`` crosses both ways in the same keys
(``block{i}`` holding ``ln1``, ``attn``, ``ln2`` and ``moe`` with the
router ``gate (D, E)`` and the expert-stacked ``w1``, ``b1``, ``w2``,
``b2``).  The model-parallel strategies take these logical trees and
shard them themselves (``parallel/tp.py`` ``shard_params``,
``parallel/ep.py`` ``ep_shard_params``).

A pipelined run's trees (JAX's ``parallel/pp.stack_stage_params``
layout, ``{embed, stages, tail}``, the optimizer's slots mirroring it)
cross with ``load_jax_pp_params`` / ``to_jax_pp_params`` and
``load_jax_pp_opt_state`` / ``to_jax_pp_opt_state``, through
``parallel/reshard``'s ``pp_tree_to_blocks`` / ``blocks_to_pp_tree``.

Model state (BatchNorm's running statistics, JAX's ``model.state()``)
crosses with ``load_jax_state`` / ``to_jax_state``.  A JAX container
keys every child, one without parameters (or state) by ``()``: the trees
this module writes carry those entries, so JAX's step, which walks the
tree it is given, takes them as they are; the loads skip them.
"""

import numpy as np
import torch

from bigdl_tpu_torch.nn.attention import (stack_block_params,
                                          unstack_block_params)
from bigdl_tpu_torch.nn.containers import Remat, ScanLayers, Sequential
from bigdl_tpu_torch.optim.optim_method import (CompositeOptimMethod, Fused,
                                                ravel_order)
from bigdl_tpu_torch.utils.device import resolve_device


def is_scanned(model) -> bool:
    """Whether ``model`` holds its blocks in the scanned layout."""
    return isinstance(getattr(model, "_modules", {}).get("blocks"),
                      ScanLayers)


def to_port_tree(jax_params, scanned=False):
    """The JAX tree in the unrolled layout, or with ``scanned`` the
    scanned one."""
    if scanned and any(k.startswith("block") and k != "blocks"
                       for k in jax_params):
        return stack_block_params(jax_params)
    if not scanned and "blocks" in jax_params:
        return unstack_block_params(jax_params)
    return dict(jax_params)


def load_jax_params(model, jax_params):
    """Copy a JAX parameter tree (either layout) into ``model``;
    returns ``model``.  A tree from ``bigdl_tpu.nn.quantized.
    quantize_params`` loads into the port's int8 twin
    (``nn.quantized.quantize_model``), its int8 payloads as int8 and its
    scales as fp32."""
    return model.load_parameters_tree(
        to_port_tree(jax_params, is_scanned(model)))


def load_jax_state(model, jax_state):
    """Copy a JAX model-state tree (``model.state()``, numpy or JAX
    leaves; ``()`` where a layer has none) into ``model``'s buffers in
    place; returns ``model``."""
    return model.load_state_tree(jax_state)


def _empty(tree):
    return isinstance(tree, (tuple, list)) and not tree


def _flatten(tree, prefix=""):
    """Nested dict -> ``{"block0.attn.qkv_weight": leaf}``, the names of
    ``named_parameters()``; JAX's ``()`` entries hold nothing."""
    flat = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            flat.update(_flatten(val, f"{prefix}{key}."))
        elif not _empty(val):
            flat[f"{prefix}{key}"] = val
    return flat


def _ravel_leaves(tree, path=()):
    """``(path, leaf)`` in ``jax.flatten_util.ravel_pytree``'s order:
    dict keys sorted at every level."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from _ravel_leaves(val, (*path, key))
        elif not _empty(val):
            yield (*path, key), val


def _reravel(flat, jax_params, scanned):
    """A flat vector that ``ravel_pytree`` laid out over ``jax_params``
    (either layout), reordered as it lies over the port model's tree
    (``ravel_order`` of its names; ``scanned``: the scanned layout).  In
    the ``scan_layers`` layout each stacked ``blocks`` leaf is one
    segment holding every layer's values in turn, where the unrolled
    tree puts ``block{i}`` subtrees apart: the sizes match, the positions
    do not.  Between two trees of one layout nothing moves."""
    flat = np.asarray(flat)
    if scanned == ("blocks" in jax_params):
        return flat
    pieces, at = {}, 0
    for path, leaf in _ravel_leaves(jax_params):
        shape = tuple(leaf.shape)
        n = int(np.prod(shape))
        seg = flat[at:at + n]
        at += n
        if path[0] == "blocks":
            for i, layer in enumerate(seg.reshape(shape[0], -1)):
                pieces[".".join((f"block{i}", *path[1:]))] = layer
        else:
            pieces[".".join(path)] = seg
    if at != flat.size:
        raise ValueError(f"Fused state of {flat.size} values against "
                         f"parameters of {at}")
    if not scanned:
        return np.concatenate([pieces[k] for k in ravel_order(pieces)])
    # unrolled pieces in the stacked order: "blocks.<leaf>" holds
    # block0's <leaf>, block1's, ... in turn
    per_layer = {}
    for name, seg in pieces.items():
        head, _, rest = name.partition(".")
        if head.startswith("block"):
            per_layer.setdefault("blocks." + rest, {})[int(head[5:])] = seg
        else:
            per_layer[name] = {0: seg}
    return np.concatenate([
        np.concatenate([segs[i] for i in sorted(segs)])
        for segs in (per_layer[n] for n in ravel_order(per_layer))])


def _tensor(leaf, dtype, device):
    return torch.as_tensor(np.array(leaf), dtype=dtype, device=device)


def _state(method, jax_state, prefix, device, jax_params=None,
           scanned=False):
    """One method's state from its JAX tree; parameter names start with
    ``prefix`` (a composite's subtree path).  ``jax_params``: the tree a
    top-level ``Fused`` state was raveled over; ``scanned``: the port
    model's layout."""
    if isinstance(method, CompositeOptimMethod):
        keys = ["/".join(p) for _, p, _ in method.assignments]
        _check_keys(method, jax_state, keys)
        return {"/".join(p): _state(m, jax_state["/".join(p)],
                                    ".".join(p), device, scanned=scanned)
                for _, p, m in method.assignments}
    keys = ["neval", *method.slots]
    if getattr(getattr(method, "schedule", None), "stateful", False):
        keys.append("lr_factor")
    _check_keys(method, jax_state, keys)
    schedule = getattr(method, "schedule", None)
    if schedule is not None:
        schedule.place(device)
    state = {"neval": _tensor(jax_state["neval"], torch.int32, device)}
    if "lr_factor" in jax_state:
        state["lr_factor"] = _tensor(jax_state["lr_factor"], torch.float32,
                                     device)
    for slot in method.slots:
        tree = jax_state[slot]
        if isinstance(method, Fused) and jax_params is not None:
            tree = _reravel(tree, jax_params, scanned)
        if isinstance(method, Fused) or not isinstance(tree, dict):
            # Fused: one flat vector in ravel_pytree's order; a composite
            # path naming one parameter: that parameter's leaf
            state[slot] = _tensor(tree, torch.float32, device)
            continue
        names = _flatten(to_port_tree(tree, scanned) if not prefix
                         else tree)
        state[slot] = {f"{prefix}.{name}" if prefix else name:
                       _tensor(leaf, torch.float32, device)
                       for name, leaf in names.items()}
    return state


def _check_keys(method, jax_state, keys):
    extra = sorted(set(jax_state) - set(keys))
    missing = sorted(set(keys) - set(jax_state))
    if extra or missing:
        raise KeyError(f"{type(method).__name__} state mismatch: "
                       f"missing {missing}, unexpected {extra}")


def from_jax_opt_state(optim_method, jax_state, device=None,
                       jax_params=None, model=None):
    """``load_jax_opt_state``'s conversion alone: the port's state for
    ``jax_state``, not set on ``optim_method``."""
    return _state(optim_method, jax_state, "", resolve_device(device),
                  jax_params, model is not None and is_scanned(model))


def load_jax_opt_state(optim_method, jax_state, device=None,
                       jax_params=None, model=None):
    """A JAX optimizer state tree (numpy or JAX leaves, either parameter
    layout) -> the port's state, set as ``optim_method.state`` (where
    ``Optimizer.optimize()`` starts from) and returned.  Every method
    loads: its slots by parameter name (``m``/``v``, ``velocity``,
    ``accum``, ``accum_g``/``accum_dx``, ``m``/``u``,
    ``accum``/``linear``), ``lr_factor`` under a stateful schedule,
    ``Fused``'s flat vectors by position and a ``CompositeOptimMethod``'s
    state per subtree; ``neval`` lands as a device int32.  ``device=None``
    means the CUDA card.

    The state loads into the layout of ``model`` (the port model it
    trains; without it, the unrolled layout).  A ``Fused`` state's flat
    vectors do not say which layout they were raveled over, and the
    ``scan_layers`` layout orders them otherwise: pass that run's
    parameter tree (any leaves with ``.shape``) as ``jax_params``, and
    they are reordered to the model's layout where the two differ.
    Without it they load as they lie."""
    state = from_jax_opt_state(optim_method, jax_state, device, jax_params,
                               model)
    optim_method.state = state
    return state


def _numpy(t):
    return t.detach().cpu().numpy().copy()


def _nest(flat, prefix=""):
    """``{"block0.attn.qkv_weight": leaf}`` under ``prefix`` -> the
    nested dict below it."""
    tree = {}
    for name, leaf in flat.items():
        if prefix:
            name = name[len(prefix) + 1:]
        *path, key = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[key] = _numpy(leaf)
    return tree


def _keyed(module):
    """A container whose JAX counterpart keys every child, an empty one
    included (``Sequential``, the table containers built on it,
    ``Remat``)."""
    return isinstance(module, (Sequential, Remat))


def _with_empties(module, tree, empty):
    """``tree`` (the nested leaves below ``module``) with JAX's entries
    for the children of keyed containers that hold none: ``()`` (or the
    layer's ``jax_empty_params`` for parameters), ``{}`` for an empty
    keyed container.  A module without leaves outside a keyed container
    is ``empty(module)`` at the top only."""
    for key, child in module.named_children():
        if key in tree or _keyed(module):
            tree[key] = _with_empties(child, tree.get(key, {}), empty)
    if not tree and not _keyed(module):
        return empty(module)
    return tree


def _params_empty(module):
    return getattr(module, "jax_empty_params", ())


def to_jax_params(model):
    """``model``'s parameters as a JAX parameter tree: nested dicts of
    numpy arrays in the JAX keys and the model's own layout (``block{i}``
    unrolled, stacked ``blocks`` scanned), with JAX's empty entries."""
    return _with_empties(model, _nest(dict(model.named_parameters())),
                         _params_empty)


def to_jax_state(model):
    """``model``'s buffers as the JAX ``model.state()`` tree (numpy
    leaves, ``()`` for a layer without state; ``()`` for a model with
    none outside a keyed container, as JAX's ``TransformerLM``)."""
    return _with_empties(model, _nest(dict(model.named_buffers())),
                         lambda m: ())


def _jax_state(method, state, prefix, model):
    if isinstance(method, CompositeOptimMethod):
        return {"/".join(p): _jax_state(m, state["/".join(p)], ".".join(p),
                                        _submodule(model, ".".join(p)))
                for _, p, m in method.assignments}
    out = {"neval": _numpy(state["neval"])}
    if "lr_factor" in state:
        out["lr_factor"] = _numpy(state["lr_factor"])
    for slot in method.slots:
        tree = state[slot]
        if not isinstance(tree, dict):
            out[slot] = _numpy(tree)
            continue
        tree = _nest(tree, prefix)
        out[slot] = tree if model is None else \
            _with_empties(model, tree, _params_empty)
    return out


def _submodule(model, path):
    """The submodule at ``path``, or None (no model, or a path that
    names a parameter)."""
    if model is None:
        return None
    try:
        return model.get_submodule(path)
    except AttributeError:
        return None


def to_jax_opt_state(optim_method, state, model=None):
    """The inverse of ``from_jax_opt_state``: a port state as the JAX
    method's state tree of numpy leaves (``neval`` int32, ``lr_factor``
    fp32 under a stateful schedule, each slot in the parameter tree's
    keys, ``Fused``'s flat vectors in ``ravel_pytree``'s order, a
    composite's states per subtree path).  With ``model`` (the model it
    trains) each slot also carries JAX's empty entries, as the JAX
    method's state over that model's tree does."""
    return _jax_state(optim_method, state, "", model)


def _from_pp(tree):
    """Every stage-stacked subtree of ``tree`` in the per-block layout."""
    from bigdl_tpu_torch.parallel.reshard import (_is_pp_tree, _walk_dicts,
                                                  pp_tree_to_blocks)

    return _walk_dicts(tree, lambda d: pp_tree_to_blocks(d)
                       if _is_pp_tree(d) else None)


def _to_pp(tree, n_stages):
    """Every per-block subtree of ``tree`` stage-stacked over
    ``n_stages``."""
    from bigdl_tpu_torch.parallel.reshard import (_has_block_keys,
                                                  _walk_dicts,
                                                  blocks_to_pp_tree)

    return _walk_dicts(tree, lambda d: blocks_to_pp_tree(d, n_stages)
                       if _has_block_keys(d) else None)


def load_jax_pp_params(model, pp_params):
    """Copy a JAX stage-stacked parameter tree into ``model`` (an
    unrolled TransformerLM); returns ``model``."""
    return load_jax_params(model, _from_pp(pp_params))


def to_jax_pp_params(model, n_stages):
    """``model``'s parameters as JAX's ``stack_stage_params(model,
    n_stages)`` tree of numpy arrays."""
    return _to_pp(to_jax_params(model), n_stages)


def load_jax_pp_opt_state(optim_method, jax_state, device=None,
                          model=None):
    """``load_jax_opt_state`` of a JAX optimizer state over a
    stage-stacked tree (its slots in the pp layout)."""
    return load_jax_opt_state(optim_method, _from_pp(jax_state), device,
                              model=model)


def to_jax_pp_opt_state(optim_method, state, model, n_stages):
    """``to_jax_opt_state`` with every slot stage-stacked over
    ``n_stages``: the JAX method's state over ``stack_stage_params``."""
    return _to_pp(to_jax_opt_state(optim_method, state, model), n_stages)
