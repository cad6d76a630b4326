"""Expert parallelism (counterpart of ``bigdl_tpu/parallel/ep.py``:
``MOE_EP_RULES`` :22, ``ep_sharding_for_params`` :30,
``ep_shard_params`` :45, ``make_ep_train_step`` :50 with its
``_cast_ep_params``, ``init_ep_opt_state`` :125).

JAX annotates the expert-stacked leaves with ``P("expert", ...)`` and
the batch with ``P("data")``, replicated over ``"expert"``, and GSPMD
derives the communication.  Here each rank trains a local copy of the
MoE model (``ep_local_model``) holding experts ``[r E / P, (r + 1) E /
P)`` of every ``MoE`` layer.  The ranks of one ``"expert"`` line see the
same rows of the batch (their ``"data"`` coordinate's), route every
token alike, run their own experts, and combine with a
``ReduceFromAxis`` over ``"expert"``; the expert branch's inputs (the
tokens and the gate values) enter through ``CopyToAxis``, so the
gradient of everything upstream of the experts -- the MoE input, the
router, attention, the embeddings -- is the sum over ``"expert"``.  The
routing is the global batch's (``nn/moe.py``: capacity and choice-major
slots over every data shard's tokens, the per-expert counts gathered
over ``"data"``).
"""

import re

from bigdl_tpu_torch.parallel.tp import (_leaves, _map_tree, _shard_leaf,
                                         local_copy, param_specs, spec_for)
from bigdl_tpu_torch.utils.errors import UnsupportedFeatureError

#: expert-stacked leaves: leading dim sharded over the expert axis
MOE_EP_RULES = [
    (r"moe'\]\['w1", ("expert", None, None)),
    (r"moe'\]\['w2", ("expert", None, None)),
    (r"moe'\]\['b1", ("expert", None)),
    (r"moe'\]\['b2", ("expert", None)),
]


def ep_sharding_for_params(params, mesh=None, rules=MOE_EP_RULES):
    """-> the tree of partition specs (``()`` replicated)."""
    return _map_tree(lambda p, leaf: spec_for(p, len(leaf.shape), rules),
                     params)


def ep_shard_params(params, mesh, rules=MOE_EP_RULES, axis="expert"):
    """The logical tree -> this rank's experts of it."""
    coll = mesh.collectives(axis)
    for path, leaf in _leaves(params):
        spec = spec_for(path, len(leaf.shape), rules)
        if spec and leaf.shape[0] % coll.world:
            raise ValueError(f"{path}: {leaf.shape[0]} experts do not "
                             f"split over {coll.world} ranks of {axis!r}")
    return _map_tree(lambda p, leaf: _shard_leaf(
        p, leaf, spec_for(p, len(leaf.shape), rules), axis, coll.rank,
        coll.world), params)


def ep_local_model(model, mesh, data_axis="data", rules=MOE_EP_RULES,
                   axis="expert"):
    """This rank's copy of an MoE model with its experts and the
    expert-parallel hooks set on every ``MoE`` layer (``ep``, ``route``,
    ``expert_offset``); ``tp_specs`` maps each parameter to its spec
    (the name the tensor-parallel copy uses too)."""
    from bigdl_tpu_torch.nn.moe import MoE

    if [(p, tuple(d)) for p, d in rules] != MOE_EP_RULES:
        raise UnsupportedFeatureError(
            "custom ep rules: the port's MoE layers shard the expert-"
            "stacked leaves of MOE_EP_RULES")
    layers = [m for m in model.modules() if isinstance(m, MoE)]
    if not layers:
        raise UnsupportedFeatureError(
            f"strategy='ep' trains MoE models; {type(model).__name__} "
            f"holds no MoE layer")
    coll = mesh.collectives(axis)
    n, r = coll.world, coll.rank
    local = local_copy(model, ep_shard_params(model.parameters_tree(), mesh,
                                              rules, axis))
    route = mesh.collectives(data_axis) if data_axis is not None else None
    for m in local.modules():
        if isinstance(m, MoE):
            m.ep = coll
            m.route = route
            m.expert_offset = r * (m.num_experts // n)
    local.tp_specs = param_specs(model, rules)
    return local


def _cast_ep_params(params, dtype):
    """The compute-dtype copy with the stacked-layout correction: the
    expert biases ``b1 (E, F)`` / ``b2 (E, D)`` are rank 2 but stay fp32
    masters, as unstacked biases do (the layer casts them where it uses
    them)."""
    if dtype is None:
        return params
    return {k: p.to(dtype) if p.is_floating_point() and p.dim() >= 2
            and not re.search(r"\.b[12]$", k) else p
            for k, p in params.items()}


def make_ep_train_step(local, criterion, optim_method, mesh,
                       data_axis="data", aux_weight=0.01,
                       compute_dtype=None):
    """``step(opt_state, x, y) -> (opt_state, task loss)`` on an
    expert-parallel rank's copy (``ep_local_model``): task loss plus
    ``aux_weight`` times the router's load-balance loss is
    differentiated, the task loss is returned; the gradients are
    averaged over ``data_axis`` and each expert updated where it
    lives.  Frozen modules are refused, as JAX refuses them."""
    from bigdl_tpu_torch.parallel.strategy_step import (make_mesh_train_step,
                                                        refuse_frozen)

    refuse_frozen(local)

    def loss_fn(out, target):
        logits, aux = out
        task = criterion.apply(logits, target)
        return task + aux_weight * aux, task

    axes = (data_axis,) if data_axis is not None else ()
    return make_mesh_train_step(
        local, loss_fn, optim_method, mesh, reduce_axes=axes,
        key_index=mesh.axis_index(data_axis) if data_axis else 0,
        cast=_cast_ep_params, compute_dtype=compute_dtype,
        forward_kw={"return_aux": True})


def init_ep_opt_state(optim_method, local_params):
    """Optimizer moments sharded like their parameters; scalars
    replicated."""
    return optim_method.init_state(local_params)
