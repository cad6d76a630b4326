"""Containers, table ops, remat and scanned layers (counterpart of
``bigdl_tpu/nn/containers.py``).

Tables are Python tuples of tensors; dimension indices are 0-based.
Children are keyed ``"0"``, ``"1"``, ... as in the JAX package, so the
parameter names follow its tree.

Remat: JAX's ``jax.checkpoint`` under a named policy becomes
``torch.utils.checkpoint`` (non-reentrant, so it captures into the
training step's CUDA graph) with the same policy NAMES (``remat``):

- ``None`` / ``"nothing_saveable"``: keep the wrapped function's inputs
  only, recompute the rest in backward;
- ``"everything_saveable"``: no checkpoint at all;
- ``"dots_saveable"`` / ``"checkpoint_dots"``: keep the outputs of the
  matrix products (``aten.mm``, ``addmm``, ``bmm``, ``baddbmm``,
  selective checkpointing), recompute the rest;
- ``"dots_with_no_batch_dims_saveable"`` /
  ``"checkpoint_dots_with_no_batch_dims"``: keep ``mm`` and ``addmm``
  outputs only (a ``Linear`` on ``(B, T, d)`` is one; attention's
  batched products are not).

A callable is taken as a torch selective-checkpoint ``policy_fn``
(``(ctx, op, *args, **kwargs) -> CheckpointPolicy``), not as a JAX
policy: that is where the two packages differ.  A kernel launched from
Python (K1) is no product, so it is recomputed under every policy but
``everything_saveable``, as JAX reruns the ``pallas_call``.  The
recompute restores no random state (``preserve_rng_state=False``):
nothing in a checkpointed layer draws from a torch generator, and the
attention dropout's mask is a pure function of the step's key
(``nn.dropout``), so the recompute draws the mask the forward drew.
The recompute runs under ``nn.module.frozen_state``: a layer with state
(BatchNorm) updates its running statistics once a step, in the forward,
as JAX's functional state is taken from the forward only.

``ScanLayers`` holds N structurally identical layers as ONE set of
parameters stacked on a leading layer axis (the JAX ``"blocks"``
layout): the stacked tensors are the only parameters, and each layer's
forward runs the first layer's modules on views ``p[i]`` taken inside
``forward`` (``_layer_view``: a shallow copy of the module tree with
the views as parameters, so nothing is swapped in place and the bf16
``functional_call`` and ``load_parameters_tree`` reach the stacked
tensors).
"""

import copy
import functools

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from bigdl_tpu_torch.nn.module import Container, Module, frozen_state

_aten = torch.ops.aten

# --------------------------------------------------------------------------- #
# Layer-stacked trees
# --------------------------------------------------------------------------- #


def _map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def stack_layer_trees(trees):
    """[per-layer tree] -> one tree, every leaf stacked on a new axis 0."""
    trees = list(trees)

    def stack(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs)
        return np.stack([np.asarray(x) for x in xs])

    return _map(stack, *trees)


def unstack_layer_trees(tree):
    """Inverse of ``stack_layer_trees``: the list of per-layer trees."""
    leaves = list(_leaves(tree))
    if not leaves:
        raise ValueError("unstack_layer_trees: tree has no array leaves")
    n = leaves[0].shape[0]
    return [_map(lambda x, i=i: x[i], tree) for i in range(n)]


# --------------------------------------------------------------------------- #
# Sequential and the table containers
# --------------------------------------------------------------------------- #


class Sequential(Container):
    """Feed-forward chain (reference: nn/Sequential.scala).  In an int8
    twin's eval forward the chain runs through its fused plan
    (``nn/fused.py``: BatchNorm, residual add and ReLU by K7)."""

    def __init__(self, *modules, name=None):
        super().__init__(name)
        for m in modules:
            self.add(m)

    def forward(self, x):
        if "_fused_plan" in self.__dict__:
            from bigdl_tpu_torch.nn.fused import plan_of

            plan = plan_of(self)
            if plan is not None:
                return plan.run(self, x)
        for m in self._modules.values():
            x = m(x)
        return x


class ConcatTable(Sequential):
    """Every branch sees the whole input; the output is the table of
    branch outputs (reference: nn/ConcatTable.scala)."""

    def forward(self, x):
        return tuple(m(x) for m in self._modules.values())


class ParallelTable(Sequential):
    """Branch i takes ``input[i]`` (reference: nn/ParallelTable.scala)."""

    def forward(self, x):
        return tuple(m(xi) for m, xi in zip(self._modules.values(), x))


class Concat(Sequential):
    """ConcatTable, its outputs joined along ``dimension`` (reference:
    nn/Concat.scala)."""

    def __init__(self, dimension: int, *modules, name=None):
        super().__init__(*modules, name=name)
        self.dimension = dimension

    def forward(self, x):
        return torch.cat([m(x) for m in self._modules.values()],
                         dim=self.dimension)


class MapTable(Container):
    """One shared module applied to every table element (reference:
    nn/MapTable.scala).  As in the JAX package the shared module's
    parameters ARE this container's, with no key level: it takes the
    module's parameter and child dicts as its own."""

    def __init__(self, module: Module, name=None):
        super().__init__(name)
        object.__setattr__(self, "module", module)
        self._parameters = module._parameters
        self._modules = module._modules
        self._buffers = module._buffers

    @property
    def mark_route(self):
        return self.module

    @property
    def hidden_layers(self):
        return (self.module,)

    def train(self, mode: bool = True):
        super().train(mode)
        self.module.training = mode
        return self

    def forward(self, x):
        return tuple(self.module(xi) for xi in x)


class CAddTable(Module):
    """Sum of the table's elements (reference: nn/CAddTable.scala)."""

    def forward(self, x):
        out = x[0]
        for t in x[1:]:
            out = out + t
        return out


class CMulTable(Module):
    """Product of the table's elements (reference: nn/CMulTable.scala)."""

    def forward(self, x):
        out = x[0]
        for t in x[1:]:
            out = out * t
        return out


class CSubTable(Module):
    """``input[0] - input[1]`` (reference: nn/CSubTable.scala)."""

    def forward(self, x):
        return x[0] - x[1]


class CDivTable(Module):
    """``input[0] / input[1]`` (reference: nn/CDivTable.scala)."""

    def forward(self, x):
        return x[0] / x[1]


class CMaxTable(Module):
    """Elementwise max over the table (reference: nn/CMaxTable.scala);
    a tie splits the gradient evenly, as ``jnp.maximum``'s does."""

    def forward(self, x):
        out = x[0]
        for t in x[1:]:
            out = torch.maximum(out, t)
        return out


class CMinTable(Module):
    """Elementwise min over the table (reference: nn/CMinTable.scala)."""

    def forward(self, x):
        out = x[0]
        for t in x[1:]:
            out = torch.minimum(out, t)
        return out


class JoinTable(Module):
    """The table's elements joined along ``dimension`` (reference:
    nn/JoinTable.scala)."""

    def __init__(self, dimension: int, name=None):
        super().__init__(name)
        self.dimension = dimension

    def forward(self, x):
        return torch.cat(list(x), dim=self.dimension)


class SelectTable(Module):
    """Element ``index`` of the table (reference: nn/SelectTable.scala)."""

    def __init__(self, index: int, name=None):
        super().__init__(name)
        self.index = index

    def forward(self, x):
        return x[self.index]


def _table_leaves(x):
    """``jax.tree.leaves`` order: sequences in order, dict values by
    sorted key."""
    if isinstance(x, (tuple, list)):
        for e in x:
            yield from _table_leaves(e)
    elif isinstance(x, dict):
        for k in sorted(x):
            yield from _table_leaves(x[k])
    else:
        yield x


class FlattenTable(Module):
    """A nested table as one flat tuple (reference:
    nn/FlattenTable.scala)."""

    def forward(self, x):
        return tuple(_table_leaves(x))


# --------------------------------------------------------------------------- #
# Remat policies
# --------------------------------------------------------------------------- #

#: the policy names ``jax.checkpoint_policies`` lists in JAX 0.9 that
#: take no arguments (the port cannot ask JAX, so it keeps this copy)
_POLICY_NAMES = ("checkpoint_dots", "checkpoint_dots_with_no_batch_dims",
                 "dots_saveable", "dots_with_no_batch_dims_saveable",
                 "everything_saveable", "nothing_saveable")

#: entries of ``jax.checkpoint_policies`` that are FACTORIES (they take
#: arguments and return a policy): never valid as a name
_POLICY_FACTORIES = frozenset({
    "offload_dot_with_no_batch_dims",
    "save_and_offload_only_these_names",
    "save_any_names_but_these",
    "save_anything_except_these_names",
    "save_from_both_policies",
    "save_only_these_names",
})

#: the products a "dots" policy keeps, by name
_SAVED_PRODUCTS = {
    "dots_saveable": (_aten.mm.default, _aten.addmm.default,
                      _aten.bmm.default, _aten.baddbmm.default),
    "dots_with_no_batch_dims_saveable": (_aten.mm.default,
                                         _aten.addmm.default),
}
_SAVED_PRODUCTS["checkpoint_dots"] = _SAVED_PRODUCTS["dots_saveable"]
_SAVED_PRODUCTS["checkpoint_dots_with_no_batch_dims"] = \
    _SAVED_PRODUCTS["dots_with_no_batch_dims_saveable"]


def checkpoint_policy_names():
    """The names a ``policy=`` string may take (JAX 0.9's list)."""
    return sorted(_POLICY_NAMES)


def resolve_checkpoint_policy(policy):
    """Check ``policy`` (``None``, a name of ``checkpoint_policy_names()``
    or a callable) and return it; a factory name or an unknown name
    raises the JAX package's ``ValueError`` here, eagerly."""
    if policy is None or callable(policy):
        return policy
    if isinstance(policy, str):
        if policy in _POLICY_FACTORIES:
            raise ValueError(
                f"{policy!r} is a policy FACTORY, not a policy: it takes "
                f"arguments a name cannot carry (and used directly it "
                f"would silently save everything, disabling remat) -- "
                f"construct it yourself and pass the callable, e.g. "
                f"policy=jax.checkpoint_policies.{policy}(...)")
        if policy not in _POLICY_NAMES:
            raise ValueError(
                f"unknown checkpoint policy {policy!r}; valid "
                f"jax.checkpoint_policies names: "
                f"{checkpoint_policy_names()}")
        return policy
    raise TypeError(
        f"policy must be None, a jax.checkpoint_policies name or a "
        f"callable, got {type(policy).__name__}")


def _keep_products(ops, ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in ops \
        else CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, *args, policy=None):
    """``fn(*args)``, its activations rematerialised in backward under
    ``policy`` (module docstring)."""
    policy = resolve_checkpoint_policy(policy)
    if policy == "everything_saveable":
        return fn(*args)
    kw = {}
    if callable(policy) or policy in _SAVED_PRODUCTS:
        policy_fn = policy if callable(policy) else functools.partial(
            _keep_products, _SAVED_PRODUCTS[policy])
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy_fn)
    calls = []

    def run(*a):
        # the first call is the forward; a later one is the recompute in
        # backward, which must leave state buffers (BatchNorm's running
        # statistics) as the forward left them, as JAX's remat does
        if calls:
            with frozen_state():
                return fn(*a)
        calls.append(1)
        return fn(*a)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


class Remat(Container):
    """The wrapped module's activations rematerialised in backward under
    ``policy`` while training (JAX ``Remat``); ``eval()`` bypasses it.
    The child is keyed ``"0"``."""

    def __init__(self, module: Module, policy=None, name=None):
        super().__init__(name)
        self.add(module)
        self.policy = resolve_checkpoint_policy(policy)

    def forward(self, x):
        inner = self._modules["0"]
        if not self.training:
            return inner(x)
        return remat(inner, x, policy=self.policy)


# --------------------------------------------------------------------------- #
# Scanned layers
# --------------------------------------------------------------------------- #


def _layer_view(module, params, prefix, training, layer):
    """A shallow copy of ``module``'s tree whose parameters are
    ``params[prefix + name][layer]`` (the stacked tensors' views) and
    whose ``training`` flag is ``training``; attention modules take
    ``layer`` as their dropout salt.  The original is not touched."""
    view = copy.copy(module)
    view.__dict__["_parameters"] = {
        k: None if p is None else params[prefix + k][layer]
        for k, p in module._parameters.items()}
    view.__dict__["_modules"] = {
        k: _layer_view(m, params, f"{prefix}{k}.", training, layer)
        for k, m in module._modules.items()}
    view.__dict__["training"] = training
    if "dropout_salt" in view.__dict__:
        view.__dict__["dropout_salt"] = layer
    return view


class ScanLayers(Container):
    """N structurally identical layers as one stack (JAX ``ScanLayers``).

    The parameters are the layers' stacked on a leading layer axis, held
    by the first layer's modules, which are this container's children:
    ``named_parameters()`` gives JAX's stacked keys and shapes.  The
    other layers keep no parameters (their names still resolve, for
    ``freeze`` and the optimizer's module names).  Layer i runs the
    first layer's code on the views ``p[i]`` and, in training, under
    ``remat`` with ``policy`` (every layer, as JAX checkpoints each scan
    iteration).  Frozen marks route through the first layer, as in JAX:
    the stacked tree freezes as a whole, and freezing another layer
    alone freezes nothing."""

    def __init__(self, modules, policy=None, name=None):
        super().__init__(name)
        layers = list(modules)
        if not layers:
            raise ValueError("ScanLayers needs at least one module")
        trees = [m.parameters_tree() for m in layers]
        sig = [(n, tuple(p.shape), p.dtype)
               for n, p in layers[0].named_parameters()]
        for i, m in enumerate(layers[1:], 1):
            if [(n, tuple(p.shape), p.dtype)
                    for n, p in m.named_parameters()] != sig:
                raise ValueError(
                    f"ScanLayers children must be structurally identical; "
                    f"child {i} ({m.name}) differs from child 0 "
                    f"({layers[0].name})")
        stacked = stack_layer_trees(trees)
        first = layers[0]
        with torch.no_grad():
            for name, leaf in _flat(stacked):
                owner, _, key = name.rpartition(".")
                sub = first.get_submodule(owner)
                sub._parameters[key] = torch.nn.Parameter(leaf)
            for m in layers[1:]:
                for sub in m.modules():
                    for key in sub._parameters:
                        sub._parameters[key] = None
        for key, child in first.named_children():
            self.add(key, child)
        for key, p in first._parameters.items():
            self._parameters[key] = p
        object.__setattr__(self, "layers", layers)
        self.policy = resolve_checkpoint_policy(policy)

    @property
    def hidden_layers(self):
        return self.layers

    @property
    def mark_route(self):
        return self.layers[0]

    def __len__(self):
        return len(self.layers)

    def __getitem__(self, i):
        return self.layers[i]

    def __iter__(self):
        return iter(self.layers)

    def layer_views(self):
        """The N layers as modules over views of the stacked parameters
        (taken now: after a cast or a load, take them again).  The views
        come from one ``unbind`` a leaf, whose backward stacks the
        layers' gradients once; a view per ``p[i]`` would add a zero
        tensor of the whole stack into its gradient for every layer."""
        params = {k: p.unbind(0) for k, p in self.named_parameters()}
        return [_layer_view(self.layers[0], params, "", self.training, i)
                for i in range(len(self.layers))]

    def forward(self, x):
        for view in self.layer_views():
            x = remat(view, x, policy=self.policy) if self.training \
                else view(x)
        return x


def _flat(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, f"{prefix}{key}.")
        else:
            yield prefix + key, val
