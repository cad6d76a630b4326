"""Module core of the PyTorch port.

Counterpart of ``bigdl_tpu/nn/module.py`` (``Module`` :111, ``Container``
:668).  The JAX package keeps parameters in a pytree passed to pure
functions; here a layer is a ``torch.nn.Module`` that holds its
parameters under the JAX key names and shapes, so the two packages'
trees map onto each other key by key:

    JAX ``params["block0"]["attn"]["qkv_weight"]``
    port ``model.block0.attn.qkv_weight``

``parameters_tree()`` / ``load_parameters_tree()`` convert between the
module and that nested-dict form.

Names, freezing and regularizers follow the JAX ``Module``: ``name`` /
``set_name`` (:86-101, :145), ``freeze`` / ``unfreeze`` with the
tri-state mark (:450-490), ``set_regularizer`` (:517), and the
``has_frozen`` / ``frozen_param_mask`` walks (:695-730), which read the
module tree directly: it already follows the JAX parameter keys.
"""

import numpy as np
import torch

_name_counters = {}


class _Name(str):
    """A module name that is both a string and callable: ``m.name`` and
    ``m.name()`` give the same string (the reference exposes the name as
    a method, the JAX package reads it as an attribute)."""

    def __call__(self) -> str:
        return str(self)


def _auto_name(cls_name: str) -> str:
    n = _name_counters.get(cls_name, 0)
    _name_counters[cls_name] = n + 1
    return f"{cls_name}{n}"


class Module(torch.nn.Module):
    """A ``torch.nn.Module`` whose parameters read and load as a nested
    dict keyed like the JAX package's parameter tree."""

    def __init__(self, name=None):
        super().__init__()
        self.name = name or _auto_name(type(self).__name__)

    @property
    def name(self) -> _Name:
        return self._name

    @name.setter
    def name(self, value):
        self._name = _Name(value)

    def set_name(self, name: str):
        self.name = name
        return self

    def freeze(self, names=None):
        """Stop parameter updates: with ``names``, of the matching
        descendant modules (by ``name``); without, of this whole module.
        ``make_train_step`` zeroes a frozen parameter's gradient and
        restores the parameter after the update, so weight decay cannot
        move it."""
        if names is None:
            self._frozen = True
        else:
            self._freeze_named(set(names), True)
        return self

    def unfreeze(self, names=None):
        """With ``names``, marks those modules trainable, which overrides a
        frozen ancestor (tri-state: True frozen, False pinned trainable,
        None inherits); without, clears every mark on and below this
        module."""
        if names is None:
            for m in self.modules():
                if isinstance(m, Module):
                    m._frozen = None
        else:
            self._freeze_named(set(names), False)
        return self

    def _freeze_named(self, names, value):
        found = set()
        for m in self.modules():
            if isinstance(m, Module) and str(m.name) in names:
                m._frozen = value
                found.add(str(m.name))
        missing = names - found
        if missing:
            raise ValueError(f"freeze: no modules named {sorted(missing)}")

    def set_regularizer(self, w=None, b=None, u=None):
        """Attach weight, bias and recurrent (``weight_hh``) regularizers
        (``optim.regularizer``); the train step adds their terms to the
        loss on the fp32 parameters."""
        if w is not None:
            self.w_regularizer = w
        if b is not None:
            self.b_regularizer = b
        if u is not None:
            self.u_regularizer = u
        return self

    def parameters_tree(self):
        """Nested dict of this module's parameters (detached tensors)."""
        tree = {}
        for name, p in self.named_parameters():
            *path, leaf = name.split(".")
            node = tree
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = p.detach()
        return tree

    @torch.no_grad()
    def load_parameters_tree(self, tree):
        """Copy every leaf of ``tree`` (numpy arrays or tensors, nested
        like ``parameters_tree()``) into the matching parameter.  Keys
        and shapes must match exactly, and an int8 leaf (a quantized
        payload) loads only into an int8 parameter: a missing, extra,
        misshapen or mistyped leaf raises before anything is copied."""
        flat = {}

        def walk(node, prefix):
            for key, val in node.items():
                name = f"{prefix}{key}"
                if isinstance(val, dict):
                    walk(val, name + ".")
                else:
                    flat[name] = val

        walk(tree, "")
        params = dict(self.named_parameters())
        missing = sorted(set(params) - set(flat))
        extra = sorted(set(flat) - set(params))
        if missing or extra:
            raise KeyError(f"parameter tree mismatch: missing {missing}, "
                           f"unexpected {extra}")
        for name, p in params.items():
            shape = tuple(np.shape(flat[name]))
            if shape != tuple(p.shape):
                raise ValueError(f"{name}: tree leaf has shape {shape}, "
                                 f"parameter has {tuple(p.shape)}")
            leaf_int8 = str(getattr(flat[name], "dtype", "")) in (
                "int8", "torch.int8")
            if leaf_int8 != (p.dtype == torch.int8):
                # an int8 payload never loads as a float and back
                raise TypeError(f"{name}: tree leaf is "
                                f"{flat[name].dtype}, parameter is {p.dtype}")
        for name, p in params.items():
            p.copy_(torch.as_tensor(np.array(flat[name]), dtype=p.dtype))
        return self


def has_frozen(module) -> bool:
    """Whether this module or a descendant was ``freeze()``-d."""
    return any(getattr(m, "_frozen", None) is True for m in module.modules())


def frozen_param_mask(module):
    """``{parameter name: trainable}`` over ``named_parameters()``: False
    under a frozen module, where an explicit ``unfreeze(names)`` (a False
    mark) overrides a frozen ancestor."""
    mask = {}

    def walk(m, prefix, inherited):
        own = getattr(m, "_frozen", None)
        frozen = inherited if own is None else own
        for key, _ in m.named_parameters(recurse=False):
            mask[prefix + key] = not frozen
        for key, child in m.named_children():
            walk(child, f"{prefix}{key}.", frozen)

    walk(module, "", False)
    return mask


class Container(Module):
    """A module built from child modules, each registered under the key
    its parameters take in the JAX tree (``"ln1"``, ``"block3"`` ...)."""

    def add(self, key: str, module: torch.nn.Module):
        self.add_module(key, module)
        return module


class Criterion:
    """Loss base (counterpart of ``bigdl_tpu/nn/module.py:738``).

    Core: ``apply(input, target) -> scalar loss`` on tensors, differentiable
    by autograd.  Facade ``forward`` / ``backward`` / ``__call__`` mirror
    the reference; ``backward`` is the gradient with respect to the
    input."""

    size_average: bool = True

    def apply(self, input, target):
        raise NotImplementedError(type(self).__name__)

    def forward(self, input, target):
        self.output = self.apply(input, target)
        return self.output

    def backward(self, input, target):
        with torch.enable_grad():
            x = input.detach().requires_grad_(True)
            self.grad_input, = torch.autograd.grad(self.apply(x, target), x)
        return self.grad_input

    def __call__(self, input, target):
        return self.forward(input, target)
