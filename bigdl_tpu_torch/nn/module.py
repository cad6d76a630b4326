"""Module core of the PyTorch port.

Counterpart of ``bigdl_tpu/nn/module.py`` (``Module`` :111, ``Container``
:668).  The JAX package keeps parameters in a pytree passed to pure
functions; here a layer is a ``torch.nn.Module`` that holds its
parameters under the JAX key names and shapes, so the two packages'
trees map onto each other key by key:

    JAX ``params["block0"]["attn"]["qkv_weight"]``
    port ``model.block0.attn.qkv_weight``

``parameters_tree()`` / ``load_parameters_tree()`` convert between the
module and that nested-dict form.  A module's state (JAX's ``state``
tree: BatchNorm's ``running_mean`` / ``running_var``) lives in registered
buffers under the JAX state keys, read and loaded by ``state_tree()`` /
``load_state_tree()`` with the same checks.  Both loads copy in place:
captured CUDA graphs hold the tensors' addresses.

JAX's state is functional: ``jax.checkpoint`` recomputes a block's
forward in backward but keeps the state its forward returned.  Here a
layer writes its buffers in ``forward``, so a recompute runs under
``frozen_state()``, in which ``state_updates()`` is False and no buffer
is written.

Names, freezing and regularizers follow the JAX ``Module``: ``name`` /
``set_name`` (:86-101, :145), ``freeze`` / ``unfreeze`` with the
tri-state mark (:450-490), ``set_regularizer`` (:517), and the
``has_frozen`` / ``frozen_param_mask`` walks (:695-730), which read the
module tree directly: it already follows the JAX parameter keys.
``predict`` / ``predict_class`` (:566, 572) run ``optim.Predictor``.
"""

import contextlib

import numpy as np
import torch

_name_counters = {}
#: set while a rematerialised forward is recomputed (``frozen_state``); a
#: module-level slot, not thread-local, because the autograd engine
#: recomputes on a thread of its own
_state_frozen = False


def state_updates() -> bool:
    """Whether a layer in training mode may write its state buffers now
    (False while a rematerialised forward is recomputed)."""
    return not _state_frozen


@contextlib.contextmanager
def frozen_state():
    """Within the block no layer writes its state buffers."""
    global _state_frozen
    outer, _state_frozen = _state_frozen, True
    try:
        yield
    finally:
        _state_frozen = outer


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
            for m in all_modules(self):
                if isinstance(m, Module):
                    m._frozen = None
        else:
            self._freeze_named(set(names), False)
        return self

    def _freeze_named(self, names, value):
        found = set()
        for m in all_modules(self):
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
        return _nest(self.named_parameters())

    def state_tree(self):
        """Nested dict of this module's state buffers (detached tensors),
        keyed like the JAX ``state`` tree."""
        return _nest(self.named_buffers())

    @torch.no_grad()
    def load_parameters_tree(self, tree):
        """Copy every leaf of ``tree`` (numpy arrays or tensors, nested
        like ``parameters_tree()``) into the matching parameter.  Keys
        and shapes must match exactly, and an int8 leaf (a quantized
        payload) loads only into an int8 parameter: a missing, extra,
        misshapen or mistyped leaf raises before anything is copied.  An
        empty entry (JAX's ``()`` for a layer without parameters) holds
        nothing to load."""
        _load_in_place(dict(self.named_parameters()), tree, "parameter")
        return self

    @torch.no_grad()
    def load_state_tree(self, tree):
        """Copy a state tree (JAX's ``model.state()`` with numpy or JAX
        leaves, or ``state_tree()``) into the buffers, in place, with
        ``load_parameters_tree``'s checks; ``()`` is an empty tree."""
        _load_in_place(dict(self.named_buffers()), tree, "state")
        return self

    def quantize(self) -> "Module":
        """Rewrite this model for int8 inference in place (JAX
        ``nn/module.py:509``, reference ``AbstractModule.quantize()``):
        ``nn.quantized.quantize(self)``, which swaps its ``Linear`` and
        convolution children for their int8 twins; returns self in eval
        mode."""
        from bigdl_tpu_torch.nn.quantized import quantize

        return quantize(self)

    def predict(self, data, batch_size: int = 128):
        """Batch inference (``optim.Predictor``): one output per sample."""
        from bigdl_tpu_torch.optim.predictor import Predictor

        return Predictor(self, batch_size).predict(data)

    def predict_class(self, data, batch_size: int = 128):
        """The argmax class of each sample's output."""
        from bigdl_tpu_torch.optim.predictor import Predictor

        return Predictor(self, batch_size).predict_class(data)


def _nest(named):
    tree = {}
    for name, t in named:
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.detach()
    return tree


def _load_in_place(targets, tree, what):
    """Copy ``tree``'s leaves into ``targets`` (name -> tensor) in place
    after checking keys, shapes and int8-ness of every leaf."""
    flat = {}

    def walk(node, prefix):
        for key, val in node.items():
            name = f"{prefix}{key}"
            if isinstance(val, dict):
                walk(val, name + ".")
            elif not (isinstance(val, (tuple, list)) and not val):
                flat[name] = val

    if isinstance(tree, dict):
        walk(tree, "")
    missing = sorted(set(targets) - set(flat))
    extra = sorted(set(flat) - set(targets))
    if missing or extra:
        raise KeyError(f"{what} tree mismatch: missing {missing}, "
                       f"unexpected {extra}")
    for name, t in targets.items():
        shape = tuple(np.shape(flat[name]))
        if shape != tuple(t.shape):
            raise ValueError(f"{name}: tree leaf has shape {shape}, "
                             f"{what} has {tuple(t.shape)}")
        leaf_int8 = str(getattr(flat[name], "dtype", "")) in (
            "int8", "torch.int8")
        if leaf_int8 != (t.dtype == torch.int8):
            # an int8 payload never loads as a float and back
            raise TypeError(f"{name}: tree leaf is "
                            f"{flat[name].dtype}, {what} is {t.dtype}")
    for name, t in targets.items():
        leaf = flat[name]
        if not isinstance(leaf, torch.Tensor):
            leaf = torch.as_tensor(np.array(leaf))
        t.copy_(leaf.to(dtype=t.dtype))


def all_modules(module):
    """``module.modules()`` and the layers that hold no parameters of
    their own in the registered tree (``ScanLayers``' layers, whose
    stacked parameters live in its children), each once: the modules
    that names and freezing reach."""
    seen = set()
    stack = [module]
    while stack:
        for m in stack.pop().modules():
            if id(m) not in seen:
                seen.add(id(m))
                yield m
                stack.extend(getattr(m, "hidden_layers", ()))


def has_frozen(module) -> bool:
    """Whether this module or a descendant was ``freeze()``-d."""
    return any(getattr(m, "_frozen", None) is True
               for m in all_modules(module))


def frozen_param_mask(module):
    """``{parameter name: trainable}`` over ``named_parameters()``: False
    under a frozen module, where an explicit ``unfreeze(names)`` (a False
    mark) overrides a frozen ancestor.  A ``ScanLayers`` routes its whole
    stacked subtree through its first layer's mark (``mark_route``), as
    the JAX walk routes it to child 0."""
    mask = {}

    def walk(m, prefix, inherited):
        frozen = inherited
        for marked in (m, getattr(m, "mark_route", None)):
            own = getattr(marked, "_frozen", None)
            frozen = frozen if own is None else own
        for key, _ in m.named_parameters(recurse=False):
            mask[prefix + key] = not frozen
        for key, child in m.named_children():
            walk(child, f"{prefix}{key}.", frozen)

    walk(module, "", False)
    return mask


class Container(Module):
    """A module built from child modules, each registered under the key
    its parameters take in the JAX tree (``"ln1"``, ``"block3"`` ...).
    ``add(key, module)`` registers under ``key`` and returns the module;
    ``add(module)`` takes the next index, ``"0"``, ``"1"``, ... (the JAX
    ``Container`` keying invariant) and returns the container, as JAX's
    ``add`` does, so table containers chain like JAX's."""

    def add(self, key, module=None):
        if module is None:
            self.add_module(str(len(self._modules)), key)
            return self
        self.add_module(key, module)
        return module


class Identity(Module):
    """The input, unchanged (JAX ``nn/module.py:767``)."""

    def forward(self, x):
        return x


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
        """The gradient of the loss with respect to ``input`` (a tensor,
        or a table: a tuple or list of them), in ``input``'s structure."""
        table = isinstance(input, (tuple, list))
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(True)
                  for x in (input if table else [input])]
            grads = torch.autograd.grad(
                self.apply(type(input)(xs) if table else xs[0], target), xs)
        self.grad_input = type(input)(grads) if table else grads[0]
        return self.grad_input

    def __call__(self, input, target):
        return self.forward(input, target)
