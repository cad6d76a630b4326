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
"""

import numpy as np
import torch


class Module(torch.nn.Module):
    """A ``torch.nn.Module`` whose parameters read and load as a nested
    dict keyed like the JAX package's parameter tree."""

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
        and shapes must match exactly: a missing, extra or misshapen leaf
        raises before anything is copied."""
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
        for name, p in params.items():
            p.copy_(torch.as_tensor(np.array(flat[name]), dtype=p.dtype))
        return self


class Container(Module):
    """A module built from child modules, each registered under the key
    its parameters take in the JAX tree (``"ln1"``, ``"block3"`` ...)."""

    def add(self, key: str, module: torch.nn.Module):
        self.add_module(key, module)
        return module
