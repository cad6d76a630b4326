"""The weight bridge: a JAX ``TransformerLM`` parameter tree, fp32 or
int8-quantized, with numpy leaves (``jax.tree.map(np.asarray,
params)``), into the port's modules;
and the optimizer-state bridge, so a JAX run can be carried across
mid-training.

Both JAX layouts load: the unrolled ``"block{i}"`` keys map onto the
port's blocks directly, and the ``scan_layers`` layout's stacked
``"blocks"`` entry is unstacked first.  Keys and shapes are checked
leaf by leaf (``Module.load_parameters_tree``).
"""

import numpy as np
import torch

from bigdl_tpu_torch.nn.attention import unstack_block_params
from bigdl_tpu_torch.optim.optim_method import SGD, Adam
from bigdl_tpu_torch.utils.device import resolve_device


def to_port_tree(jax_params):
    """The JAX tree in the port's (unrolled) layout."""
    if "blocks" in jax_params:
        return unstack_block_params(jax_params)
    return dict(jax_params)


def load_jax_params(model, jax_params):
    """Copy a JAX parameter tree into ``model``; returns ``model``.  A
    tree from ``bigdl_tpu.nn.quantized.quantize_params`` loads into the
    port's int8 twin (``nn.quantized.quantize_model``), its int8
    payloads as int8 and its scales as fp32."""
    return model.load_parameters_tree(to_port_tree(jax_params))


def _flatten(tree, prefix=""):
    """Nested dict -> ``{"block0.attn.qkv_weight": leaf}``, the names of
    ``named_parameters()``."""
    flat = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            flat.update(_flatten(val, f"{prefix}{key}."))
        else:
            flat[f"{prefix}{key}"] = val
    return flat


def _slots(optim_method):
    """The per-parameter state trees a method keeps."""
    if isinstance(optim_method, Adam):
        return ("m", "v")
    if isinstance(optim_method, SGD):
        return ("velocity",) if optim_method.momentum > 0 else ()
    raise NotImplementedError(
        f"{type(optim_method).__name__}: only SGD and Adam states carry "
        f"across so far")


def load_jax_opt_state(optim_method, jax_state, device=None):
    """A JAX ``Adam`` / ``SGD`` state tree (``neval`` and ``m``/``v`` or
    ``velocity``, numpy or JAX leaves, either parameter layout) -> the
    port's state, set as ``optim_method.state`` (where
    ``Optimizer.optimize()`` starts from) and returned.  ``device=None``
    means the CUDA card."""
    device = resolve_device(device)
    slots = _slots(optim_method)
    extra = sorted(set(jax_state) - {"neval", *slots})
    missing = sorted({"neval", *slots} - set(jax_state))
    if extra or missing:
        raise KeyError(f"{type(optim_method).__name__} state mismatch: "
                       f"missing {missing}, unexpected {extra}")
    state = {"neval": int(np.asarray(jax_state["neval"]))}
    for slot in slots:
        state[slot] = {
            name: torch.as_tensor(np.array(leaf), dtype=torch.float32,
                                  device=device)
            for name, leaf in _flatten(to_port_tree(jax_state[slot])).items()}
    optim_method.state = state
    return state
