"""The weight bridge: a JAX ``TransformerLM`` parameter tree, with numpy
leaves (``jax.tree.map(np.asarray, params)``), into the port's modules.

Both JAX layouts load: the unrolled ``"block{i}"`` keys map onto the
port's blocks directly, and the ``scan_layers`` layout's stacked
``"blocks"`` entry is unstacked first.  Keys and shapes are checked
leaf by leaf (``Module.load_parameters_tree``).
"""

from bigdl_tpu_torch.nn.attention import unstack_block_params


def to_port_tree(jax_params):
    """The JAX tree in the port's (unrolled) layout."""
    if "blocks" in jax_params:
        return unstack_block_params(jax_params)
    return dict(jax_params)


def load_jax_params(model, jax_params):
    """Copy a JAX parameter tree into ``model``; returns ``model``."""
    return model.load_parameters_tree(to_port_tree(jax_params))
