"""Layer-stacked parameter trees (counterpart of
``bigdl_tpu/nn/containers.py`` ``stack_layer_trees`` :349 /
``unstack_layer_trees`` :356).

The port always holds its transformer blocks unrolled; these helpers let
the weight bridge read (and write) the JAX ``scan_layers`` layout, in
which every leaf of one ``"blocks"`` entry carries a leading layer axis.
Leaves may be numpy arrays or tensors.
"""

import numpy as np
import torch


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
