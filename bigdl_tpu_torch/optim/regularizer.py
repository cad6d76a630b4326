"""Per-layer weight regularizers (counterpart of
``bigdl_tpu/optim/regularizer.py``).

A regularizer is attached to a module with ``set_regularizer(w=, b=,
u=)`` and enters the train step's LOSS, computed on the fp32 parameters,
so autograd gives its gradient contribution (``l2 * w`` for
``0.5 * l2 * sum(w^2)``, ``l1 * sign(w)`` for ``l1 * sum(|w|)``); the
reported loss stays the bare criterion value.
"""

import torch


def _abs_sum(w):
    """``sum(|w|)`` whose gradient is +1 at ``w = 0`` (and -0), as
    ``jnp.abs``'s is (``torch.abs`` gives 0 there): an L1 term on a
    zero-initialised bias moves it, as in the JAX package."""
    return (w * torch.where(w >= 0, 1.0, -1.0)).sum()


class Regularizer:
    def __call__(self, w):
        raise NotImplementedError(type(self).__name__)


class L1Regularizer(Regularizer):
    def __init__(self, l1: float):
        self.l1 = l1

    def __call__(self, w):
        return self.l1 * _abs_sum(w)


class L2Regularizer(Regularizer):
    def __init__(self, l2: float):
        self.l2 = l2

    def __call__(self, w):
        return 0.5 * self.l2 * w.square().sum()


class L1L2Regularizer(Regularizer):
    def __init__(self, l1: float, l2: float):
        self.l1, self.l2 = l1, l2

    def __call__(self, w):
        return self.l1 * _abs_sum(w) + 0.5 * self.l2 * w.square().sum()


def has_regularizers(module) -> bool:
    """Whether a module of the tree carries a weight or bias regularizer
    (the JAX rule: a ``u`` regularizer alone does not count)."""
    return any(getattr(m, "w_regularizer", None) is not None
               or getattr(m, "b_regularizer", None) is not None
               for m in module.modules())


def regularization_loss(module, params=None):
    """The sum of the tree's regularization terms, a 0-d fp32 tensor, over
    ``params`` (``{name: tensor}`` as ``named_parameters()``; default the
    module's own).  The JAX key rule: a ``weight*`` parameter takes the
    module's ``w_regularizer``, except ``weight_hh``, which prefers
    ``u_regularizer`` when one is set; a ``bias*`` parameter takes
    ``b_regularizer``.  So attention's ``qkv_weight`` / ``out_weight``
    are not matched, as in the JAX package."""
    if params is None:
        params = dict(module.named_parameters())
    total = torch.zeros((), dtype=torch.float32,
                        device=next(iter(params.values())).device)
    for prefix, m in module.named_modules():
        wreg = getattr(m, "w_regularizer", None)
        breg = getattr(m, "b_regularizer", None)
        ureg = getattr(m, "u_regularizer", None)
        if wreg is None and breg is None and ureg is None:
            continue
        for key, _ in m.named_parameters(recurse=False):
            leaf = params[f"{prefix}.{key}" if prefix else key]
            if key.startswith("weight"):
                reg = ureg if key == "weight_hh" and ureg is not None \
                    else wreg
                if reg is not None:
                    total = total + reg(leaf.to(torch.float32))
            elif key.startswith("bias") and breg is not None:
                total = total + breg(leaf.to(torch.float32))
    return total
