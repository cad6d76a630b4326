"""Train and eval step builders (counterpart of
``bigdl_tpu/optim/train_step.py``: ``make_train_step`` :52,
``make_eval_step`` :144).

The JAX step is one jitted program over (params, state, batch).  Here
the step runs eagerly on the model's own parameters: forward in
training mode, the criterion's loss, ``backward()``, clipping by value
then by global norm, and the optimizer's update in place -- the order of
the JAX step (value_and_grad, cast, clip_value, clip_norm, update).  A
parameter the loss does not reach gets a zero gradient, as ``jax.grad``
gives it.
"""

import torch

from bigdl_tpu_torch.optim.optim_method import (clip_by_global_norm,
                                                clip_by_value)


def make_train_step(model, criterion, optim_method, clip_value=None,
                    clip_norm=None, compute_dtype=None, grad_transform=None,
                    health_stats=False):
    """``train_step(opt_state, input, target, generator=None) ->
    (opt_state, loss)``: updates ``model``'s parameters and
    ``opt_state`` in place; ``loss`` is the criterion's value, a 0-d
    tensor on the device (reading it syncs).  ``generator`` is the step's
    random stream (TransformerLM draws none)."""
    waiting = {"compute_dtype": compute_dtype is not None,
               "grad_transform": grad_transform is not None,
               "health_stats": bool(health_stats)}
    if any(waiting.values()):
        raise NotImplementedError(
            f"{[k for k, on in waiting.items() if on]}: not ported yet "
            f"(ROADMAP A1)")
    params = dict(model.named_parameters())

    def train_step(opt_state, input, target, generator=None):
        model.train()
        model.zero_grad(set_to_none=True)
        loss = criterion.apply(model(input), target)
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        if clip_value is not None:
            clip_by_value(grads, *clip_value)
        if clip_norm is not None:
            clip_by_global_norm(grads, clip_norm)
        optim_method.update(grads, opt_state, params)
        return opt_state, loss.detach()

    return train_step


def make_eval_step(model):
    """``eval_step(input) -> output`` in eval mode, fp32, no gradient."""

    @torch.no_grad()
    def eval_step(input):
        model.eval()
        return model(input).float()

    return eval_step
