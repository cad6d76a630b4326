"""Train and eval step builders (counterpart of
``bigdl_tpu/optim/train_step.py``: ``_cast_tree`` :22, ``_cast_params``
:31, ``make_train_step`` :52, ``make_eval_step`` :144).

The JAX step is one jitted program over (params, state, batch).  Here
the step runs eagerly on the model's own parameters, in the JAX order:
cast the parameters to the compute dtype, forward in training mode, cast
the output to fp32, the criterion plus the regularization term on the
fp32 masters, backward, the gradients in fp32, ``grad_transform``, the
frozen gradients zeroed, clipping by value then by global norm, the
fp32 update in place, the frozen parameters restored.  A parameter the
loss does not reach gets a zero gradient, as ``jax.grad`` gives it.

Mixed precision (``compute_dtype=torch.bfloat16``) never casts the
module in place: the forward runs through
``torch.func.functional_call`` on cast copies of the rank >= 2
parameters, so autograd through ``.to(bf16)`` lands fp32 gradients on
the fp32 masters, as ``jax.grad`` through ``astype`` does.  The buffers
(model state) and the rank-1 parameters (BatchNorm's affine) stay fp32,
as JAX leaves ``mstate`` and its vectors uncast.

Model state: the JAX step returns a new ``mstate``; here a layer in
training mode writes its buffers in place during the forward (BatchNorm's
running statistics), once a step, a rematerialised recompute included.
The eval step reads the buffers as they are.
"""

import copy

import torch
from torch.func import functional_call

from bigdl_tpu_torch.nn import dropout as _dropout
from bigdl_tpu_torch.nn.module import frozen_param_mask, has_frozen
from bigdl_tpu_torch.optim.optim_method import (clip_by_global_norm,
                                                clip_by_value)
from bigdl_tpu_torch.optim.regularizer import (has_regularizers,
                                               regularization_loss)


def _cast_tree(x, dtype):
    """Floating tensors of ``x`` (a tensor, or tuples, lists and dicts of
    them) to ``dtype``; integer tensors (token ids) stay as they are."""
    if dtype is None:
        return x
    if isinstance(x, dict):
        return {k: _cast_tree(v, dtype) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_cast_tree(v, dtype) for v in x)
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(dtype)
    return x


def _cast_params(params, dtype):
    """The compute-dtype copy of a ``{name: parameter}`` dict: floating
    leaves of rank >= 2 (the matrix operands) only.  Vectors (biases,
    LayerNorm affine) stay fp32 masters; each layer casts them where it
    uses them."""
    if dtype is None:
        return params
    return {k: p.to(dtype) if p.is_floating_point() and p.dim() >= 2 else p
            for k, p in params.items()}


def compute_copy(model, dtype):
    """A copy of ``model`` in eval mode holding ``_cast_params``'s
    parameters (fresh tensors, no gradient; it shares no parameter with
    ``model``) and ``model``'s own buffers, so it reads the current
    model state (BatchNorm's running statistics) as JAX's eval step
    reads the current ``mstate``.  ``functional_call`` swaps a module's
    parameters in place for the length of a call, which another thread
    running the same module would see: a caller that evaluates in
    ``dtype`` beside such a thread evaluates this copy instead."""
    memo = {id(p): None for p in model.parameters()}
    memo.update({id(b): b for b in model.buffers()})
    twin = copy.deepcopy(model, memo)
    for name, p in _cast_params(dict(model.named_parameters()),
                                dtype).items():
        owner, _, key = name.rpartition(".")
        twin.get_submodule(owner)._parameters[key] = torch.nn.Parameter(
            p.detach().clone(), requires_grad=False)
    return twin.eval()


def _forward(model, params, input, compute_dtype):
    """The model's output on ``input`` in ``compute_dtype`` (None: the
    parameters' own), cast to fp32."""
    if compute_dtype is None:
        out = model(input)
    else:
        out = functional_call(model, _cast_params(params, compute_dtype),
                              (_cast_tree(input, compute_dtype),))
    return _cast_tree(out, torch.float32)


def make_train_step(model, criterion, optim_method, clip_value=None,
                    clip_norm=None, compute_dtype=None, grad_transform=None,
                    health_stats=False):
    """``train_step(opt_state, input, target, generator=None) ->
    (opt_state, loss)``: updates ``model``'s parameters and
    ``opt_state`` in place; ``loss`` is the criterion's value, a 0-d
    tensor on the device (reading it syncs).  ``generator`` is the step's
    random stream (TransformerLM draws none).

    A model with attention dropout draws its masks from
    ``train_step.dropout_key`` (``nn.dropout``: a 0-d int64 device
    tensor, seeded once from the port's random stream and advanced by one
    on the device after every step, so a captured step draws new masks
    at every replay); None for a model without dropout.

    ``compute_dtype=torch.bfloat16``: fp32 master parameters, bf16
    forward and backward, fp32 loss and update.  ``grad_transform``
    maps the ``{name: fp32 gradient}`` dict before freezing and clipping.
    Frozen modules (``Module.freeze``) and regularizers
    (``Module.set_regularizer``) are read once, here."""
    if health_stats:
        raise NotImplementedError(
            "health_stats: observability/health.py is not ported yet "
            "(ROADMAP A8)")
    params = dict(model.named_parameters())
    use_reg = has_regularizers(model)
    frozen = [k for k, keep in frozen_param_mask(model).items()
              if not keep] if has_frozen(model) else []
    key = None
    if _dropout.uses_dropout(model):
        from bigdl_tpu_torch.utils.random_generator import RNG

        _dropout.salt_by_path(model)
        key = _dropout.new_step_key(RNG.next_generator(),
                                    next(model.parameters()).device)

    def train_step(opt_state, input, target, generator=None):
        model.train()
        model.zero_grad(set_to_none=True)
        # the key stays set through backward: a rematerialised layer
        # redraws its mask there
        with _dropout.step_key(key):
            loss = criterion.apply(
                _forward(model, params, input, compute_dtype), target)
            total = loss + regularization_loss(model, params) if use_reg \
                else loss
            total.backward()
        if key is not None:
            key.add_(1)
        grads = {k: p.grad.float() if p.grad is not None
                 else torch.zeros_like(p) for k, p in params.items()}
        if grad_transform is not None:
            grads = grad_transform(grads)
        for k in frozen:
            grads[k] = torch.zeros_like(grads[k])
        if clip_value is not None:
            clip_by_value(grads, *clip_value)
        if clip_norm is not None:
            clip_by_global_norm(grads, clip_norm)
        kept = {k: params[k].detach().clone() for k in frozen}
        optim_method.update(grads, opt_state, params)
        with torch.no_grad():
            for k, p in kept.items():
                params[k].copy_(p)
        return opt_state, loss.detach()

    train_step.dropout_key = key
    return train_step


def make_eval_step(model, compute_dtype=None):
    """``eval_step(input) -> output`` in eval mode, no gradient, computed
    in ``compute_dtype`` (None: the parameters' own) on the model's
    current weights and returned in fp32.  In a compute dtype a call
    swaps the model's parameters for their casts while it runs: beside
    another thread using ``model``, evaluate ``compute_copy(model,
    dtype)`` instead."""
    params = dict(model.named_parameters())

    @torch.no_grad()
    def eval_step(input):
        model.eval()
        return _forward(model, params, input, compute_dtype)

    return eval_step
