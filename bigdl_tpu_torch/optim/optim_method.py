"""Optimization methods of the training path (counterpart of
``bigdl_tpu/optim/optim_method.py``: ``OptimMethod`` :295, ``SGD`` :318
with the ``Default`` schedule :37, ``Adam`` :374, ``clip_by_value`` and
``clip_by_global_norm`` :573-588).

The JAX methods are pure transforms over pytrees.  Here

    init_state(params)                -> state
    update(grads, state, params)      -> (params, state)

take dicts of tensors keyed alike (``dict(model.named_parameters())``)
and update ``params`` and the state's tensors IN PLACE under
``torch.no_grad()``, which saves a copy of every parameter and moment.
``state["neval"]`` is a Python int, the step count before the update.
The formulas are the JAX package's, not ``torch.optim``'s.
"""

import torch


def _float32(x):
    """A Python float rounded to fp32, as the JAX package's scalar
    arithmetic on ``neval.astype(float32)`` gives it."""
    return float(torch.tensor(x, dtype=torch.float32))


class Default:
    """``lr / (1 + step * decay)`` (the JAX package's ``SGD.Default``)."""

    def __init__(self, learning_rate_decay=0.0):
        self.decay = learning_rate_decay

    def __call__(self, step, base_lr):
        return _float32(base_lr / (1.0 + step * self.decay))


class OptimMethod:
    """Base: state is a dict that holds ``neval``.  ``state`` on the
    instance, ``None`` until set, is where ``Optimizer.optimize()`` starts
    from and leaves its final state (``load_jax_opt_state`` fills it)."""

    learning_rate: float = 1e-3
    state = None

    def init_state(self, params):
        return {"neval": 0}

    def update(self, grads, state, params):
        raise NotImplementedError(type(self).__name__)

    def get_learning_rate(self, state):
        return self.learning_rate


def _zeros_like(params):
    return {k: torch.zeros_like(p) for k, p in params.items()}


class SGD(OptimMethod):
    """SGD with momentum, dampening, nesterov and weight decay, and the
    ``Default`` learning-rate schedule."""

    def __init__(self, learning_rate=1e-3, learning_rate_decay=0.0,
                 weight_decay=0.0, momentum=0.0, dampening=None,
                 nesterov=False, learning_rate_schedule=None):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.dampening = momentum if dampening is None else dampening
        self.nesterov = nesterov
        if nesterov and (momentum <= 0 or self.dampening != 0):
            raise ValueError(
                "Nesterov momentum requires momentum > 0 and dampening = 0")
        if learning_rate_schedule is not None and \
                not isinstance(learning_rate_schedule, Default):
            raise NotImplementedError(
                f"{type(learning_rate_schedule).__name__}: only the Default "
                f"schedule is ported so far (ROADMAP A1)")
        self.schedule = learning_rate_schedule or Default(learning_rate_decay)

    def init_state(self, params):
        state = {"neval": 0}
        if self.momentum > 0:
            state["velocity"] = _zeros_like(params)
        return state

    def get_learning_rate(self, state):
        return self.schedule(state["neval"], self.learning_rate)

    @torch.no_grad()
    def update(self, grads, state, params):
        lr = self.get_learning_rate(state)
        wd, mu, damp = self.weight_decay, self.momentum, self.dampening
        for k, p in params.items():
            g = grads[k]
            if wd != 0:
                g = g + wd * p
            if mu > 0:
                vel = state["velocity"][k]
                vel.mul_(mu).add_(g, alpha=1 - damp)
                g = g + mu * vel if self.nesterov else vel
            p.sub_(lr * g)
        state["neval"] += 1
        return params, state


class Adam(OptimMethod):
    """Adam with bias correction and ``learning_rate_decay``: the step's
    learning rate uses ``neval`` before the increment and the bias
    correction ``t = neval + 1``."""

    def __init__(self, learning_rate=1e-3, learning_rate_decay=0.0,
                 beta1=0.9, beta2=0.999, epsilon=1e-8, weight_decay=0.0):
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.weight_decay = weight_decay

    def init_state(self, params):
        return {"neval": 0, "m": _zeros_like(params),
                "v": _zeros_like(params)}

    def get_learning_rate(self, state):
        return _float32(self.learning_rate
                        / (1.0 + state["neval"] * self.learning_rate_decay))

    @torch.no_grad()
    def update(self, grads, state, params):
        t = state["neval"] + 1
        lr = self.get_learning_rate(state)
        b1, b2 = self.beta1, self.beta2
        bc1 = _float32(1.0 - _float32(b1) ** t)
        bc2 = _float32(1.0 - _float32(b2) ** t)
        for k, p in params.items():
            g = grads[k]
            if self.weight_decay != 0:
                g = g + self.weight_decay * p
            m, v = state["m"][k], state["v"][k]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            # p - lr * (m / bc1) / (sqrt(v / bc2) + eps)
            p.sub_(lr * (m / bc1) / ((v / bc2).sqrt_().add_(self.epsilon)))
        state["neval"] = t
        return params, state


@torch.no_grad()
def clip_by_value(grads, min_value, max_value):
    """Clamp every gradient into ``[min_value, max_value]`` in place."""
    for g in grads.values():
        g.clamp_(min_value, max_value)
    return grads


def global_sq_norm(grads):
    return sum(g.float().square().sum() for g in grads.values())


@torch.no_grad()
def clip_by_global_norm(grads, max_norm, sq_norm=None):
    """Scale every gradient in place by ``min(1, max_norm / ||g||)``,
    with the norm over all of them (computed on the device: no host
    sync)."""
    if sq_norm is None:
        sq_norm = global_sq_norm(grads)
    norm = torch.sqrt(torch.as_tensor(sq_norm))
    scale = (max_norm / norm.clamp_min(1e-12)).clamp_max(1.0)
    for g in grads.values():
        g.mul_(scale.to(g.dtype))
    return grads


__all__ = ["Adam", "Default", "OptimMethod", "SGD", "clip_by_global_norm",
           "clip_by_value", "global_sq_norm"]
