"""Optimization methods and learning-rate schedules (counterpart of
``bigdl_tpu/optim/optim_method.py``: the schedules :32-290,
``OptimMethod`` :295, ``SGD`` :318, ``Adam`` :374, ``Adagrad`` :412,
``Adadelta`` :440, ``RMSprop`` :468, ``Adamax`` :494, ``Ftrl`` :522,
clipping :573-588, ``ParallelAdam`` :590, ``Fused`` :602,
``CompositeOptimMethod`` and ``build_composite_method`` :696-818).

The JAX methods are pure transforms over pytrees.  Here

    init_state(params)                -> state
    update(grads, state, params)      -> (params, state)

take a dict of tensors keyed alike (``dict(model.named_parameters())``)
or a single tensor, and update ``params`` and the state's tensors IN
PLACE under ``torch.no_grad()``.  Everything an update reads lives on the
parameters' device: ``state["neval"]`` is a 0-d int32 tensor advanced in
place, the learning rate and the bias corrections are fp32 arithmetic on
it, and a schedule is a function of the 0-d fp32 step whose constant
tables ``init_state`` puts on that device.  So an update reads no host
value and runs unchanged inside a captured CUDA graph
(``optim/graphs.py``).  The formulas are the JAX package's, not
``torch.optim``'s.

``get_learning_rate(state)`` is a 0-d fp32 tensor on that device (reading
it syncs): the rate the next update uses where a schedule or a decay sets
it (for ``Adam``, ``Adagrad`` and ``RMSprop`` the JAX methods return the
base rate instead; the two agree at decay 0), the base rate otherwise.
"""

import torch

from bigdl_tpu_torch.utils.errors import ConfigurationError

F32 = torch.float32


def _rdiv(a, t):
    """``a / t`` for a Python number ``a``, rounded once as JAX divides
    (``a / tensor`` in PyTorch multiplies by the reciprocal)."""
    return torch.full_like(t, a).div_(t)


def _floor_div(step, n):
    """``floor(step / n)`` for a whole-number step; exact, where a
    reciprocal product could fall just under a multiple of ``n``."""
    return torch.div(step, n, rounding_mode="floor")


def _pick(table, idx):
    """``table[idx]`` for a 0-d index tensor, on the device (indexing with
    a 0-d tensor would read it on the host)."""
    return table.index_select(0, idx.reshape(1).long()).reshape(())


# --------------------------------------------------------------------------- #
# Learning-rate schedules: functions of the 0-based step count
# --------------------------------------------------------------------------- #

class LearningRateSchedule:
    """``schedule(step, base_lr)``: ``step`` a 0-d fp32 tensor, the result
    a 0-d fp32 tensor on its device.  ``place(device)`` makes a
    schedule's constant tables there (the method's ``init_state`` calls
    it, so no table is copied from the host while a step is captured)."""

    def place(self, device):
        return self

    def __call__(self, step, base_lr):
        raise NotImplementedError(type(self).__name__)


class _Tabled(LearningRateSchedule):
    """A schedule with constant tables: ``_tables()`` gives them as
    ``{name: (values, dtype)}``, ``place`` copies them to a device once,
    ``_table(name, like)`` reads the copy on ``like``'s device."""

    def _tables(self):
        raise NotImplementedError

    def place(self, device):
        device = torch.device(device)
        placed = self.__dict__.setdefault("_placed", {})
        if device not in placed:
            placed[device] = {
                name: torch.as_tensor(values, dtype=dtype, device=device)
                for name, (values, dtype) in self._tables().items()}
        return self

    def _table(self, name, like):
        self.place(like.device)
        return self._placed[like.device][name]


class Default(LearningRateSchedule):
    """``lr / (1 + step * decay)`` (reference SGD.Default)."""

    def __init__(self, learning_rate_decay=0.0):
        self.decay = learning_rate_decay

    def __call__(self, step, base_lr):
        return _rdiv(base_lr, step * self.decay + 1.0)


class Step(LearningRateSchedule):
    """``lr * gamma^floor(step / step_size)`` (reference SGD.Step)."""

    def __init__(self, step_size, gamma):
        self.step_size, self.gamma = step_size, gamma

    def __call__(self, step, base_lr):
        return torch.pow(self.gamma, _floor_div(step, self.step_size)) \
            * base_lr


class MultiStep(_Tabled):
    """``lr * gamma^(milestones passed)`` (reference SGD.MultiStep)."""

    def __init__(self, step_sizes, gamma):
        self.step_sizes = [int(s) for s in step_sizes]
        self.gamma = gamma

    def _tables(self):
        return {"step_sizes": (self.step_sizes, torch.int32)}

    def __call__(self, step, base_lr):
        passed = (step >= self._table("step_sizes", step)).sum().to(F32)
        return torch.pow(self.gamma, passed) * base_lr


class Poly(LearningRateSchedule):
    """``lr * (1 - step / max_iteration)^power``, 0 past the end
    (reference SGD.Poly)."""

    def __init__(self, power, max_iteration):
        self.power, self.max_iteration = power, max_iteration

    def __call__(self, step, base_lr):
        frac = (step / self.max_iteration).clamp(0.0, 1.0)
        lr = torch.pow(1.0 - frac, self.power) * base_lr
        return torch.where(step > self.max_iteration, torch.zeros_like(lr),
                           lr)


class Exponential(LearningRateSchedule):
    """``lr * decay_rate^(step / decay_step)``, the exponent floored with
    ``stair_case`` (reference SGD.Exponential)."""

    def __init__(self, decay_step, decay_rate, stair_case=False):
        self.decay_step, self.decay_rate, self.stair_case = (
            decay_step, decay_rate, stair_case)

    def __call__(self, step, base_lr):
        e = _floor_div(step, self.decay_step) if self.stair_case \
            else step / self.decay_step
        return torch.pow(self.decay_rate, e) * base_lr


class NaturalExp(LearningRateSchedule):
    """``lr * exp(-gamma * floor(step / decay_step))``."""

    def __init__(self, decay_step, gamma):
        self.decay_step, self.gamma = decay_step, gamma

    def __call__(self, step, base_lr):
        return torch.exp(_floor_div(step, self.decay_step) * -self.gamma) \
            * base_lr


class EpochDecayWithWarmUp(_Tabled):
    """Linear warmup ``base_lr + delta * step`` for ``warmup_iteration``
    steps, then ``max_lr * 0.1^(decay epochs passed)`` (the ResNet-50
    large-batch recipe; the epoch is ``step // steps_per_epoch``)."""

    def __init__(self, warmup_iteration, warmup_delta, steps_per_epoch,
                 decay_epochs=(30, 60, 80)):
        self.warmup_iteration = warmup_iteration
        self.warmup_delta = warmup_delta
        self.steps_per_epoch = steps_per_epoch
        self.decay_epochs = [int(e) for e in decay_epochs]

    def _tables(self):
        return {"decay_epochs": (self.decay_epochs, torch.int32)}

    def __call__(self, step, base_lr):
        warm = step * self.warmup_delta + base_lr
        max_lr = base_lr + self.warmup_delta * self.warmup_iteration
        epoch = _floor_div(step, self.steps_per_epoch)
        decay = (epoch >= self._table("decay_epochs", step)).sum().to(F32)
        cooled = torch.pow(0.1, decay) * max_lr
        return torch.where(step < self.warmup_iteration, warm, cooled)


class EpochSchedule(_Tabled):
    """Per-epoch rates: ``regimes`` is ``[(start_epoch, end_epoch, lr)]``,
    1-based inclusive (reference SGD.EpochSchedule)."""

    def __init__(self, regimes, steps_per_epoch):
        self.starts = [float(r[0]) for r in regimes]
        self.lrs = [float(r[2]) for r in regimes]
        self.steps_per_epoch = steps_per_epoch

    def _tables(self):
        return {"starts": (self.starts, F32), "lrs": (self.lrs, F32)}

    def __call__(self, step, base_lr):
        epoch = _floor_div(step, self.steps_per_epoch) + 1.0
        idx = ((epoch >= self._table("starts", step)).sum() - 1).clamp(
            0, len(self.lrs) - 1)
        return _pick(self._table("lrs", step), idx)


class EpochDecay(_Tabled):
    """``lr * 0.1^decay_fn(epoch)``: the Python ``decay_fn`` tabulated over
    epochs 1..``max_epoch`` (reference SGD.EpochDecay)."""

    def __init__(self, decay_fn, steps_per_epoch, max_epoch=1000):
        self.table = [float(decay_fn(e)) for e in range(1, max_epoch + 1)]
        self.steps_per_epoch = steps_per_epoch

    def _tables(self):
        return {"table": (self.table, F32)}

    def __call__(self, step, base_lr):
        epoch = _floor_div(step, self.steps_per_epoch).clamp(
            0, len(self.table) - 1)
        return torch.pow(0.1, _pick(self._table("table", step), epoch)) \
            * base_lr


class EpochStep(LearningRateSchedule):
    """``lr * gamma^floor(epoch / step_size)`` (reference SGD.EpochStep)."""

    def __init__(self, step_size, gamma, steps_per_epoch):
        self.step_size, self.gamma = step_size, gamma
        self.steps_per_epoch = steps_per_epoch

    def __call__(self, step, base_lr):
        epoch = _floor_div(step, self.steps_per_epoch) + 1.0
        return torch.pow(self.gamma, _floor_div(epoch, self.step_size)) \
            * base_lr


class Plateau(LearningRateSchedule):
    """Reduce the rate when a monitored value stops improving (reference
    SGD.Plateau).  The factor lives in the method's state as a device
    ``lr_factor``; ``record(value, opt_state)`` runs on the host and
    writes a new factor into it in place, so a captured step reads it at
    its next replay."""

    stateful = True

    def __init__(self, monitor="Loss", factor=0.1, patience=10,
                 mode="min", epsilon=1e-4, cooldown=0, min_lr=0.0):
        if factor >= 1.0:
            raise ValueError("Plateau does not support a factor >= 1.0")
        if mode not in ("min", "max"):
            raise ValueError(f"Plateau mode must be 'min' or 'max', got "
                             f"{mode!r}")
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.epsilon = epsilon
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = None
        self.wait = 0
        self.cooldown_counter = 0

    def _improved(self, value):
        if self.best is None:
            return True
        if self.mode == "max":
            return value > self.best + self.epsilon
        return value < self.best - self.epsilon

    def record(self, value, opt_state):
        """Feed the monitored value; returns ``opt_state``, its
        ``lr_factor`` updated in place when the rate drops."""
        value = float(value)
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if self._improved(value):
            self.best = value
            self.wait = 0
            return opt_state
        if self.cooldown_counter > 0:
            return opt_state
        # the reference reduces only once the wait has ALREADY reached
        # patience, and only while the rate is above min_lr (+ epsilon)
        reduce_now = self.wait >= self.patience
        self.wait += 1
        if not reduce_now:
            return opt_state
        factor = opt_state.get("lr_factor")
        old = 1.0 if factor is None else float(factor)
        base = float(getattr(self, "base_lr", 1.0))
        if abs(old * base) <= self.min_lr + self.min_lr * 1e-4:
            return opt_state
        self.wait = 1
        self.cooldown_counter = self.cooldown
        new = max(old * self.factor, self.min_lr / max(base, 1e-30))
        if factor is None:
            opt_state["lr_factor"] = torch.full(
                (), new, dtype=F32, device=opt_state["neval"].device)
        else:
            factor.fill_(new)
        return opt_state

    def __call__(self, step, base_lr):
        self.base_lr = base_lr          # for record's min_lr clamp
        return torch.full_like(step, base_lr)


class Warmup(LearningRateSchedule):
    """``base_lr + step * delta`` (reference SGD.Warmup)."""

    def __init__(self, delta):
        self.delta = delta

    def __call__(self, step, base_lr):
        return step * self.delta + base_lr


class SequentialSchedule(LearningRateSchedule):
    """Schedules in turn, each for ``max_iteration`` steps counted from
    its own start (reference SGD.SequentialSchedule)."""

    def __init__(self):
        self.schedules = []
        self.durations = []

    def add(self, schedule, max_iteration):
        self.schedules.append(schedule)
        self.durations.append(max_iteration)
        return self

    def place(self, device):
        for s in self.schedules:
            s.place(device)
        return self

    def __call__(self, step, base_lr):
        result, offset = None, 0
        for sched, dur in zip(self.schedules, self.durations):
            candidate = sched((step - offset).clamp(0, dur), base_lr)
            result = candidate if result is None else torch.where(
                step >= offset, candidate, result)
            offset += dur
        return torch.full_like(step, base_lr) if result is None else result


# --------------------------------------------------------------------------- #
# Parameter trees: a dict of tensors or one tensor
# --------------------------------------------------------------------------- #

def _each(params, *trees):
    """``(param, leaf of each tree)`` for every parameter, in ``params``'
    order."""
    if isinstance(params, dict):
        for k, p in params.items():
            yield (p, *(t[k] for t in trees))
    else:
        yield (params, *trees)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: fn(p) for k, p in tree.items()}
    return fn(tree)


def _zeros_like(tree):
    return _map(torch.zeros_like, tree)


def _device(tree):
    leaves = list(tree.values()) if isinstance(tree, dict) else [tree]
    return leaves[0].device if leaves else torch.device("cpu")


def _decayed(lr, decay, step):
    """``lr / (1 + neval * decay)`` on the device, as the JAX methods
    compute it."""
    return Default(decay)(step, lr)


# --------------------------------------------------------------------------- #
# Methods
# --------------------------------------------------------------------------- #

class OptimMethod:
    """Base: the state is a dict that holds ``neval``.  ``state`` on the
    instance, ``None`` until set, is where ``Optimizer.optimize()`` starts
    from and leaves its final state (``load_jax_opt_state`` fills it)."""

    learning_rate: float = 1e-3
    state = None
    #: the per-parameter state trees the method keeps
    slots = ()

    def init_state(self, params):
        device = _device(params)
        schedule = getattr(self, "schedule", None)
        if schedule is not None:
            schedule.place(device)
        return {"neval": torch.zeros((), dtype=torch.int32, device=device)}

    def update(self, grads, state, params):
        raise NotImplementedError(type(self).__name__)

    def optimize(self, feval, x):
        """The reference's single-tensor facade: ``feval(x) -> (loss,
        grad)``; updates ``x`` in place and returns ``(x, loss)``."""
        loss, grad = feval(x)
        if getattr(self, "_state", None) is None:
            self._state = self.init_state(x)
        new_x, self._state = self.update(grad, self._state, x)
        return new_x, loss

    def get_learning_rate(self, state):
        return torch.full((), self.learning_rate, dtype=F32,
                          device=state["neval"].device)

    def _init_slots(self, params, **fills):
        """``init_state`` plus one tree per slot: zeros, or the fill
        value given for it."""
        state = OptimMethod.init_state(self, params)
        for slot in self.slots:
            if slot in fills:
                state[slot] = _map(
                    lambda p, v=fills[slot]: torch.full_like(p, v), params)
            else:
                state[slot] = _zeros_like(params)
        return state


class SGD(OptimMethod):
    """SGD with momentum, dampening, nesterov and weight decay, and a
    learning-rate schedule (``Default(learning_rate_decay)`` unless one is
    given)."""

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
        self.schedule = learning_rate_schedule or Default(learning_rate_decay)

    @property
    def slots(self):
        return ("velocity",) if self.momentum > 0 else ()

    def init_state(self, params):
        state = self._init_slots(params)
        if getattr(self.schedule, "stateful", False):
            state["lr_factor"] = torch.ones((), dtype=F32,
                                            device=_device(params))
        return state

    def get_learning_rate(self, state):
        lr = self.schedule(state["neval"].to(F32), self.learning_rate)
        if "lr_factor" in state:
            lr = lr * state["lr_factor"]
        return lr

    @torch.no_grad()
    def update(self, grads, state, params):
        lr = self.get_learning_rate(state)
        wd, mu, damp = self.weight_decay, self.momentum, self.dampening
        vel = state["velocity"] if mu > 0 else None
        for p, g, *v in _each(params, grads, *([vel] if mu > 0 else [])):
            if wd != 0:
                g = g + wd * p
            if mu > 0:
                v[0].mul_(mu).add_(g, alpha=1 - damp)
                g = g + mu * v[0] if self.nesterov else v[0]
            p.sub_(lr * g)
        state["neval"].add_(1)
        return params, state


class Adam(OptimMethod):
    """Adam with bias correction and ``learning_rate_decay``: the step's
    learning rate uses ``neval`` before the increment and the bias
    correction ``t = neval + 1``."""

    slots = ("m", "v")

    def __init__(self, learning_rate=1e-3, learning_rate_decay=0.0,
                 beta1=0.9, beta2=0.999, epsilon=1e-8, weight_decay=0.0):
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.weight_decay = weight_decay

    def init_state(self, params):
        return self._init_slots(params)

    def get_learning_rate(self, state):
        return _decayed(self.learning_rate, self.learning_rate_decay,
                        state["neval"].to(F32))

    @torch.no_grad()
    def update(self, grads, state, params):
        step = state["neval"].to(F32)
        lr = _decayed(self.learning_rate, self.learning_rate_decay, step)
        b1, b2 = self.beta1, self.beta2
        bc1 = 1.0 - torch.pow(b1, step + 1.0)
        bc2 = 1.0 - torch.pow(b2, step + 1.0)
        for p, g, m, v in _each(params, grads, state["m"], state["v"]):
            if self.weight_decay != 0:
                g = g + self.weight_decay * p
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            # p - lr * (m / bc1) / (sqrt(v / bc2) + eps)
            p.sub_(lr * (m / bc1) / ((v / bc2).sqrt_().add_(self.epsilon)))
        state["neval"].add_(1)
        return params, state


class Adagrad(OptimMethod):
    """``accum += g^2``; ``p -= lr * g / (sqrt(accum) + 1e-10)`` with the
    decayed rate (reference Adagrad)."""

    slots = ("accum",)

    def __init__(self, learning_rate=1e-3, learning_rate_decay=0.0,
                 weight_decay=0.0):
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.weight_decay = weight_decay

    def init_state(self, params):
        return self._init_slots(params)

    def get_learning_rate(self, state):
        return _decayed(self.learning_rate, self.learning_rate_decay,
                        state["neval"].to(F32))

    @torch.no_grad()
    def update(self, grads, state, params):
        lr = self.get_learning_rate(state)
        for p, g, a in _each(params, grads, state["accum"]):
            if self.weight_decay != 0:
                g = g + self.weight_decay * p
            a.addcmul_(g, g)
            p.sub_(lr * g / (a.sqrt() + 1e-10))
        state["neval"].add_(1)
        return params, state


class Adadelta(OptimMethod):
    """Adadelta with decay ``rho`` and ``epsilon``; the step uses the
    squared-update average from before it (reference Adadelta)."""

    slots = ("accum_g", "accum_dx")

    def __init__(self, decay_rate=0.9, epsilon=1e-10):
        self.rho, self.epsilon = decay_rate, epsilon
        self.learning_rate = 1.0

    def init_state(self, params):
        return self._init_slots(params)

    @torch.no_grad()
    def update(self, grads, state, params):
        rho, eps = self.rho, self.epsilon
        for p, g, ag, adx in _each(params, grads, state["accum_g"],
                                   state["accum_dx"]):
            ag.mul_(rho).add_(g * g, alpha=1 - rho)
            delta = g * (adx + eps).sqrt() / (ag + eps).sqrt()
            adx.mul_(rho).add_(delta * delta, alpha=1 - rho)
            p.sub_(delta)
        state["neval"].add_(1)
        return params, state


class RMSprop(OptimMethod):
    """``accum = rho * accum + (1 - rho) g^2``; ``p -= lr * g /
    (sqrt(accum) + eps)`` with the decayed rate (reference RMSprop)."""

    slots = ("accum",)

    def __init__(self, learning_rate=1e-2, learning_rate_decay=0.0,
                 decay_rate=0.99, epsilon=1e-8):
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.rho, self.epsilon = decay_rate, epsilon

    def init_state(self, params):
        return self._init_slots(params)

    def get_learning_rate(self, state):
        return _decayed(self.learning_rate, self.learning_rate_decay,
                        state["neval"].to(F32))

    @torch.no_grad()
    def update(self, grads, state, params):
        lr = self.get_learning_rate(state)
        for p, g, a in _each(params, grads, state["accum"]):
            a.mul_(self.rho).add_(g * g, alpha=1 - self.rho)
            p.sub_(lr * g / (a.sqrt() + self.epsilon))
        state["neval"].add_(1)
        return params, state


class Adamax(OptimMethod):
    """Adam with the infinity norm: ``u = max(b2 u, |g| + eps)``, ``p -=
    lr / (1 - b1^t) * m / u`` (reference Adamax)."""

    slots = ("m", "u")

    def __init__(self, learning_rate=2e-3, beta1=0.9, beta2=0.999,
                 epsilon=1e-38):
        self.learning_rate = learning_rate
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_state(self, params):
        return self._init_slots(params)

    @torch.no_grad()
    def update(self, grads, state, params):
        b1, b2 = self.beta1, self.beta2
        t = state["neval"].to(F32) + 1.0
        lr_t = _rdiv(self.learning_rate, 1.0 - torch.pow(b1, t))
        for p, g, m, u in _each(params, grads, state["m"], state["u"]):
            m.mul_(b1).add_(g, alpha=1 - b1)
            torch.maximum(u.mul_(b2), g.abs() + self.epsilon, out=u)
            p.sub_(lr_t * m / u)
        state["neval"].add_(1)
        return params, state


class Ftrl(OptimMethod):
    """FTRL-proximal with L1, L2 and L2-shrinkage (reference Ftrl)."""

    slots = ("accum", "linear")

    def __init__(self, learning_rate=1e-3, learning_rate_power=-0.5,
                 initial_accumulator_value=0.1, l1_regularization_strength=0.0,
                 l2_regularization_strength=0.0,
                 l2_shrinkage_regularization_strength=0.0):
        self.learning_rate = learning_rate
        self.lr_power = learning_rate_power
        self.init_accum = initial_accumulator_value
        self.l1 = l1_regularization_strength
        self.l2 = l2_regularization_strength
        self.l2_shrinkage = l2_shrinkage_regularization_strength

    def init_state(self, params):
        return self._init_slots(params, accum=self.init_accum)

    @torch.no_grad()
    def update(self, grads, state, params):
        lr, lrp = self.learning_rate, self.lr_power
        for p, g, n, z in _each(params, grads, state["accum"],
                                state["linear"]):
            n_new = n + g * g
            sigma = (n_new.pow(-lrp) - n.pow(-lrp)) / lr
            z.add_(g + 2 * self.l2_shrinkage * p).sub_(sigma * p)
            n.copy_(n_new)
            shrunk = -(z - torch.sign(z) * self.l1) \
                / (n_new.pow(-lrp) / lr + 2 * self.l2)
            p.copy_(torch.where(z.abs() > self.l1, shrunk,
                                torch.zeros_like(shrunk)))
        state["neval"].add_(1)
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
    scale = _rdiv(max_norm, norm.clamp_min(1e-12)).clamp_max(1.0)
    for g in grads.values():
        g.mul_(scale.to(g.dtype))
    return grads


class ParallelAdam(Adam):
    """Adam under the reference's name (reference ParallelAdam: a
    thread-pool Adam over parameter chunks); the same update."""


def ravel_order(names):
    """The order ``jax.flatten_util.ravel_pytree`` lays a parameter tree
    out in: dict keys sorted at every level, which is the names of
    ``named_parameters()`` sorted by their dotted parts."""
    return sorted(names, key=lambda n: tuple(n.split(".")))


class Fused(OptimMethod):
    """An elementwise method run over ONE flat fp32 vector: the
    parameters (and the gradients) in ``ravel_pytree``'s order
    (``ravel_order``), so the state is JAX's flat one and a JAX ``Fused``
    state loads by position.  Each update gathers the parameters and the
    gradients into flat vectors, updates the flat parameters in place and
    copies them back into the parameters."""

    _ELEMENTWISE = ()  # filled below, after the classes exist

    def __init__(self, inner):
        if not isinstance(inner, Fused._ELEMENTWISE):
            raise TypeError(
                f"Fused requires an elementwise OptimMethod, got "
                f"{type(inner).__name__}")
        self.inner = inner

    @property
    def slots(self):
        return self.inner.slots

    def init_state(self, params):
        if not isinstance(params, dict):
            params = {"": params}
        dtypes = {p.dtype for p in params.values()}
        if len(dtypes) > 1:
            raise TypeError(
                f"Fused requires a uniform param dtype, got {dtypes}; "
                "mixed-precision master params should be uniform fp32")
        n = sum(p.numel() for p in params.values())
        return self.inner.init_state(torch.zeros(
            n, dtype=dtypes.pop() if dtypes else F32,
            device=_device(params)))

    @torch.no_grad()
    def update(self, grads, state, params):
        if not isinstance(params, dict):
            params, grads = {"": params}, {"": grads}
        keys = ravel_order(params)
        flat_p = torch.cat([params[k].reshape(-1) for k in keys])
        flat_g = torch.cat([grads[k].reshape(-1) for k in keys]).to(
            flat_p.dtype)
        self.inner.update(flat_g, state, flat_p)
        dst = [params[k] for k in keys]
        src = torch.split(flat_p, [p.numel() for p in dst])
        torch._foreach_copy_(dst, [s.view(p.shape) for s, p in zip(src, dst)])
        return params if "" not in params else params[""], state

    def get_learning_rate(self, state):
        return self.inner.get_learning_rate(state)

    @property
    def learning_rate(self):
        return self.inner.learning_rate

    @learning_rate.setter
    def learning_rate(self, lr):
        self.inner.learning_rate = lr

    @property
    def schedule(self):
        return getattr(self.inner, "schedule", None)


Fused._ELEMENTWISE = (SGD, Adam, Adagrad, Adadelta, RMSprop, Adamax, Ftrl)


# --------------------------------------------------------------------------- #
# One method per submodule (reference Optimizer.setOptimMethods)
# --------------------------------------------------------------------------- #

def subtree(tree, path):
    """The part of a ``{name: tensor}`` tree under ``path`` (a tuple of
    keys): the tensor itself where ``path`` names a parameter, as the JAX
    subtree is its leaf, else the entries below it, under their full
    names."""
    prefix = ".".join(path)
    if prefix in tree:
        return tree[prefix]
    return {k: v for k, v in tree.items() if k.startswith(prefix + ".")}


def _leaf_count(tree):
    return len(tree) if isinstance(tree, dict) else 1


class CompositeOptimMethod(OptimMethod):
    """One method per parameter subtree (reference
    Optimizer.setOptimMethods).  ``assignments``: ``(name, path,
    method)``, ``path`` a tuple of parameter-tree keys; the state is
    ``{"/".join(path): that method's state}``.  Build it from submodule
    names with ``build_composite_method``, which holds the reference's
    checks."""

    def __init__(self, assignments):
        self.assignments = [(n, tuple(p), m) for n, p, m in assignments]

    def init_state(self, params):
        return {"/".join(p): m.init_state(subtree(params, p))
                for _, p, m in self.assignments}

    @torch.no_grad()
    def update(self, grads, state, params):
        for _, path, method in self.assignments:
            method.update(subtree(grads, path), state["/".join(path)],
                          subtree(params, path))
        return params, state

    def get_learning_rate(self, state):
        """The first assignment's rate; ``learning_rates`` gives each."""
        _, path, method = self.assignments[0]
        return method.get_learning_rate(state["/".join(path)])

    def learning_rates(self, state):
        """``{submodule name: rate}``, for per-assignment summaries."""
        return {n: m.get_learning_rate(state["/".join(p)])
                for n, p, m in self.assignments}


def build_composite_method(model, params, methods):
    """Resolve ``{submodule name: method}`` against ``model``, whose
    ``params`` are ``dict(model.named_parameters())``.  The reference's
    checks: every name resolves to exactly one submodule with trainable
    parameters, the subtrees are disjoint, and together they cover every
    parameter."""
    assignments = []
    for name, method in methods.items():
        sched = getattr(method, "schedule", None)
        if sched is not None and hasattr(sched, "record"):
            raise ConfigurationError(
                "set_optim_methods: a Plateau-style schedule inside a "
                f"per-submodule method ({name!r}) would never receive "
                "the monitored metric (the driver feeds the TOP-LEVEL "
                "method's schedule only); attach Plateau to a single "
                "global method instead")
        paths = [tuple(q.split(".")) for q, m in model.named_modules()
                 if q and str(getattr(m, "name", "")) == name
                 and _leaf_count(subtree(params, tuple(q.split("."))))]
        if not paths:
            raise ConfigurationError(
                f"set_optim_methods: no submodule named {name!r} in "
                f"{type(model).__name__} (name= your layers at "
                "construction)")
        if len(paths) > 1:
            raise ConfigurationError(
                f"set_optim_methods: {name!r} is ambiguous "
                f"({len(paths)} submodules carry that name)")
        sub = subtree(params, paths[0])
        leaves = sub.values() if isinstance(sub, dict) else [sub]
        if not any(t.is_floating_point() for t in leaves):
            raise ConfigurationError(
                f"set_optim_methods: {name!r} has no trainable "
                "parameters")
        assignments.append((name, paths[0], method))

    for i, (_, a, _) in enumerate(assignments):
        for _, b, _ in assignments[i + 1:]:
            if a[:len(b)] == b or b[:len(a)] == a:
                raise ConfigurationError(
                    f"set_optim_methods: subtrees {'/'.join(a)} and "
                    f"{'/'.join(b)} overlap")

    covered = sum(_leaf_count(subtree(params, p)) for _, p, _ in assignments)
    if covered != len(params):
        raise ConfigurationError(
            f"set_optim_methods: the named submodules cover {covered} of "
            f"{len(params)} parameter leaves; every trainable submodule "
            "needs a method (an uncovered subtree would silently never "
            "train)")
    return CompositeOptimMethod(assignments)


__all__ = ["Adadelta", "Adagrad", "Adam", "Adamax", "CompositeOptimMethod",
           "Default", "EpochDecay", "EpochDecayWithWarmUp", "EpochSchedule",
           "EpochStep", "Exponential", "Ftrl", "Fused",
           "LearningRateSchedule", "MultiStep", "NaturalExp", "OptimMethod",
           "ParallelAdam", "Plateau", "Poly", "RMSprop", "SGD",
           "SequentialSchedule", "Step", "Warmup", "build_composite_method",
           "clip_by_global_norm", "clip_by_value", "global_sq_norm",
           "ravel_order", "subtree"]
