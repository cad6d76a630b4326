"""The fused eval plan of an int8 twin: BatchNorm, the residual add and
ReLU through one K7 launch (``ops/bn_act.py``) a site.

``quantize_model`` and ``quantize()`` give each ``Sequential`` of the
model they produce a ``Plan`` (``attach``), kept in the container's
``__dict__`` beside its modules, outside the parameters and the state: the
parameter and state trees, their keys, the JAX bridge, checkpoints and
``model_bytes`` do not see it, and a copy of the model (``copy.deepcopy``,
pickling) starts with an empty plan that the next eval forward rebuilds
from the children, as ``_PackedWeight`` is rebuilt.  In eval mode such a
``Sequential`` runs its children through the plan's steps; in training
mode, and in any model without a plan (fp32 and bf16 models), it runs its
modules as before.

The plan matches, from the module structure alone:

- a ``BatchNormalization`` (``[BatchNormalization, ReLU]`` takes the
  ReLU too): one K7 launch;
- a residual block's tail, ``[ConcatTable(main, shortcut), CAddTable]``
  (and a ``ReLU`` after it), where ``main`` is a ``Sequential`` ending in
  a ``BatchNormalization``: ``main`` runs up to that BatchNorm, the
  shortcut up to its own last BatchNorm (folded into the launch) or whole
  (an ``Identity``, or a shortcut with no BatchNorm at its end), and one
  K7 launch finishes the block.  The two branches run inside
  ``act_quant.quantize_once()``, so a downsampling block's two
  convolutions share the quantization of the block's input;
- anything else runs as its module (a convolution stays a module call:
  its hooks fire).

Every K7 launch leaves its output's absmax for K6q's given route.  A site
runs as its modules instead only where a module of it has hooks
(``site_counts`` counts it unfused): the route is chosen from the module
structure alone.  A tensor K7 does not take on the card (not contiguous,
not fp32 or bf16, its last axis not the BatchNorm's channels) makes the
launch raise.  On the CPU the plan runs K7's plain version, so its output
is bitwise the unfused model's.
"""

import contextlib
import weakref

from bigdl_tpu_torch.nn.activations import ReLU
from bigdl_tpu_torch.nn.containers import CAddTable, ConcatTable, Sequential
from bigdl_tpu_torch.nn.module import Identity
from bigdl_tpu_torch.nn.normalization import BatchNormalization

_enabled = True


@contextlib.contextmanager
def unfused():
    """Within the block every plan runs its modules (the reference the
    fused twin is held against)."""
    global _enabled
    outer, _enabled = _enabled, False
    try:
        yield
    finally:
        _enabled = outer


class Plan:
    """The steps of one ``Sequential``, built at its first eval forward
    and again when its children change or another container holds the
    same plan (a shallow copy, as ``ScanLayers``' layer views are); a copy
    starts empty."""

    def __init__(self):
        self.steps = self.owner = self.children = None

    def build(self, container):
        children = tuple(container._modules.values())
        if self.steps is None or self.owner() is not container or \
                len(children) != len(self.children) or \
                any(a is not b for a, b in zip(children, self.children)):
            self.steps = _steps(list(children))
            self.owner = weakref.ref(container)
            self.children = children
        return self.steps

    def run(self, container, x):
        return _run(self.build(container), x)

    def __deepcopy__(self, memo):
        return Plan()

    def __reduce__(self):
        return Plan, ()


def attach(model):
    """Give every ``Sequential`` of ``model`` an empty plan."""
    for m in model.modules():
        if type(m) is Sequential:
            m.__dict__["_fused_plan"] = Plan()
    return model


def plan_of(container):
    """The container's plan where it runs now (a ``Sequential`` with a
    plan, in eval mode, plans enabled), else None."""
    plan = container.__dict__.get("_fused_plan")
    if plan is None or container.training or not _enabled:
        return None
    return plan


def _hooked(*mods):
    return any(m._forward_hooks or m._forward_pre_hooks
               for m in mods if m is not None)


def _run(steps, x):
    for step in steps:
        x = step(x)
    return x


class _Module:
    def __init__(self, module):
        self.module = module

    def __call__(self, x):
        return self.module(x)

    def visit(self, counts, visit_module):
        visit_module(self.module)


class _BnAct:
    """``[BatchNormalization(, ReLU)]``: one K7 launch."""

    def __init__(self, bn, relu):
        self.bn, self.relu = bn, relu

    def modules(self):
        return [m for m in (self.bn, self.relu) if m is not None]

    def __call__(self, x):
        from bigdl_tpu_torch.ops.bn_act import bn_act

        if _hooked(*self.modules()):
            return _run([_Module(m) for m in self.modules()], x)
        return bn_act(x, self.bn, relu=self.relu is not None, absmax=True)

    def visit(self, counts, visit_module):
        counts["unfused_sites" if _hooked(*self.modules())
               else "fused_sites"] += 1


class _Tail:
    """``[ConcatTable(main, shortcut), CAddTable(, ReLU)]``: both branches
    up to their last BatchNorm, then one K7 launch."""

    def __init__(self, concat, cadd, relu):
        self.concat, self.cadd, self.relu = concat, cadd, relu
        self.main_seq, self.short_seq = concat._modules.values()
        main = list(self.main_seq._modules.values())
        self.main, self.main_bn = _steps(main[:-1]), main[-1]
        short = list(self.short_seq._modules.values())
        self.short_bn = None
        if type(self.short_seq) is Sequential and short and \
                isinstance(short[-1], BatchNormalization):
            self.short, self.short_bn = _steps(short[:-1]), short[-1]
        elif type(self.short_seq) is Identity:
            self.short = []
        else:
            self.short = [_Module(self.short_seq)]

    def modules(self):
        """The modules whose calls the fused site replaces (a hook on any
        of them sends the block to its modules)."""
        return [m for m in (self.concat, self.cadd, self.relu, self.main_seq,
                            self.main_bn, self.short_bn) if m is not None] \
            + ([self.short_seq] if self.short_bn is not None or
               type(self.short_seq) is Identity else [])

    def unfused(self):
        return [m for m in (self.concat, self.cadd, self.relu)
                if m is not None]

    def __call__(self, x):
        from bigdl_tpu_torch.ops.act_quant import quantize_once
        from bigdl_tpu_torch.ops.bn_act import bn_act

        if _hooked(*self.modules()):
            return _run([_Module(m) for m in self.unfused()], x)
        with quantize_once():
            h = _run(self.main, x)
            r = _run(self.short, x)
        return bn_act(h, self.main_bn, residual=r, residual_bn=self.short_bn,
                      relu=self.relu is not None, absmax=True)

    def visit(self, counts, visit_module):
        if _hooked(*self.modules()):
            for m in self.unfused():
                visit_module(m)
            return
        for step in self.main + self.short:
            step.visit(counts, visit_module)
        counts["fused_sites"] += 1


def _tail_at(modules, i):
    """The tail starting at ``modules[i]``, or None."""
    if i + 1 >= len(modules) or type(modules[i]) is not ConcatTable or \
            type(modules[i + 1]) is not CAddTable:
        return None
    branches = list(modules[i]._modules.values())
    if len(branches) != 2:
        return None
    main = list(branches[0]._modules.values())
    if type(branches[0]) is not Sequential or not main or \
            not _is_bn(main[-1]):
        return None
    relu = modules[i + 2] if i + 2 < len(modules) and \
        type(modules[i + 2]) is ReLU else None
    return _Tail(modules[i], modules[i + 1], relu)


def _is_bn(m):
    from bigdl_tpu_torch.ops.bn_act import MAX_CHANNELS

    return isinstance(m, BatchNormalization) and m.n_output <= MAX_CHANNELS


def _steps(modules):
    steps, i = [], 0
    while i < len(modules):
        m = modules[i]
        tail = _tail_at(modules, i)
        if tail is not None:
            steps.append(tail)
            i += 2 + (tail.relu is not None)
        elif _is_bn(m):
            relu = modules[i + 1] if i + 1 < len(modules) and \
                type(modules[i + 1]) is ReLU else None
            steps.append(_BnAct(m, relu))
            i += 1 + (relu is not None)
        else:
            steps.append(_Module(m))
            i += 1
    return steps


def site_counts(model):
    """``{"fused_sites": K7 launches of one eval forward, "unfused_sites":
    BatchNorm modules it runs as modules}`` from the model's structure
    and hooks."""
    counts = {"fused_sites": 0, "unfused_sites": 0}

    def visit_module(m):
        plan = m.__dict__.get("_fused_plan")
        if plan is not None:
            for step in plan.build(m):
                step.visit(counts, visit_module)
        elif isinstance(m, BatchNormalization):
            counts["unfused_sites"] += 1
        else:
            for child in m.children():
                visit_module(child)

    visit_module(model)
    return counts
