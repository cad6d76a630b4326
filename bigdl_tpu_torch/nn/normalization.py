"""Normalization and regularization layers (counterpart of
``bigdl_tpu/nn/normalization.py``).

``LayerNorm`` (:112) and ``BatchNormalization`` (:69-103) follow the JAX
statistics exactly: fp32 ``E[x]`` and ``E[x^2]`` (computed in fp32
whatever the input's dtype), the variance ``E[x^2] - E[x]^2`` clamped at
0, and the normalisation in the input's dtype.  That is not
``F.layer_norm`` / ``F.batch_norm`` (other eps, a two-pass variance).

BatchNorm's running statistics are buffers under the JAX state keys
(``running_mean``, ``running_var``), updated in place in training mode
with the unbiased batch variance, ``(1 - momentum) * running + momentum *
batch``, so a captured step updates them at every replay; a
rematerialised recompute leaves them alone (``nn.module.frozen_state``).

SyncBN (``sync_batchnorm``, :24): inside the context a BatchNorm layer in
training mode pools its fp32 moments over the ranks of a process group
(``PMean``, whose gradient is a ``pmean`` too, as JAX differentiates
``lax.pmean``), and counts ``n * world`` values, so a data-parallel step
normalizes with the global batch's statistics.
"""

import contextlib

import torch

from bigdl_tpu_torch.nn import dropout as _dropout
from bigdl_tpu_torch.nn.module import Module, state_updates

#: the collectives BatchNorm pools its moments over, while a
#: ``sync_batchnorm`` context is open (None: per-rank statistics)
_SYNC = None


@contextlib.contextmanager
def sync_batchnorm(axis="data"):
    """Within this context BatchNormalization layers in training mode
    normalize with statistics pooled over the ranks (SyncBN).  ``axis``
    is a ``parallel.collectives.Collectives``, a process group, or a
    mesh axis name, which means the default group
    (``utils.engine.Engine.mesh()``, a world of one when none is
    initialized)."""
    from bigdl_tpu_torch.parallel.collectives import Collectives

    global _SYNC
    if not isinstance(axis, Collectives):
        if isinstance(axis, str):
            from bigdl_tpu_torch.utils.engine import Engine

            axis = Engine.mesh()
        axis = Collectives(axis)
    prev, _SYNC = _SYNC, axis
    try:
        yield axis
    finally:
        _SYNC = prev


class _Moments(torch.autograd.Function):
    """``(E[x], E[x^2])`` over ``dims`` in fp32 (fp64 for fp64 inputs),
    ``x`` of any float dtype.  The fp32 copy of ``x`` lives only inside
    the forward; the backward recomputes ``2 x / n`` from the saved
    input, as ``jax.grad`` of the two means gives it."""

    @staticmethod
    def forward(ctx, x, dims):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        ctx.save_for_backward(x)
        ctx.dims = dims
        return xf.mean(dim=dims), xf.square().mean(dim=dims)

    @staticmethod
    def backward(ctx, g_mean, g_sq):
        x, = ctx.saved_tensors
        n = 1
        for d in ctx.dims:
            n *= x.shape[d]
        shape = [1 if d in ctx.dims or d - x.dim() in ctx.dims else s
                 for d, s in enumerate(x.shape)]
        acc = torch.promote_types(x.dtype, torch.float32)
        g = torch.zeros((), dtype=acc, device=x.device)
        if g_sq is not None:
            g = x.to(acc) * (2.0 * g_sq / n).reshape(shape)
        if g_mean is not None:
            g = g + (g_mean / n).reshape(shape)
        return g.to(x.dtype).expand_as(x), None


def batch_norm_affine(x, mean, var, weight, bias, eps):
    """``x * scale + shift`` in ``x``'s dtype, the per-channel (last axis)
    scale and shift formed from the statistics as JAX forms them
    (``nn/normalization.py:97-102``); ``weight`` and ``bias`` None without
    affine parameters.  K7 (``ops/bn_act.py``) rounds as these operations
    do."""
    inv = torch.rsqrt(var + eps)
    scale, shift = inv, -mean * inv
    if weight is not None:
        scale = scale * weight
        shift = shift * weight + bias
    return x * scale.to(x.dtype) + shift.to(x.dtype)


class BatchNormalization(Module):
    """Batch norm over ``(N, C)`` inputs; ``weight`` / ``bias`` (affine) are
    parameters, ``running_mean`` / ``running_var`` the state."""

    reduce_axes = (0,)

    def __init__(self, n_output, eps=1e-5, momentum=0.1, affine=True,
                 name=None):
        super().__init__(name)
        self.n_output = n_output
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        if affine:
            self.weight = torch.nn.Parameter(torch.ones(n_output))
            self.bias = torch.nn.Parameter(torch.zeros(n_output))
        else:
            self.weight = self.bias = None
        self.register_buffer("running_mean", torch.zeros(n_output))
        self.register_buffer("running_var", torch.ones(n_output))

    #: JAX's parameter entry of a layer without parameters: ``{}`` here
    #: (its setup returns a dict), ``()`` for other layers
    @property
    def jax_empty_params(self):
        return {}

    def forward(self, x):
        if self.training:
            mean, sq = _Moments.apply(x, self.reduce_axes)
            n = x.numel() // x.shape[-1]
            if _SYNC is not None:
                from bigdl_tpu_torch.parallel.collectives import PMean

                mean = PMean.apply(mean, _SYNC)
                sq = PMean.apply(sq, _SYNC)
                n *= _SYNC.world
            var = torch.clamp_min(sq - mean.square(), 0.0)
            if state_updates():
                with torch.no_grad():
                    m = self.momentum
                    unbiased = var * n / max(n - 1, 1)
                    self.running_mean.copy_(
                        (1 - m) * self.running_mean + m * mean)
                    self.running_var.copy_(
                        (1 - m) * self.running_var + m * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        return batch_norm_affine(x, mean, var, self.weight, self.bias,
                                 self.eps)


class SpatialBatchNormalization(BatchNormalization):
    """Batch norm over NHWC images, per channel."""

    reduce_axes = (0, 1, 2)


class LayerNorm(Module):
    def __init__(self, n_output: int, eps: float = 1e-6, name=None):
        super().__init__(name)
        self.n_output = int(n_output)
        self.eps = eps
        self.weight = torch.nn.Parameter(torch.ones(self.n_output))
        self.bias = torch.nn.Parameter(torch.zeros(self.n_output))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        sq = xf.square().mean(dim=-1, keepdim=True)
        var = (sq - mean.square()).clamp_min(0.0)
        inv = torch.rsqrt(var + self.eps)
        dt = x.dtype
        y = (x - mean.to(dt)) * inv.to(dt)
        return y * self.weight.to(dt) + self.bias.to(dt)


class RMSNorm(Module):
    """RMS norm over the last dim (fp32 mean of squares)."""

    def __init__(self, n_output, eps=1e-6, name=None):
        super().__init__(name)
        self.n_output = n_output
        self.eps = eps
        self.weight = torch.nn.Parameter(torch.ones(n_output))

    def forward(self, x):
        sq = x.float().square().mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(sq + self.eps).to(x.dtype)
        return x * inv * self.weight.to(x.dtype)


class Dropout(Module):
    """Inverted dropout (scales the kept elements by ``1 / (1 - p)``) in
    training.  JAX draws the mask from the step's ``rng``; here it is
    ``nn.dropout``'s hash of the step's key, this layer's salt (a hash of
    its path in the model, set by the train step) and the element, so a
    layer draws a mask only inside a training step, as JAX draws none
    without an ``rng``, and a recompute draws the same one."""

    def __init__(self, init_p=0.5, name=None):
        super().__init__(name)
        self.p = init_p
        self.dropout_salt = 0

    salt_by_path = True

    @property
    def dropout(self):
        """The drop rate (``nn.dropout.uses_dropout`` reads it)."""
        return self.p

    def forward(self, x):
        if not self.training:
            return x
        return _dropout.dropout(x, self.p, self.dropout_salt)


class SpatialCrossMapLRN(Module):
    """Local response normalization across channels (the last axis in
    NHWC): ``x / (k + alpha / size * sum of x^2 over the window) ^
    beta`` in fp32, the window ``size`` channels wide, centred."""

    def __init__(self, size=5, alpha=1.0, beta=0.75, k=1.0,
                 data_format="NHWC", name=None):
        super().__init__(name)
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k
        self.data_format = data_format

    def forward(self, x):
        if self.data_format == "NCHW":
            x = x.permute(0, 2, 3, 1)
        half = (self.size - 1) // 2
        sq = torch.nn.functional.pad(x.float().square(),
                                     (half, self.size - 1 - half))
        window_sum = sq.unfold(-1, self.size, 1).sum(-1)
        denom = torch.pow(self.k + self.alpha / self.size * window_sum,
                          self.beta)
        y = (x.float() / denom).to(x.dtype)
        if self.data_format == "NCHW":
            y = y.permute(0, 3, 1, 2)
        return y


class Normalize(Module):
    """L_p normalisation over the last dim: ``x / (||x||_p + eps)``."""

    def __init__(self, p=2.0, eps=1e-10, name=None):
        super().__init__(name)
        self.p = p
        self.eps = eps

    def forward(self, x):
        if self.p == float("inf"):
            norm = torch.abs(x).amax(dim=-1, keepdim=True)
        else:
            norm = torch.pow(torch.pow(torch.abs(x), self.p)
                             .sum(dim=-1, keepdim=True), 1.0 / self.p)
        return x / (norm + self.eps)
