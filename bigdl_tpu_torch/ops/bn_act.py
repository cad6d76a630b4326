"""Eval-mode BatchNorm, an optional residual add and an optional ReLU in one
pass: the hand-written CUDA kernel K7 (``csrc/bn_act.cu``) and its plain
PyTorch version.

K7 replaces no TPU kernel: the JAX package leaves BatchNormalization's
eval branch (``bigdl_tpu/nn/normalization.py:69-103``), ``ReLU``
(``nn/activations.py:33``) and ``CAddTable`` (``nn/containers.py:150``)
to XLA, which fuses them.  It computes exactly those modules, in their
order:

    bn_act(x, bn, residual, residual_bn, relu) ->
        y = act(bn(x) [+ residual | + residual_bn(residual)])

``bn`` and ``residual_bn`` are eval-mode ``BatchNormalization`` modules
whose buffers (``running_mean``, ``running_var``), ``weight``, ``bias``
and ``eps`` are read at every call (on the card: inside the kernel, so a
CUDA graph reads statistics loaded in place after its capture).  ``x``
and ``residual`` are fp32 or bf16, channels last, of one shape.  The
plain version is the modules' own operations (``batch_norm_affine``, the
add in ``CAddTable``'s order, ``torch.relu``); K7 rounds after each, so
the two are bitwise equal.

With ``absmax=True`` the call also leaves ``max |y|`` for K6q
(``act_quant.hand_off``), which then quantizes ``y`` in one pass.

The wrapper sends CPU tensors to the plain version and CUDA tensors to the
kernel (one ``cudaMemsetAsync`` of the absmax scratch and one launch, on
the current stream); it raises on anything the kernel does not take (no
fallback).  ``LAUNCHES["bn_act"]`` counts launches through
``flash_attention``'s ``count_launch``, so CUDA graph replays add them.
"""

import torch

from bigdl_tpu_torch.nn.normalization import batch_norm_affine
from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops.act_quant import hand_off
from bigdl_tpu_torch.ops.flash_attention import (_raise_on, _stream,
                                                  count_launch,
                                                  register_launch_table,
                                                  sm_count)

#: kernel launches since the last ``reset_launch_counts()``
LAUNCHES = {"bn_act": 0}

register_launch_table("bn_act", LAUNCHES)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: the most channels K7 takes: four tables of C floats in shared memory
MAX_CHANNELS = 8192


def reset_launch_counts():
    LAUNCHES["bn_act"] = 0


def _stats(bn):
    return (bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps)


def bn_act_reference(x, bn, residual=None, residual_bn=None, relu=True):
    """The plain version: the modules' operations, in their order."""
    y = batch_norm_affine(x, *_stats(bn))
    if residual is not None:
        y = y + (residual if residual_bn is None else
                 batch_norm_affine(residual, *_stats(residual_bn)))
    return torch.relu(y) if relu else y


def _on_cpu(*ts):
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in ts}) != 1:
        raise ValueError(
            f"bn_act inputs must all lie on the CPU (plain version) or on "
            f"one CUDA device (kernel), got {[str(t.device) for t in ts]}")
    return False


def _tensors(x, bn, residual, residual_bn):
    ts = [x, *(t for t in _stats(bn)[:4] if t is not None)]
    if residual is not None:
        ts.append(residual)
    if residual_bn is not None:
        ts += [t for t in _stats(residual_bn)[:4] if t is not None]
    return ts


def _check(x, bn, residual, residual_bn):
    if x.dtype not in _DTYPES:
        raise TypeError(f"bn_act: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"bn_act: x must be non-empty with channels last, "
                         f"got {tuple(x.shape)}")
    c = x.shape[-1]
    if c > MAX_CHANNELS:
        raise ValueError(f"bn_act: {c} channels, K7 takes at most "
                         f"{MAX_CHANNELS}")
    if residual is not None and (residual.shape != x.shape or
                                 residual.dtype != x.dtype):
        raise ValueError(f"bn_act: the residual must match x, got "
                         f"{residual.dtype} {tuple(residual.shape)} against "
                         f"{x.dtype} {tuple(x.shape)}")
    if residual is None and residual_bn is not None:
        raise ValueError("bn_act: residual_bn without a residual")
    for name, m in (("bn", bn), ("residual_bn", residual_bn)):
        if m is None:
            continue
        for t in _stats(m)[:4]:
            if t is not None and (t.dtype != torch.float32 or
                                  t.shape != (c,) or
                                  not t.is_contiguous()):
                raise ValueError(f"bn_act: {name}'s statistics and affine "
                                 f"parameters must be contiguous fp32 of "
                                 f"shape ({c},), got {t.dtype} "
                                 f"{tuple(t.shape)}")
    for t in (x, residual):
        if t is not None and not t.is_contiguous():
            raise ValueError("bn_act: x and the residual must be contiguous "
                             "(channels last)")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _bn_args(bn):
    if bn is None:
        return [None, None, None, None, 0.0]
    return [_ptr(t) for t in _stats(bn)[:4]] + [bn.eps]


def bn_act(x, bn, residual=None, residual_bn=None, relu=True, absmax=False):
    """K7 (module docstring): ``y`` of ``x``'s shape and dtype; with
    ``absmax`` its ``max |y|`` is handed to K6q."""
    if _on_cpu(*_tensors(x, bn, residual, residual_bn)):
        y = bn_act_reference(x, bn, residual, residual_bn, relu)
        if absmax:
            hand_off(y, y.float().abs().amax().reshape(1)
                     .view(torch.int32))
        return y
    _check(x, bn, residual, residual_bn)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    scratch = torch.empty(1, dtype=torch.int32, device=x.device) \
        if absmax else None
    rc = _build.load().bigdl_bn_act(
        x.data_ptr(), _ptr(residual), y.data_ptr(), x.numel(), x.shape[-1],
        _DTYPES[x.dtype], *_bn_args(bn), *_bn_args(residual_bn), int(relu),
        _ptr(scratch), sm_count(x.device), _stream())
    _raise_on(rc, "bn_act")
    count_launch("bn_act", "bn_act")
    if absmax:
        hand_off(y, scratch)
    return y
