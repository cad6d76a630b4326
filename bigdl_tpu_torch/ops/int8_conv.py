"""Int8 convolution: one hand-written CUDA kernel (K6,
``csrc/int8_conv.cu``) and its plain PyTorch version.

Counterpart of ``bigdl_tpu/nn/quantized.py:110`` ``int8_conv``, which the
JAX package leaves to XLA (``lax.conv_general_dilated`` with
``preferred_element_type=jnp.int32``).  PyTorch has no int8 convolution
on the card (``F.conv2d`` and ``F.unfold`` take no int8 there), so the
port writes one:

    int8_conv_nhwc(x_q, w_q, scale, x_scale, bias, stride, pads,
                   dilation, groups, out_dtype)
        -> (acc.float() * (scale * x_scale) + bias).to(out_dtype)

with ``acc`` the exact int32 sum of ``x_q`` (int8 NHWC) against ``w_q``
(int8 HWIO, ``(kh, kw, cin / groups, cout)``), ``scale`` the fp32
``(cout,)`` weight scale, ``x_scale`` the fp32 0-d activation scale (a
device tensor: the kernel reads it by pointer, so a call is captured in a
CUDA graph with no host sync), ``bias`` fp32 ``(cout,)`` or None, and
``pads`` ``((lo, hi), (lo, hi))`` per spatial dim.  The result is NHWC.

The plain version computes ``acc`` as ``F.conv2d`` in float64 over the
int8 values: every partial sum is an integer below 2^53 (at most K x
127^2, K = kh * kw * cin / groups), so it is exact, where fp32 is not past
2^24.  Its epilogue is three separate tensor ops, and the kernel rounds
at the same three places in the same order, so the two agree bit for bit.

The wrapper sends CPU tensors to the plain version and CUDA tensors to
the kernel; it raises on anything the kernel does not take (no
fallback).  ``LAUNCHES["int8_conv"]`` counts launches through
``flash_attention``'s ``count_launch``, so CUDA graph replays add them.
"""

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops.flash_attention import (_raise_on, _stream,
                                                  count_launch,
                                                  register_launch_table)

#: kernel launches since the last ``reset_launch_counts()``
LAUNCHES = {"int8_conv": 0}

register_launch_table("int8_conv", LAUNCHES)

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts():
    LAUNCHES["int8_conv"] = 0


def output_size(size, k, stride, pads, dilation=1):
    """Output length of one spatial dim: ``pads`` is ``(lo, hi)``."""
    return (size + pads[0] + pads[1] - ((k - 1) * dilation + 1)) // stride + 1


def _pairs(stride, pads, dilation):
    stride = tuple(int(s) for s in stride)
    dilation = tuple(int(d) for d in dilation)
    pads = tuple((int(lo), int(hi)) for lo, hi in pads)
    return stride, pads, dilation


# --------------------------------------------------------------------------- #
# Plain version
# --------------------------------------------------------------------------- #

def int8_conv_acc_reference(x_q, w_q, stride=(1, 1), pads=((0, 0), (0, 0)),
                            dilation=(1, 1), groups=1):
    """The exact int32 sums, NHWC ``(n, ho, wo, cout)``: ``F.conv2d`` in
    float64 over the int8 values."""
    stride, pads, dilation = _pairs(stride, pads, dilation)
    (ph0, ph1), (pw0, pw1) = pads
    x = F.pad(x_q.to(torch.float64), (0, 0, pw0, pw1, ph0, ph1))
    acc = F.conv2d(x.permute(0, 3, 1, 2),
                   w_q.to(torch.float64).permute(3, 2, 0, 1),
                   stride=stride, dilation=dilation, groups=groups)
    return acc.permute(0, 2, 3, 1).to(torch.int32)


def int8_conv_epilogue(acc, scale, x_scale, bias=None,
                       out_dtype=torch.float32):
    """``(acc.float() * (scale * x_scale) + bias).to(out_dtype)``, three
    roundings in this order (the kernel's)."""
    y = acc.to(torch.float32) * (scale * x_scale)
    if bias is not None:
        y = y + bias
    return y.to(out_dtype)


def int8_conv_nhwc_reference(x_q, w_q, scale, x_scale, bias=None,
                             stride=(1, 1), pads=((0, 0), (0, 0)),
                             dilation=(1, 1), groups=1,
                             out_dtype=torch.float32):
    acc = int8_conv_acc_reference(x_q, w_q, stride, pads, dilation, groups)
    return int8_conv_epilogue(acc, scale, x_scale, bias, out_dtype)


# --------------------------------------------------------------------------- #
# Kernel wrapper
# --------------------------------------------------------------------------- #

def _on_cpu(*ts):
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in ts}) != 1:
        raise ValueError(
            f"int8_conv inputs must all lie on the CPU (plain version) or on "
            f"one CUDA device (kernel), got {[str(t.device) for t in ts]}")
    return False


def _check(x_q, w_q, scale, x_scale, bias, groups, out_dtype):
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8_conv: x_q and w_q must be int8, got "
                        f"{x_q.dtype}, {w_q.dtype}")
    if x_q.dim() != 4 or w_q.dim() != 4:
        raise ValueError(f"int8_conv: need an NHWC x_q and an HWIO w_q, got "
                         f"{tuple(x_q.shape)}, {tuple(w_q.shape)}")
    c, cout = x_q.shape[3], w_q.shape[3]
    if groups < 1 or c % groups or cout % groups or \
            w_q.shape[2] * groups != c:
        raise ValueError(f"int8_conv: {c} input channels, weight "
                         f"{tuple(w_q.shape)} and {groups} groups disagree")
    for name, t, shape in (("scale", scale, (cout,)),
                           ("x_scale", x_scale, ()),
                           ("bias", bias, (cout,))):
        if t is None:
            continue
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"int8_conv: {name} must be fp32 of shape "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"int8_conv: out_dtype must be float32 or bfloat16 "
                        f"on the card, got {out_dtype}")


def int8_conv_nhwc(x_q, w_q, scale, x_scale, bias=None, stride=(1, 1),
                   pads=((0, 0), (0, 0)), dilation=(1, 1), groups=1,
                   out_dtype=torch.float32):
    """K6 (module docstring): the int8 convolution of an NHWC batch,
    scaled to real units, NHWC out in ``out_dtype``."""
    tensors = [x_q, w_q, scale, x_scale] + ([] if bias is None else [bias])
    if _on_cpu(*tensors):
        return int8_conv_nhwc_reference(x_q, w_q, scale, x_scale, bias,
                                        stride, pads, dilation, groups,
                                        out_dtype)
    stride, pads, dilation = _pairs(stride, pads, dilation)
    _check(x_q, w_q, scale, x_scale, bias, groups, out_dtype)
    n, h, w, c = x_q.shape
    kh, kw, _, cout = w_q.shape
    ho = output_size(h, kh, stride[0], pads[0], dilation[0])
    wo = output_size(w, kw, stride[1], pads[1], dilation[1])
    if min(pads[0] + pads[1]) < 0 or min(stride + dilation) < 1 or \
            ho < 0 or wo < 0:
        raise ValueError(f"int8_conv: stride {stride}, pads {pads}, "
                         f"dilation {dilation} do not fit input "
                         f"{tuple(x_q.shape)} and weight {tuple(w_q.shape)}")
    out = torch.empty((n, max(ho, 0), max(wo, 0), cout), dtype=out_dtype,
                      device=x_q.device)
    if out.numel() == 0:
        return out
    x_q = x_q.contiguous()
    w_q = w_q.contiguous()
    scale = scale.contiguous()
    bias = None if bias is None else bias.contiguous()
    rc = _build.load().bigdl_int8_conv(
        x_q.data_ptr(), w_q.data_ptr(), scale.data_ptr(), x_scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        _OUT_DTYPES[out_dtype], n, h, w, c, ho, wo, kh, kw, stride[0],
        stride[1], pads[0][0], pads[1][0], dilation[0], dilation[1], groups,
        cout, _stream())
    _raise_on(rc, "int8_conv")
    count_launch("int8_conv", "int8_conv")
    return out
