"""Int8 convolution: hand-written CUDA kernels (K6,
``csrc/int8_conv.cu``) and their plain PyTorch version.

Counterpart of ``bigdl_tpu/nn/quantized.py:110`` ``int8_conv``, which the
JAX package leaves to XLA (``lax.conv_general_dilated`` with
``preferred_element_type=jnp.int32``).  PyTorch has no int8 convolution
on the card (``F.conv2d`` and ``F.unfold`` take no int8 there), so the
port writes one:

    int8_conv_nhwc(x_q, w_q, scale, x_scale, bias, stride, pads,
                   dilation, groups, out_dtype, w_packed)
        -> (acc.float() * (scale * x_scale) + bias).to(out_dtype)

with ``acc`` the exact int32 sum of ``x_q`` (int8 NHWC) against ``w_q``
(int8 HWIO, ``(kh, kw, cin / groups, cout)``), ``scale`` the fp32
``(cout,)`` weight scale, ``x_scale`` the fp32 0-d activation scale (a
device tensor: the kernel reads it by pointer, so a call is captured in a
CUDA graph with no host sync), ``bias`` fp32 ``(cout,)`` or None, and
``pads`` ``((lo, hi), (lo, hi))`` per spatial dim.  The result is NHWC.

On the card the shape picks the kernel (``uses_wgmma``):

- ``cin / groups`` a multiple of 16 (every ResNet-50 convolution but the
  stem): the ``wgmma`` implicit GEMM, which reads the weight as
  ``pack_weight(w_q, groups)`` (per group a K-contiguous ``(cout_pad,
  k_pad)`` matrix, zero-padded to the kernel's tiles); callers that run
  a weight more than once pass the packed copy as ``w_packed``
  (``nn/quantized.py`` caches it on the layer), else it is packed at the
  call; ``LAUNCHES["int8_conv"]``;
- any other ``cin / groups`` (the 7 x 7 stem, cin 3): the byte-gather
  ``mma.sync`` kernel over the HWIO weight;
  ``LAUNCHES["int8_conv_gather"]``.

The plain version computes ``acc`` as ``F.conv2d`` in float64 over the
int8 values: every partial sum is an integer below 2^53 (at most K x
127^2, K = kh * kw * cin / groups), so it is exact, where fp32 is not past
2^24.  Its epilogue is three separate tensor ops, and the kernels round
at the same three places in the same order, so they agree bit for bit.

The wrapper sends CPU tensors to the plain version and CUDA tensors to
a kernel; it raises on anything the kernels do not take (no fallback).
Launches are counted through ``flash_attention``'s ``count_launch``, so
CUDA graph replays add them.
"""

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops.flash_attention import (_raise_on, _stream,
                                                  count_launch,
                                                  register_launch_table)

#: kernel launches since the last ``reset_launch_counts()``
LAUNCHES = {"int8_conv": 0, "int8_conv_gather": 0}

register_launch_table("int8_conv", LAUNCHES)

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: bytes of k a stage of the wgmma kernel (``WK`` in csrc/int8_conv.cu)
STAGE_K = 128


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def output_size(size, k, stride, pads, dilation=1):
    """Output length of one spatial dim: ``pads`` is ``(lo, hi)``."""
    return (size + pads[0] + pads[1] - ((k - 1) * dilation + 1)) // stride + 1


def _pairs(stride, pads, dilation):
    stride = tuple(int(s) for s in stride)
    dilation = tuple(int(d) for d in dilation)
    pads = tuple((int(lo), int(hi)) for lo, hi in pads)
    return stride, pads, dilation


def uses_wgmma(cin_g):
    """Whether the card runs a convolution with ``cin_g`` input channels a
    group on the wgmma kernel: a 16-byte run of k then lies in one tap."""
    return cin_g % 16 == 0


def tile_n(cout_g):
    """The wgmma kernel's tile width for ``cout_g`` output channels a
    group (``bn`` in csrc/int8_conv.cu)."""
    return 64 if cout_g <= 64 else 128


def pack_weight(w_q, groups=1):
    """The HWIO int8 weight ``(kh, kw, cin_g, cout)`` as the wgmma
    kernel reads it: per group a ``(cout_pad, k_pad)`` matrix, row ``o``
    the output channel ``g * cout_g + o`` with its ``K = kh * kw * cin_g``
    weights K-contiguous in ``(ky, kx, c)`` order, zero columns to
    ``k_pad`` (a multiple of ``STAGE_K``) and zero rows to ``cout_pad`` (a
    multiple of ``tile_n(cout_g)``); the groups stacked,
    ``(groups * cout_pad, k_pad)``, contiguous.  Plain torch: it runs on
    the CPU too."""
    if w_q.dim() != 4 or w_q.shape[3] % groups:
        raise ValueError(f"pack_weight: need an HWIO weight whose "
                         f"{groups} groups divide its output channels, got "
                         f"{tuple(w_q.shape)}")
    kh, kw, cin_g, cout = w_q.shape
    k, cout_g = kh * kw * cin_g, cout // groups
    k_pad = -(-k // STAGE_K) * STAGE_K
    cout_pad = -(-cout_g // tile_n(cout_g)) * tile_n(cout_g)
    w = w_q.reshape(k, groups, cout_g).permute(1, 2, 0)
    packed = w_q.new_zeros((groups, cout_pad, k_pad))
    packed[:, :cout_g, :k] = w
    return packed.reshape(groups * cout_pad, k_pad)


# --------------------------------------------------------------------------- #
# Plain version
# --------------------------------------------------------------------------- #

def int8_conv_acc_reference(x_q, w_q, stride=(1, 1), pads=((0, 0), (0, 0)),
                            dilation=(1, 1), groups=1):
    """The exact int32 sums, NHWC ``(n, ho, wo, cout)`` (contiguous):
    ``F.conv2d`` in float64 over the int8 values."""
    stride, pads, dilation = _pairs(stride, pads, dilation)
    (ph0, ph1), (pw0, pw1) = pads
    x = F.pad(x_q.to(torch.float64), (0, 0, pw0, pw1, ph0, ph1))
    acc = F.conv2d(x.permute(0, 3, 1, 2),
                   w_q.to(torch.float64).permute(3, 2, 0, 1),
                   stride=stride, dilation=dilation, groups=groups)
    # row-major NHWC, as the kernels write it: the layers after the
    # convolution then reduce over the same memory order on either path
    return acc.permute(0, 2, 3, 1).to(torch.int32,
                                      memory_format=torch.contiguous_format)


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
                   out_dtype=torch.float32, w_packed=None):
    """K6 (module docstring): the int8 convolution of an NHWC batch,
    scaled to real units, NHWC out in ``out_dtype``.  ``w_packed``:
    ``pack_weight(w_q, groups)``, used by the wgmma kernel (packed here
    when it is not given); the plain version reads ``w_q``."""
    tensors = [x_q, w_q, scale, x_scale] + ([] if bias is None else [bias])
    if _on_cpu(*tensors):
        return int8_conv_nhwc_reference(x_q, w_q, scale, x_scale, bias,
                                        stride, pads, dilation, groups,
                                        out_dtype)
    stride, pads, dilation = _pairs(stride, pads, dilation)
    _check(x_q, w_q, scale, x_scale, bias, groups, out_dtype)
    n, h, w, c = x_q.shape
    kh, kw, cin_g, cout = w_q.shape
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
    scale = scale.contiguous()
    bias = None if bias is None else bias.contiguous()
    geometry = (_OUT_DTYPES[out_dtype], n, h, w, c, ho, wo, kh, kw,
                stride[0], stride[1], pads[0][0], pads[1][0], dilation[0],
                dilation[1], groups, cout, _stream())
    lib = _build.load()
    if uses_wgmma(cin_g):
        if x_q.data_ptr() % 16:
            x_q = x_q.clone()         # 16-byte runs need an aligned start
        if w_packed is None:
            w_packed = pack_weight(w_q, groups)
        _check_packed(w_packed, w_q, groups)
        rc = lib.bigdl_int8_conv_wgmma(
            x_q.data_ptr(), w_packed.data_ptr(), w_packed.shape[1],
            w_packed.shape[0] // groups, scale.data_ptr(),
            x_scale.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), *geometry)
        name = "int8_conv"
    else:
        w_q = w_q.contiguous()
        rc = lib.bigdl_int8_conv(
            x_q.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
            x_scale.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), *geometry)
        name = "int8_conv_gather"
    _raise_on(rc, name)
    count_launch("int8_conv", name)
    return out


def _check_packed(w_packed, w_q, groups):
    kh, kw, cin_g, cout = w_q.shape
    cout_g, k = cout // groups, kh * kw * cin_g
    rows, k_pad = w_packed.shape if w_packed.dim() == 2 else (0, 0)
    cout_pad = rows // groups
    if w_packed.dtype != torch.int8 or w_packed.device != w_q.device or \
            not w_packed.is_contiguous() or w_packed.data_ptr() % 16 or \
            rows % groups or k_pad % STAGE_K or k_pad < k or \
            cout_pad % tile_n(cout_g) or cout_pad < cout_g:
        raise ValueError(f"int8_conv: w_packed {w_packed.dtype} "
                         f"{tuple(w_packed.shape)} on {w_packed.device} is "
                         f"not pack_weight of {tuple(w_q.shape)} in "
                         f"{groups} groups")
