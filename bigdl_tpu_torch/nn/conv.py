"""Convolution layers (counterpart of ``bigdl_tpu/nn/conv.py``).

The weights keep the JAX layout, HWIO ``(kh, kw, cin / groups, cout)``
(:70), and the layers take NHWC batches (an NCHW facade is kept, as in
JAX).  The convolution itself is ``F.conv2d`` (cuDNN on the card): JAX
computes it with ``lax.conv_general_dilated`` (:102), an XLA op and no
Pallas kernel.  Inside a layer ``x.permute(0, 3, 1, 2)`` of an NHWC
tensor is already a channels-last NCHW view, cuDNN returns channels-last,
and the result permuted back is NHWC again with no copy.  The HWIO
weight permuted to OIHW is not channels-last: cuDNN transforms it at
every call.

A pad of -1 on both axes is TF-style ``"SAME"`` (:82-86), which puts the
odd pixel of the total padding on the high side; ``F.conv2d`` pads
symmetrically, so an asymmetric SAME pad is applied explicitly first.

A ``SpatialConvolution`` (or ``SpatialDilatedConvolution``) that holds
``weight_q``/``scale`` (the int8 twin of ``nn.quantized``) convolves in
int8 through the hand-written kernel K6 (``ops/int8_conv.py``).
"""

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.initialization import RandomUniform, Xavier, Zeros
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.quantized import int8_conv_layer


def same_pads(size, k, s, d=1):
    """``(lo, hi)`` of XLA's ``"SAME"`` padding for one spatial dim."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _pad_nhwc(x, pads_h, pads_w):
    """Zero-pad an NHWC batch by ``(lo, hi)`` on H and W."""
    return F.pad(x, (0, 0, pads_w[0], pads_w[1], pads_h[0], pads_h[1]))


def _conv_nhwc(x, w_hwio, bias, stride, pads, dilation=(1, 1), groups=1):
    """``conv(x, w) + bias`` of an NHWC batch and an HWIO weight, with
    ``pads`` ``((lo, hi), (lo, hi))`` per spatial dim; NHWC out."""
    (ph0, ph1), (pw0, pw1) = pads
    if ph0 != ph1 or pw0 != pw1:
        x = _pad_nhwc(x, (ph0, ph1), (pw0, pw1))
        ph0 = pw0 = 0
    y = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1), bias,
                 stride=stride, padding=(ph0, pw0), dilation=dilation,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


class SpatialConvolution(Module):
    """2-D convolution over NHWC (or NCHW) batches; the reference's
    constructor ``(nInputPlane, nOutputPlane, kW, kH, dW, dH, padW, padH,
    nGroup)``, plus dilation, the init methods, regularizers, ``name``
    and the port's ``generator``."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int, stride_w: int = 1,
                 stride_h: int = 1, pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1, dilation_w: int = 1, dilation_h: int = 1,
                 with_bias: bool = True, data_format: str = "NHWC",
                 weight_init=None, bias_init=None, w_regularizer=None,
                 b_regularizer=None, name=None, generator=None):
        super().__init__(name)
        self.set_regularizer(w_regularizer, b_regularizer)
        assert n_input_plane % n_group == 0 and \
            n_output_plane % n_group == 0
        assert data_format in ("NHWC", "NCHW")
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel = (kernel_h, kernel_w)
        self.stride = (stride_h, stride_w)
        self.pad = (pad_h, pad_w)
        self.dilation = (dilation_h, dilation_w)
        self.n_group = n_group
        self.with_bias = with_bias
        self.data_format = data_format
        kh, kw = self.kernel
        cin_g = n_input_plane // n_group
        fan_in = cin_g * kh * kw
        fan_out = (n_output_plane // n_group) * kh * kw
        self.weight = torch.nn.Parameter((weight_init or Xavier()).init(
            generator, (kh, kw, cin_g, n_output_plane), fan_in, fan_out))
        self.bias = torch.nn.Parameter((bias_init or Zeros()).init(
            generator, (n_output_plane,), fan_in, fan_out)) \
            if with_bias else None

    def _pads(self, x):
        """``((lo, hi), (lo, hi))`` for an NHWC batch ``x``."""
        ph, pw = self.pad
        if ph == -1 and pw == -1:
            return tuple(same_pads(x.shape[1 + i], self.kernel[i],
                                   self.stride[i], self.dilation[i])
                         for i in range(2))
        return (ph, ph), (pw, pw)

    def forward(self, x):
        if "weight_q" in self._parameters:
            # post-training-quantized weights (nn/quantized, JAX :91-99):
            # the int8 convolution (K6), bias in fp32, cast back to the
            # input dtype, the NCHW facade as below
            return int8_conv_layer(self, x)
        if self.data_format == "NCHW":
            x = x.permute(0, 2, 3, 1)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = _conv_nhwc(x, self.weight.to(x.dtype), bias, self.stride,
                       self._pads(x), self.dilation, self.n_group)
        if self.data_format == "NCHW":
            y = y.permute(0, 3, 1, 2)
        return y


class SpaceToDepthStem(SpatialConvolution):
    """A stride-2 odd-kernel convolution computed as a 4x4-block stride-1
    one over the 2x2 space-to-depth input (JAX :120).  The parameters are
    the plain stem's (weight ``[k, k, cin, cout]``); both reshapes happen
    in ``forward``.  Needs a square kernel with ``k % 4 == 3`` (7x7 pad
    3), even H and W, no groups or dilation."""

    def __init__(self, n_input_plane, n_output_plane, kernel=7, **kw):
        kw.setdefault("with_bias", False)
        super().__init__(n_input_plane, n_output_plane, kernel, kernel, 2, 2,
                         (kernel - 1) // 2, (kernel - 1) // 2, **kw)
        kh, kw_ = self.kernel
        assert kh == kw_ and kh % 4 == 3, \
            "kernel must be odd with pad+1 even"
        assert self.n_group == 1 and self.dilation == (1, 1)

    def forward(self, x):
        if self.data_format == "NCHW":
            x = x.permute(0, 2, 3, 1)
        n, h, w_sz, c = x.shape
        assert h % 2 == 0 and w_sz % 2 == 0, "space-to-depth needs even H/W"
        x = (x.reshape(n, h // 2, 2, w_sz // 2, 2, c)
             .permute(0, 1, 3, 2, 4, 5)
             .reshape(n, h // 2, w_sz // 2, 4 * c))
        wgt = self.weight.to(x.dtype)                  # [k, k, c, o]
        k, o = wgt.shape[0], wgt.shape[-1]
        kb = (k + 1) // 2
        # a zero row and column at the top left align the k-tap window
        # onto 2x2 blocks; each padded axis split as (block, in-block)
        # and regrouped gives the block-space kernel
        wgt = F.pad(wgt, (0, 0, 0, 0, 1, 0, 1, 0))
        wgt = (wgt.reshape(kb, 2, kb, 2, c, o)
               .permute(0, 2, 1, 3, 4, 5)
               .reshape(kb, kb, 4 * c, o))
        pb = (self.pad[0] + 1) // 2
        pa = kb - 1 - pb
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = _conv_nhwc(x, wgt, bias, (1, 1), ((pb, pa), (pb, pa)))
        if self.data_format == "NCHW":
            y = y.permute(0, 3, 1, 2)
        return y


class SpatialDilatedConvolution(SpatialConvolution):
    """``SpatialConvolution`` with the dilations after the pads, in the
    reference's argument order."""

    def __init__(self, n_input_plane, n_output_plane, kernel_w, kernel_h,
                 stride_w=1, stride_h=1, pad_w=0, pad_h=0, dilation_w=1,
                 dilation_h=1, **kw):
        super().__init__(n_input_plane, n_output_plane, kernel_w, kernel_h,
                         stride_w, stride_h, pad_w, pad_h,
                         dilation_w=dilation_w, dilation_h=dilation_h, **kw)


class SpatialFullConvolution(Module):
    """Transposed convolution (JAX :198): output ``s * (i - 1) + k - 2 p +
    adj`` per spatial dim, weight HWIO ``(kh, kw, cin, cout)``.  JAX
    computes it as a convolution of the stride-dilated input with the
    flipped kernel; ``F.conv_transpose2d`` is the same product, and needs
    ``adj`` below the stride."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int, stride_w: int = 1,
                 stride_h: int = 1, pad_w: int = 0, pad_h: int = 0,
                 adj_w: int = 0, adj_h: int = 0, with_bias: bool = True,
                 data_format: str = "NHWC", weight_init=None,
                 bias_init=None, name=None, generator=None):
        super().__init__(name)
        if adj_h >= max(stride_h, 1) or adj_w >= max(stride_w, 1):
            raise ValueError(f"adj ({adj_h}, {adj_w}) must be below the "
                             f"stride ({stride_h}, {stride_w})")
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel = (kernel_h, kernel_w)
        self.stride = (stride_h, stride_w)
        self.pad = (pad_h, pad_w)
        self.adj = (adj_h, adj_w)
        self.with_bias = with_bias
        self.data_format = data_format
        kh, kw = self.kernel
        fan_in = n_input_plane * kh * kw
        fan_out = n_output_plane * kh * kw
        self.weight = torch.nn.Parameter((weight_init or Xavier()).init(
            generator, (kh, kw, n_input_plane, n_output_plane), fan_in,
            fan_out))
        self.bias = torch.nn.Parameter((bias_init or Zeros()).init(
            generator, (n_output_plane,), fan_in, fan_out)) \
            if with_bias else None

    def forward(self, x):
        if self.data_format == "NCHW":
            x = x.permute(0, 2, 3, 1)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv_transpose2d(
            x.permute(0, 3, 1, 2), self.weight.to(x.dtype).permute(2, 3, 0, 1),
            bias, stride=self.stride, padding=self.pad,
            output_padding=self.adj).permute(0, 2, 3, 1)
        if self.data_format == "NCHW":
            y = y.permute(0, 3, 1, 2)
        return y


class Conv1D(Module):
    """Temporal convolution over ``(N, T, C)``; weight ``(kw, cin,
    cout)``, ``pad_w=-1`` is SAME."""

    def __init__(self, input_frame_size, output_frame_size, kernel_w,
                 stride_w=1, pad_w=0, with_bias=True, weight_init=None,
                 bias_init=None, name=None, generator=None):
        super().__init__(name)
        self.input_frame_size = input_frame_size
        self.output_frame_size = output_frame_size
        self.kernel_w = kernel_w
        self.stride_w = stride_w
        self.pad_w = pad_w
        self.with_bias = with_bias
        fan_in = input_frame_size * kernel_w
        fan_out = output_frame_size * kernel_w
        self.weight = torch.nn.Parameter((weight_init or Xavier()).init(
            generator, (kernel_w, input_frame_size, output_frame_size),
            fan_in, fan_out))
        self.bias = torch.nn.Parameter((bias_init or Zeros()).init(
            generator, (output_frame_size,), fan_in, fan_out)) \
            if with_bias else None

    def forward(self, x):
        lo, hi = (same_pads(x.shape[1], self.kernel_w, self.stride_w)
                  if self.pad_w == -1 else (self.pad_w, self.pad_w))
        xc = x.permute(0, 2, 1)
        if lo != hi:
            xc, lo = F.pad(xc, (lo, hi)), 0
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv1d(xc, self.weight.to(x.dtype).permute(2, 1, 0), bias,
                     stride=self.stride_w, padding=lo)
        return y.permute(0, 2, 1)


TemporalConvolution = Conv1D


class SpatialConvolutionMap(Module):
    """Convolution over a connection table (JAX :330): ``conn_table`` is
    ``(n_connections, 2)`` 0-based ``[input_feature, output_feature]``
    pairs; one ``(kh, kw)`` kernel per connection (``weight (n_conn, kh,
    kw)``) and one bias per output plane, scattered into a dense HWIO
    kernel for one full convolution."""

    def __init__(self, conn_table, kernel_w, kernel_h, stride_w=1,
                 stride_h=1, pad_w=0, pad_h=0, data_format="NHWC",
                 w_regularizer=None, b_regularizer=None, name=None,
                 generator=None):
        super().__init__(name)
        self.set_regularizer(w_regularizer, b_regularizer)
        table = np.asarray(conn_table, np.int64).reshape(-1, 2)
        self.conn_in = tuple(int(i) for i in table[:, 0])
        self.conn_out = tuple(int(o) for o in table[:, 1])
        self.n_input_plane = max(self.conn_in) + 1
        self.n_output_plane = max(self.conn_out) + 1
        self.kernel = (kernel_h, kernel_w)
        self.stride = (stride_h, stride_w)
        self.pad = (pad_h, pad_w)
        assert data_format in ("NHWC", "NCHW")
        self.data_format = data_format
        kh, kw = self.kernel
        # Torch's reset: stdv over the busiest output's fan-in
        fan = kh * kw * max(self.conn_out.count(o)
                            for o in set(self.conn_out))
        init = RandomUniform(-1.0 / fan ** 0.5, 1.0 / fan ** 0.5)
        self.weight = torch.nn.Parameter(init.init(
            generator, (len(self.conn_in), kh, kw), fan, fan))
        self.bias = torch.nn.Parameter(init.init(
            generator, (self.n_output_plane,), fan, fan))

    def forward(self, x):
        if self.data_format == "NCHW":
            x = x.permute(0, 2, 3, 1)
        kh, kw = self.kernel
        dense = torch.zeros((kh, kw, self.n_input_plane, self.n_output_plane),
                            dtype=self.weight.dtype, device=self.weight.device)
        dense[:, :, list(self.conn_in), list(self.conn_out)] = \
            self.weight.permute(1, 2, 0)
        ph, pw = self.pad
        pads = (tuple(same_pads(x.shape[1 + i], self.kernel[i],
                                self.stride[i]) for i in range(2))
                if ph == -1 and pw == -1 else ((ph, ph), (pw, pw)))
        y = _conv_nhwc(x, dense.to(x.dtype), self.bias.to(x.dtype),
                       self.stride, pads)
        if self.data_format == "NCHW":
            y = y.permute(0, 3, 1, 2)
        return y
