"""Int8 post-training quantization (counterpart of
``bigdl_tpu/nn/quantized.py``: the kernels :55-122, the int8 layers and
the legacy in-place ``quantize(model)`` :125-270, and the serving-path
rewrite :289-433).

Weights are quantized per output channel (symmetric, absmax / 127);
activations per tensor at run time, over every row of the step.  The
contraction is exact in int32, as ``lax.dot_general(...,
preferred_element_type=jnp.int32)`` in the JAX package: ``torch._int_mm``
takes int8 operands and returns int32 on the CPU and on the card.  It is a
plain matrix product, not a TPU kernel, so the port has no kernel of its
own for it.  The per-tensor activation quantization ahead of both is the
hand-written kernel K6q (``ops/act_quant.py``) on the card.  The int8
convolution (``int8_conv``) has no library call on the card: it runs
through the hand-written kernel K6 (``ops/int8_conv.py``), the exact
int32 sum, the scaling, the layer's bias and its cast in one launch; a
convolution layer keeps K6's packed copy of its weight in a cache off the
parameter tree (``int8_conv_layer``).  Both rewrites give the model a
fused eval plan (``nn/fused.py``): in eval mode BatchNorm, the residual
add and ReLU run as K7 (``ops/bn_act.py``), whose output K6q quantizes
reading it once.

``quantize_model(model)`` returns the int8 TWIN: a copy of the module
tree whose ``Linear``, ``SpatialConvolution`` /
``SpatialDilatedConvolution`` (exact types: ``SpaceToDepthStem``
reshapes its weight inside ``forward`` and stays fp32) and
``MultiHeadAttention`` sites hold ``weight_q``/``scale``
(``qkv_weight_q``/``qkv_scale``, ``out_weight_q``/``out_scale``) int8 and
fp32 tensors under the JAX key names, so a JAX quantized tree loads into
it key by key; every other leaf (embeddings, the LM head, LayerNorms,
BatchNorms, biases) stays fp32.  The layers' own ``forward`` take the
int8 path when they hold ``weight_q``.  The twin shares no tensor and no
state with the fp32 model: a serving engine that drafts with it must
never end up verifying with itself.

``quantize(model)`` is the reference's in-place rewrite
(``AbstractModule.quantize``): every ``Linear`` and plain or dilated
convolution child of a Sequential-style container (children keyed
``"0".."n"``, nested containers included) is swapped for its
``QuantizedLinear`` / ``QuantizedSpatialConvolution``, all or nothing.
"""

import copy
import weakref
from typing import Callable, Optional

import torch

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.device import resolve_device


def quantize_weights_per_channel(w, channel_axis: int):
    """Symmetric int8 per-output-channel quantization -> ``(w_int8,
    scale)``; ``scale`` keeps the reduced axes as size-1 dims."""
    reduce_axes = tuple(a for a in range(w.dim()) if a != channel_axis)
    absmax = w.abs().amax(dim=reduce_axes, keepdim=True)
    scale = absmax.clamp_min(1e-8) / 127.0
    w_q = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    return w_q, scale.to(torch.float32)


def quantize_channelwise(w, channel_axis: int, lead_axes: int = 0):
    """Per-output-channel int8 quantization with ``lead_axes`` stacked
    leading axes (each [lead x channel] slice gets its own scale).
    Returns ``(w_q int8, scale fp32)`` with ``scale.shape = lead dims +
    (channels,)``."""
    if not 0 <= lead_axes <= channel_axis < w.dim():
        raise ValueError(f"channel_axis {channel_axis} / lead_axes "
                         f"{lead_axes} do not fit shape {tuple(w.shape)}")
    reduce_axes = tuple(a for a in range(w.dim())
                        if a >= lead_axes and a != channel_axis)
    absmax = w.abs().amax(dim=reduce_axes, keepdim=True)
    scale = absmax.clamp_min(1e-8) / 127.0
    w_q = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    for a in sorted(reduce_axes, reverse=True):
        scale = scale.squeeze(a)
    return w_q, scale.to(torch.float32)


def _quantize_activation(x):
    """Dynamic symmetric per-tensor activation quantization ->
    ``(x_int8, scale)``, the scale over EVERY element of ``x``: K6q on the
    card, its plain version on the CPU (``ops/act_quant.py``)."""
    from bigdl_tpu_torch.ops.act_quant import act_quant

    return act_quant(x)


def _pad_to(t, dim, multiple, at_least=0):
    n = t.shape[dim]
    want = max(-(-n // multiple) * multiple, at_least)
    if want == n:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, want - n]
    return torch.nn.functional.pad(t, pad)


def _int_mm(a, b_t):
    """Exact int32 ``a (M, K) @ b_t.T`` for int8 ``a`` and ``b_t (N, K)``.
    On the card ``torch._int_mm`` needs M > 16 and K, N multiples of 8:
    zero rows and columns are padded on (they add nothing to the sum)
    and sliced off."""
    m, n = a.shape[0], b_t.shape[0]
    if a.is_cuda:
        a = _pad_to(_pad_to(a, 1, 8), 0, 1, at_least=17)
        b_t = _pad_to(_pad_to(b_t, 1, 8), 0, 8)
    return torch._int_mm(a, b_t.t())[:m, :n]


def int8_matmul(x, w_q, scale):
    """``deq(quant(x)) @ deq(w).T`` with the contraction in int8 and an
    exact int32 sum: ``x (..., in)`` float, ``w_q (out, in)`` int8,
    ``scale (out,)`` fp32 -> fp32 ``(..., out)`` (bias and cast are the
    caller's).  The activation scale is taken before any padding."""
    x_q, x_scale = _quantize_activation(x)
    lead = x_q.shape[:-1]
    acc = _int_mm(x_q.reshape(-1, x_q.shape[-1]), w_q)
    acc = acc.reshape(*lead, w_q.shape[0])
    return acc.to(torch.float32) * (scale * x_scale)


def _conv_padding(padding, x_nhwc, kernel, stride, dilation):
    """The padding a JAX convolution layer passes (``"SAME"`` or ``((lo,
    hi), (lo, hi))``) as explicit pads of an NHWC batch."""
    if padding == "SAME":
        from bigdl_tpu_torch.nn.conv import same_pads

        return tuple(same_pads(x_nhwc.shape[1 + i], kernel[i], stride[i],
                               dilation[i]) for i in range(2))
    return tuple(tuple(p) for p in padding)


def int8_conv(x_nhwc, w_q, scale, *, stride, padding, dilation, groups,
              bias=None, out_dtype=torch.float32, w_packed=None):
    """Int8 NHWC convolution: ``x`` float, ``w_q`` HWIO int8, ``scale``
    ``(out,)`` -> the exact int32 sum scaled back to real units, NHWC.
    The activation is quantized per tensor (``_quantize_activation``: K6q
    on the card); the convolution is K6 on the card (reading ``w_packed``,
    ``ops.int8_conv.pack_weight(w_q, groups)``, where its shape takes the
    wgmma kernel: packed at the call when not given) and its plain version
    on the CPU.  ``bias`` (fp32) is added and the result cast to
    ``out_dtype`` in the same call, with the roundings of ``(acc * scale +
    bias).to(...)``: the JAX layer adds its bias and casts after
    ``int8_conv`` returns."""
    from bigdl_tpu_torch.ops.int8_conv import int8_conv_nhwc

    pads = _conv_padding(padding, x_nhwc, tuple(w_q.shape[:2]), stride,
                         dilation)
    x_q, x_scale = _quantize_activation(x_nhwc)
    return int8_conv_nhwc(x_q, w_q, scale, x_scale, bias, stride, pads,
                          dilation, groups, out_dtype, w_packed)


class _PackedWeight:
    """K6's packed copy of one layer's weight and the key it was packed
    under; a copy of the layer (``copy.deepcopy``, pickling) starts
    without it, as ``optim/validation.py``'s eval cache does."""

    def __init__(self, weight=None, key=None, packed=None):
        self.weight = None if weight is None else weakref.ref(weight)
        self.key, self.packed = key, packed

    def holds(self, weight, key):
        return self.weight is not None and self.weight() is weight and \
            self.key == key

    def __deepcopy__(self, memo):
        return _PackedWeight()

    def __reduce__(self):
        return _PackedWeight, ()


def packed_weight(layer):
    """K6's packed copy of ``layer.weight_q`` (``pack_weight``), cached on
    the layer outside the parameters and state that checkpoints, the JAX
    bridge and ``model_bytes`` read.  The key is the weight tensor itself
    (a weak reference: ``_bind`` and a deserialization install a new
    one), its ``data_ptr()`` and its ``_version`` (an in-place load,
    ``t.copy_``, bumps it), so a reloaded weight is packed anew.  None
    where the shape takes K6's gather kernel, which reads the HWIO
    weight.  The forward asks for it on the card only: the CPU's plain
    version reads the HWIO weight."""
    from bigdl_tpu_torch.ops.int8_conv import pack_weight, uses_wgmma

    w_q = layer.weight_q
    if not uses_wgmma(w_q.shape[2]):
        return None
    key = (w_q.data_ptr(), w_q._version)
    cache = layer.__dict__.get("_k6_packed")
    if cache is None or not cache.holds(w_q, key):
        cache = _PackedWeight(w_q, key, pack_weight(w_q.detach(),
                                                    layer.n_group))
        layer.__dict__["_k6_packed"] = cache
    return cache.packed


def packed_weight_bytes(model) -> int:
    """Bytes of the packed copies (``packed_weight``) that the layers of
    ``model`` hold now, beside ``model_bytes`` of its parameters: on the
    card a wgmma layer holds its weight twice, HWIO and packed."""
    caches = (m.__dict__.get("_k6_packed") for m in model.modules())
    return sum(c.packed.numel() * c.packed.element_size() for c in caches
               if c is not None and c.packed is not None)


def int8_conv_layer(layer, x):
    """The quantization-aware forward of a convolution layer holding
    ``weight_q``/``scale`` (JAX ``nn/conv.py:91-99``): ``int8_conv`` with
    the layer's stride, pads, dilation and groups, the bias in fp32, the
    result in the input's dtype, and the NCHW facade."""
    from bigdl_tpu_torch.nn.conv import SpatialConvolution

    if layer.data_format == "NCHW":
        x = x.permute(0, 2, 3, 1)
    bias = getattr(layer, "bias", None)
    y = int8_conv(x, layer.weight_q, layer.scale.float(),
                  stride=layer.stride,
                  padding=SpatialConvolution._pads(layer, x),
                  dilation=layer.dilation, groups=layer.n_group,
                  bias=None if bias is None else bias.float(),
                  out_dtype=x.dtype,
                  w_packed=packed_weight(layer) if x.is_cuda else None)
    if layer.data_format == "NCHW":
        y = y.permute(0, 3, 1, 2)
    return y


def _frozen(t):
    return torch.nn.Parameter(t.detach().clone(), requires_grad=False)


def _layer_device(module, device):
    p = next(module.parameters(), None)
    return p.device if p is not None else resolve_device(device)


class QuantizedLinear(Module):
    """Int8 linear (reference: nn/quantized/Linear.scala; JAX :125).

    Built from a float ``Linear`` (its weights, or ``params``, a tree with
    ``weight`` and ``bias``) or from pre-quantized arrays (``weight_q``,
    ``scale``, ``bias``: the deserialization path).  ``weight_q`` is an
    int8 ``(out, in)`` parameter, ``scale`` fp32 ``(out,)``, ``bias``
    fp32; none of them trains.  ``device`` places pre-quantized numpy
    arrays (None: the CUDA card)."""

    def __init__(self, linear=None, params=None, *, output_size=None,
                 with_bias=True, weight_q=None, scale=None, bias=None,
                 name=None, device=None):
        if linear is not None:
            super().__init__(name or linear.name + "_int8")
            self.output_size = linear.output_size
            self.with_bias = linear.with_bias
            dev = _layer_device(linear, device)
            p = params if params is not None else linear.parameters_tree()
            w_q, s = quantize_weights_per_channel(
                _to_tensor(p["weight"], dev).float(), 0)
            weight_q, scale = w_q, s[:, 0]
            bias = p.get("bias")
        else:
            super().__init__(name)
            self.output_size = output_size
            self.with_bias = with_bias
            dev = weight_q.device if isinstance(weight_q, torch.Tensor) \
                else resolve_device(device)
        self.weight_q = _frozen(_to_tensor(weight_q, dev).to(torch.int8))
        self.scale = _frozen(_to_tensor(scale, dev).float())
        self.bias = _frozen(_to_tensor(bias, dev).float()) \
            if self.with_bias else None

    def forward(self, x):
        y = int8_matmul(x, self.weight_q, self.scale)
        if self.with_bias:
            y = y + self.bias
        return y.to(x.dtype)


#: the settings of the float convolution a ``QuantizedSpatialConvolution``
#: keeps (it keeps no reference to the float layer or its weight)
_CONV_ATTRS = ("n_input_plane", "n_output_plane", "kernel", "stride", "pad",
               "dilation", "n_group", "with_bias", "data_format")


class QuantizedSpatialConvolution(Module):
    """Int8 convolution (reference: nn/quantized/SpatialConvolution.scala;
    JAX :163): the HWIO weight quantized per output channel (axis 3).

    Built from a float ``SpatialConvolution`` (or the dilated one): its
    settings are copied and its weights, or ``params``, quantized; with
    ``weight_q`` / ``scale`` / ``bias`` given (the deserialization path)
    those are taken as they are.  The forward is ``int8_conv_layer``: K6
    on the card."""

    def __init__(self, conv, params=None, *, weight_q=None, scale=None,
                 bias=None, name=None, device=None):
        super().__init__(name or conv.name + "_int8")
        for attr in _CONV_ATTRS:
            setattr(self, attr, getattr(conv, attr))
        dev = _layer_device(conv, device)
        if weight_q is None:
            p = params if params is not None else conv.parameters_tree()
            w_q, s = quantize_weights_per_channel(
                _to_tensor(p["weight"], dev).float(), 3)
            weight_q, scale = w_q, s.reshape(-1)
            bias = p.get("bias")
        self.weight_q = _frozen(_to_tensor(weight_q, dev).to(torch.int8))
        self.scale = _frozen(_to_tensor(scale, dev).float())
        self.bias = _frozen(_to_tensor(bias, dev).float()) \
            if self.with_bias else None

    def forward(self, x):
        return int8_conv_layer(self, x)


def quantize(model: Module) -> Module:
    """Rewrite a model for int8 inference in place (reference:
    Quantizer.quantize; JAX :204): every ``Linear`` and every
    ``SpatialConvolution`` / ``SpatialDilatedConvolution`` (exact types)
    child of a Sequential-style container, children keyed ``"0".."n"``
    and nested containers walked, is swapped for its int8 twin with the
    trained weights quantized.  All or nothing: on any exception the
    swaps made so far are undone, in reverse, before it propagates.
    Returns the model, in eval mode, with its fused eval plan
    (``nn/fused.py``).

    For the non-mutating serving path (every container, ``TransformerLM``,
    a ``select`` predicate, the fp32 original kept) use
    :func:`quantize_model`."""
    from bigdl_tpu_torch.nn.fused import attach

    undo = []
    try:
        _quantize_children(model, undo)
    except BaseException:
        for fn in reversed(undo):
            fn()
        raise
    return attach(model).eval()


def _swap_child(module, key, q, undo):
    old = module._modules[key]

    def revert(m=module, k=key, o=old):
        m._modules[k] = o

    undo.append(revert)
    module._modules[key] = q


def _quantize_children(module, undo):
    from bigdl_tpu_torch.nn.conv import (SpatialConvolution,
                                         SpatialDilatedConvolution)
    from bigdl_tpu_torch.nn.linear import Linear
    from bigdl_tpu_torch.nn.module import Container

    if not isinstance(module, Container):
        return
    for i, (key, child) in enumerate(list(module._modules.items())):
        if key != str(i):
            continue                 # not a Sequential-style position
        has_weight = "weight" in child._parameters
        if isinstance(child, Linear) and has_weight:
            _swap_child(module, key, QuantizedLinear(child), undo)
        elif has_weight and type(child) in (SpatialConvolution,
                                            SpatialDilatedConvolution):
            # dilated included: the int8 convolution takes the dilation
            # (reference: nn/quantized/SpatialDilatedConvolution.scala)
            _swap_child(module, key, QuantizedSpatialConvolution(child),
                        undo)
        elif isinstance(child, Container):
            _quantize_children(child, undo)


# --------------------------------------------------------------------------- #
# The serving-path rewrite
# --------------------------------------------------------------------------- #

#: parameter keys of the quantizable sites: (fp32 weight, int8 payload,
#: per-output-channel scale, the output channel's axis); the fused qkv and
#: the output projection of attention contract in int8 too, a
#: convolution's HWIO weight has its output channels last; biases stay
#: fp32
_LINEAR_SITES = (("weight", "weight_q", "scale", 0),)
_CONV_SITES = (("weight", "weight_q", "scale", 3),)
_MHA_SITES = (("qkv_weight", "qkv_weight_q", "qkv_scale", 0),
              ("out_weight", "out_weight_q", "out_scale", 0))


def _quantize_sites(params, sites, device, lead):
    """``lead``: stacked leading axes (1 inside ``ScanLayers``), each
    layer quantized per output channel on its own."""
    out = {k: _to_tensor(v, device) for k, v in params.items()}
    for fp_key, q_key, s_key, axis in sites:
        out[q_key], out[s_key] = quantize_channelwise(out.pop(fp_key),
                                                      lead + axis, lead)
    return out


def _to_tensor(leaf, device):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to(device)
    return torch.as_tensor(leaf, device=device)


def quantize_params(model: Module, params=None,
                    select: Optional[Callable] = None):
    """Post-training weight quantization of a parameter tree -> a NEW
    tree (the input is never changed).

    Walks ``model``'s modules in parallel with ``params`` (default: the
    model's own ``parameters_tree()``) and rewrites each quantizable
    site, matched by exact type as in JAX (:318-390): ``Linear``
    (``weight`` -> ``weight_q`` + ``scale``, channel axis 0),
    ``SpatialConvolution`` and ``SpatialDilatedConvolution`` (HWIO,
    channel axis 3; subclasses such as ``SpaceToDepthStem`` stay fp32) and
    ``MultiHeadAttention`` (``qkv_weight`` and ``out_weight``).
    Everything else passes through fp32.  Inside ``ScanLayers`` the
    stacked leaves quantize per layer and per output channel (one more
    leading axis), as the JAX walk's ``lead_axes`` do.  ``select(path,
    module) -> bool`` keeps a site fp32 when it returns False (paths
    like ``"block0.fc1"``, ``"block0.attn"`` or ``"blocks.attn"``)."""
    # the layers import this module for int8_matmul
    from bigdl_tpu_torch.nn.attention import MultiHeadAttention
    from bigdl_tpu_torch.nn.containers import ScanLayers
    from bigdl_tpu_torch.nn.conv import (SpatialConvolution,
                                         SpatialDilatedConvolution)
    from bigdl_tpu_torch.nn.linear import Linear

    sites_of = {Linear: _LINEAR_SITES, SpatialConvolution: _CONV_SITES,
                SpatialDilatedConvolution: _CONV_SITES,
                MultiHeadAttention: _MHA_SITES}
    if params is None:
        params = model.parameters_tree()
    device = next(model.parameters()).device

    def walk(m, p, path, lead):
        if not isinstance(p, dict):
            return p
        sites = sites_of.get(type(m))
        if sites is not None and sites[0][0] in p:
            if select is None or select(path, m):
                return _quantize_sites(p, sites, device, lead)
            return p
        lead += isinstance(m, ScanLayers)
        # the module's OWN leaves (wte, wpe, head) stay fp32
        return {k: v if k not in m._modules else
                walk(m._modules[k], v, f"{path}.{k}" if path else k, lead)
                for k, v in p.items()}

    return walk(model, params, "", 0)


def _bind(module, tree):
    """Give ``module`` (and its children) exactly the leaves of ``tree``
    as its parameters, each a fresh tensor owned by the module."""
    for key, val in tree.items():
        if isinstance(val, dict):
            _bind(module._modules[key], val)
    leaves = {k: v for k, v in tree.items() if not isinstance(v, dict)}
    module._parameters.clear()
    for key, val in leaves.items():
        module._parameters[key] = torch.nn.Parameter(
            val.detach().clone(), requires_grad=False)


def quantize_model(model: Module, params=None,
                   select: Optional[Callable] = None):
    """Post-training quantization for serving -> ``(qmodel, qparams)``.

    ``qparams`` is :func:`quantize_params` of ``params`` (default: the
    model's weights); ``qmodel`` is a copy of ``model``'s module tree
    holding ``qparams`` (int8 payloads and fp32 scales at the quantized
    sites, copies of the other leaves), in eval mode, with its fused eval
    plan (``nn/fused.py``).  ``model`` is not changed and the two share no
    tensor."""
    from bigdl_tpu_torch.nn.fused import attach

    qparams = quantize_params(model, params, select)
    # copy the modules without their fp32 tensors: each parameter maps
    # to None in the memo, then _bind installs the quantized tree
    memo = {id(p): None for p in model.parameters()}
    qmodel = copy.deepcopy(model, memo)
    _bind(qmodel, qparams)
    attach(qmodel).eval()
    return qmodel, qparams


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def quantized_leaf_count(params) -> int:
    """Number of int8 leaves in a tree (0 = nothing quantized)."""
    return sum(1 for leaf in _leaves(params)
               if getattr(leaf, "dtype", None) == torch.int8)


def model_bytes(params) -> int:
    """Bytes of every leaf of a parameter tree."""
    return sum(leaf.numel() * leaf.element_size()
               for leaf in _leaves(params))
