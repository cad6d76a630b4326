"""Int8 post-training quantization for serving (counterpart of
``bigdl_tpu/nn/quantized.py``: the kernels :55-107 and the serving-path
rewrite :289-433).

Weights are quantized per output channel (symmetric, absmax / 127);
activations per tensor at run time, over every row of the step.  The
contraction is exact in int32, as ``lax.dot_general(...,
preferred_element_type=jnp.int32)`` in the JAX package: ``torch._int_mm``
takes int8 operands and returns int32 on the CPU and on the card.  It is a
plain matrix product, not a TPU kernel, so the port has no kernel of its
own for it.

``quantize_model(model)`` returns the int8 TWIN: a copy of the module
tree whose ``Linear`` and ``MultiHeadAttention`` sites hold
``weight_q``/``scale`` (``qkv_weight_q``/``qkv_scale``,
``out_weight_q``/``out_scale``) int8 and fp32 tensors under the JAX key
names, so a JAX quantized tree loads into it key by key; every other
leaf (embeddings, the LM head, LayerNorms, biases) stays fp32.  The
layers' own ``forward`` take the int8 path when they hold ``weight_q``.
The twin shares no tensor and no state with the fp32 model: a serving
engine that drafts with it must never end up verifying with itself.
"""

import copy
from typing import Callable, Optional

import torch

from bigdl_tpu_torch.nn.module import Module


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
    ``(x_int8, scale)``, the scale over EVERY element of ``x``."""
    x32 = x.to(torch.float32)
    scale = x32.abs().amax().clamp_min(1e-8) / 127.0
    x_q = torch.round(x32 / scale).clamp(-127, 127).to(torch.int8)
    return x_q, scale


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


# --------------------------------------------------------------------------- #
# The serving-path rewrite
# --------------------------------------------------------------------------- #

#: parameter keys of the quantizable sites: (fp32 weight, int8 payload,
#: per-output-channel scale); the fused qkv and the output projection of
#: attention contract in int8 too; biases stay fp32
_LINEAR_SITES = (("weight", "weight_q", "scale"),)
_MHA_SITES = (("qkv_weight", "qkv_weight_q", "qkv_scale"),
              ("out_weight", "out_weight_q", "out_scale"))


def _quantize_sites(params, sites, device):
    out = {k: _to_tensor(v, device) for k, v in params.items()}
    for fp_key, q_key, s_key in sites:
        out[q_key], out[s_key] = quantize_channelwise(out.pop(fp_key), 0)
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
    site: ``Linear`` (``weight`` -> ``weight_q`` + ``scale``) and
    ``MultiHeadAttention`` (``qkv_weight`` and ``out_weight``).
    Everything else passes through fp32.  ``select(path, module) ->
    bool`` keeps a site fp32 when it returns False (paths like
    ``"block0.fc1"`` or ``"block0.attn"``)."""
    # the layers import this module for int8_matmul
    from bigdl_tpu_torch.nn.attention import MultiHeadAttention
    from bigdl_tpu_torch.nn.linear import Linear

    sites_of = {Linear: _LINEAR_SITES, MultiHeadAttention: _MHA_SITES}
    if params is None:
        params = model.parameters_tree()
    device = next(model.parameters()).device

    def walk(m, p, path):
        if not isinstance(p, dict):
            return p
        sites = sites_of.get(type(m))
        if sites is not None and sites[0][0] in p:
            if select is None or select(path, m):
                return _quantize_sites(p, sites, device)
            return p
        # the module's OWN leaves (wte, wpe, head) stay fp32
        return {k: v if k not in m._modules else
                walk(m._modules[k], v, f"{path}.{k}" if path else k)
                for k, v in p.items()}

    return walk(model, params, "")


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
    sites, copies of the other leaves), in eval mode.  ``model`` is not
    changed and the two share no tensor."""
    qparams = quantize_params(model, params, select)
    # copy the modules without their fp32 tensors: each parameter maps
    # to None in the memo, then _bind installs the quantized tree
    memo = {id(p): None for p in model.parameters()}
    qmodel = copy.deepcopy(model, memo)
    _bind(qmodel, qparams)
    qmodel.eval()
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
