"""Fused softmax cross-entropy: two hand-written CUDA kernels
(``csrc/cross_entropy.cu``) and their plain PyTorch versions.

Counterpart of ``bigdl_tpu/ops/cross_entropy.py``:

- K4 ``fused_softmax_cross_entropy_fwd(logits, labels)`` -> per-row
  ``(loss, lse)``, ``lse = m + log(max(sum exp(x - m), 1e-30))`` and
  ``loss = lse - x[y]``;
- K5 ``fused_softmax_cross_entropy_bwd(logits, labels, lse, g)`` ->
  ``dx = (exp(x - lse) - onehot(y)) * g[:, None]`` in the logits' dtype.

``fused_softmax_cross_entropy(logits, labels)`` is the differentiable
public function (``FusedSoftmaxCrossEntropy``: the forward keeps ``lse``
for the backward).  As in the TPU kernel, a label outside ``[0, V)``
picks no logit (``x[y]`` counts as 0) and no one-hot entry; the
criterion clips labels before it gets here.

``vocab_parallel_cross_entropy(logits, labels, offset, collectives)`` is
its form for a vocabulary-sharded LM head (tensor parallelism, each rank
holding the ``(N, V / P)`` logits of classes ``[offset, offset + V /
P)``): the labels are shifted by ``offset``, a label outside the shard
becomes the sentinel -1 (``shard_labels``), K4's shard pass
(``fused_softmax_cross_entropy_shard_fwd``) gives the local lse and the
picked logit (0 off the shard), three ``(N,)`` all-reductions over the
ranks give the global lse and picked logit -- what GSPMD computes for
a logsumexp over a sharded vocabulary -- and K5 runs on the shard with
the global lse.  No rank holds the whole ``(N, V)`` logits.

Each wrapper sends CPU tensors to its ``*_reference`` version and CUDA
tensors to its kernel, and raises on anything the kernel does not take.
Unlike the TPU kernels, the CUDA kernels take any N and V (the ragged
vocabulary end is masked in the kernel, no padding copy).  ``LAUNCHES``
counts kernel launches per wrapper, through ``flash_attention``'s
``count_launch`` (so a graph capture records them, whatever thread
launches, and each replay adds them).
"""

import torch

from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops.flash_attention import (_raise_on, _stream,
                                                  count_launch,
                                                  register_launch_table)

#: kernel launches per wrapper since the last ``reset_launch_counts()``
LAUNCHES = {"fused_softmax_cross_entropy": 0,
            "fused_softmax_cross_entropy_bwd": 0,
            "fused_softmax_cross_entropy_shard": 0,
            "fused_softmax_cross_entropy_bwd_shard": 0}

register_launch_table("cross_entropy", LAUNCHES)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# --------------------------------------------------------------------------- #
# Plain versions
# --------------------------------------------------------------------------- #

def _acc(x):
    """Accumulation dtype: fp32, or fp64 for the finite-difference checks."""
    return x.double() if x.dtype == torch.float64 else x.float()


def _picked(x, labels):
    """``x[i, labels[i]]``, 0 where the label is outside ``[0, V)``."""
    v = x.shape[1]
    y = labels.long()
    valid = (y >= 0) & (y < v)
    xy = x.gather(1, y.clamp(0, v - 1)[:, None])[:, 0]
    return torch.where(valid, xy, torch.zeros_like(xy))


def fused_softmax_cross_entropy_reference(logits, labels):
    """``(loss, lse)``, both ``(N,)`` fp32 (fp64 for fp64 logits), with
    the kernel's ``-inf``-guarded logsumexp."""
    x = _acc(logits)
    m = x.amax(dim=1)
    safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = torch.exp(x - safe[:, None]).sum(dim=1)
    lse = safe + torch.log(s.clamp_min(1e-30))
    return lse - _picked(x, labels), lse


def fused_softmax_cross_entropy_shard_reference(logits, labels):
    """K4's shard pass, plain: ``(lse, picked)`` over the shard, both
    ``(N,)`` fp32; ``picked`` is 0 where the (shard-local) label is
    outside ``[0, V_shard)``."""
    loss, lse = fused_softmax_cross_entropy_reference(logits, labels)
    return lse, _picked(_acc(logits), labels)


def fused_softmax_cross_entropy_grad_reference(logits, labels, lse, g):
    """``(exp(x - lse) - onehot(y)) * g[:, None]`` in the logits' dtype."""
    x = _acc(logits)
    cols = torch.arange(x.shape[1], device=x.device)
    onehot = (cols[None, :] == labels.long()[:, None]).to(x.dtype)
    dx = (torch.exp(x - lse[:, None]) - onehot) * g.to(x.dtype)[:, None]
    return dx.to(logits.dtype)


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #

def _on_cpu(*ts):
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in ts}) != 1:
        raise ValueError(
            f"cross-entropy inputs must all lie on the CPU (plain version) "
            f"or on one CUDA device (kernel), got "
            f"{[str(t.device) for t in ts]}")
    return False


def _check(name, logits, labels):
    if logits.dtype not in _DTYPES:
        raise TypeError(f"{name}: logits must be float32 or bfloat16, got "
                        f"{logits.dtype}")
    if logits.dim() != 2 or logits.stride(1) != 1:
        raise ValueError(f"{name}: need (N, V) logits with unit column "
                         f"stride, got shape {tuple(logits.shape)} strides "
                         f"{logits.stride()}")
    if labels.shape != (logits.shape[0],):
        raise ValueError(f"{name}: need (N,) labels, got "
                         f"{tuple(labels.shape)}")


def _int32(labels):
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"labels must be int32 or int64, got {labels.dtype}")
    return labels.to(torch.int32).contiguous()


def fused_softmax_cross_entropy_fwd(logits, labels):
    """K4: ``(N, V)`` logits and ``(N,)`` labels -> ``(loss, lse)``,
    both ``(N,)`` fp32."""
    if _on_cpu(logits, labels):
        return fused_softmax_cross_entropy_reference(logits, labels)
    name = "fused_softmax_cross_entropy"
    _check(name, logits, labels)
    n, v = logits.shape
    y = _int32(labels)
    loss = torch.empty(n, dtype=torch.float32, device=logits.device)
    lse = torch.empty(n, dtype=torch.float32, device=logits.device)
    if n == 0:
        return loss, lse
    rc = _build.load().bigdl_ce_fwd(
        logits.data_ptr(), y.data_ptr(), loss.data_ptr(), lse.data_ptr(),
        _DTYPES[logits.dtype], n, v, logits.stride(0), _stream())
    _raise_on(rc, name)
    count_launch("cross_entropy", name)
    return loss, lse


def fused_softmax_cross_entropy_shard_fwd(logits, labels):
    """K4's shard pass: ``(N, V_shard)`` logits and shard-local ``(N,)``
    labels (-1: the target lies in another shard) -> ``(lse, picked)``,
    both ``(N,)`` fp32.  The kernel reads ``logits[i, labels[i]]`` only
    for a label inside the shard."""
    if _on_cpu(logits, labels):
        return fused_softmax_cross_entropy_shard_reference(logits, labels)
    name = "fused_softmax_cross_entropy_shard"
    _check(name, logits, labels)
    n, v = logits.shape
    y = _int32(labels)
    dev = logits.device
    loss = torch.empty(n, dtype=torch.float32, device=dev)
    lse = torch.empty(n, dtype=torch.float32, device=dev)
    picked = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return lse, picked
    rc = _build.load().bigdl_ce_fwd_shard(
        logits.data_ptr(), y.data_ptr(), loss.data_ptr(), lse.data_ptr(),
        picked.data_ptr(), _DTYPES[logits.dtype], n, v, logits.stride(0),
        _stream())
    _raise_on(rc, name)
    count_launch("cross_entropy", name)
    return lse, picked


def fused_softmax_cross_entropy_bwd(logits, labels, lse, g,
                                    name="fused_softmax_cross_entropy_bwd"):
    """K5: the gradient of the per-row losses, scaled per row by the
    upstream ``g (N,)`` -> ``(N, V)`` in the logits' dtype.  ``name`` is
    the launch count it adds to (the vocabulary shard's route has its
    own)."""
    if _on_cpu(logits, labels, lse, g):
        return fused_softmax_cross_entropy_grad_reference(logits, labels,
                                                          lse, g)
    _check(name, logits, labels)
    n, v = logits.shape
    if lse.shape != (n,) or g.shape != (n,):
        raise ValueError(f"{name}: need (N,) lse and g, got "
                         f"{tuple(lse.shape)}, {tuple(g.shape)}")
    y = _int32(labels)
    lse = lse.float().contiguous()
    g = g.float().contiguous()      # a mean's g is an expanded 1/N
    dx = torch.empty((n, v), dtype=logits.dtype, device=logits.device)
    if n == 0:
        return dx
    rc = _build.load().bigdl_ce_bwd(
        logits.data_ptr(), y.data_ptr(), lse.data_ptr(), g.data_ptr(),
        dx.data_ptr(), _DTYPES[logits.dtype], n, v, logits.stride(0),
        dx.stride(0), _stream())
    _raise_on(rc, name)
    count_launch("cross_entropy", name)
    return dx


class FusedSoftmaxCrossEntropy(torch.autograd.Function):
    """Per-row losses (K4) whose backward is K5; ``lse`` is kept from the
    forward, so the backward reads the logits once more and nothing
    else of size (N, V)."""

    @staticmethod
    def forward(ctx, logits, labels):
        loss, lse = fused_softmax_cross_entropy_fwd(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return fused_softmax_cross_entropy_bwd(logits, labels, lse, g), None


def fused_softmax_cross_entropy(logits, labels):
    """``(N, V)`` logits + ``(N,)`` int labels -> per-row loss ``(N,)``
    fp32, differentiable in the logits."""
    return FusedSoftmaxCrossEntropy.apply(logits, labels)


def shard_labels(labels, offset, v_shard):
    """Global labels -> the shard's: ``labels - offset`` inside ``[0,
    v_shard)``, the sentinel -1 elsewhere; int32."""
    local = labels.long() - int(offset)
    inside = (local >= 0) & (local < v_shard)
    return torch.where(inside, local, torch.full_like(local, -1)).to(
        torch.int32)


def combine_shard_stats(lse, picked, collectives):
    """The shards' ``(lse, picked)`` -> the global ones, by three ``(N,)``
    all-reductions over ``collectives``: the maximum of the local lse,
    the sum of ``exp(lse - max)`` and the sum of the picked logits (one
    shard holds each row's target, the others add 0)."""
    m = collectives.pmax(lse)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = collectives.psum(torch.exp(lse - m))
    return m + torch.log(s.clamp_min(1e-30)), collectives.psum(picked)


class VocabParallelCrossEntropy(torch.autograd.Function):
    """Per-row losses over a vocabulary-sharded ``(N, V / P)`` logits
    shard (module docstring); the backward is K5 on the shard with the
    global lse, so the gradient stays sharded."""

    @staticmethod
    def forward(ctx, logits, labels, offset, collectives):
        local = shard_labels(labels, offset, logits.shape[1])
        lse, picked = fused_softmax_cross_entropy_shard_fwd(logits, local)
        lse, picked = combine_shard_stats(lse, picked, collectives)
        ctx.save_for_backward(logits, local, lse)
        return lse - picked

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        logits, local, lse = ctx.saved_tensors
        dx = fused_softmax_cross_entropy_bwd(
            logits, local, lse, g,
            name="fused_softmax_cross_entropy_bwd_shard")
        return dx, None, None, None


def vocab_parallel_cross_entropy(logits, labels, offset, collectives):
    """``(N, V / P)`` logits of the classes ``[offset, offset + V / P)``
    and ``(N,)`` global labels in ``[0, V)`` -> the per-row loss ``(N,)``
    fp32 over the whole vocabulary, on every rank of ``collectives``;
    differentiable in the shard."""
    return VocabParallelCrossEntropy.apply(logits, labels, int(offset),
                                           collectives)
