"""Flash attention for the serving path: three hand-written CUDA kernels
(``csrc/flash_attention.cu``) and their plain PyTorch versions.

Counterpart of ``bigdl_tpu/ops/flash_attention.py``, with the same
``(B, T, H, D)`` layout at every public function:

- ``flash_attention(q, k, v, causal)``: full or causal attention (K1);
- ``flash_decode_attention(q, k, v, pos)``: one query row per batch row
  against a contiguous cache, masked at ``kpos <= pos[b]`` (K2);
- ``flash_paged_decode_attention(q, k_pool, v_pool, tables, pos)``: the
  same through per-row block tables into a ``(NB, bs, H, D)`` pool (K3).

Each wrapper sends a CPU tensor to its ``*_reference`` version and a CUDA
tensor to its kernel; it raises on anything the kernel does not take
(there is no fallback).  ``LAUNCHES`` counts kernel launches per wrapper,
so a run can show that its main path went through the kernels.

Unlike the TPU kernels, the CUDA kernels mask ragged edges themselves:
any sequence length, cache length and block size is taken.
"""

import ctypes
import math

import torch

from bigdl_tpu_torch.ops import _build

#: kernel launches per wrapper since the last ``reset_launch_counts()``
LAUNCHES = {"flash_attention": 0, "flash_decode_attention": 0,
            "flash_paged_decode_attention": 0}

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# --------------------------------------------------------------------------- #
# Plain versions
# --------------------------------------------------------------------------- #

def masked_attention(q, k, v, mask=None, scale=None):
    """The one plain attention body of the port (``nn.attention``'s
    ``dot_product_attention`` and the ``*_reference`` versions below):
    fp32 softmax with the kernels' -inf-safe normalisation, so a row that
    sees no key gives zeros, not NaN.  q ``(..., Tq, H, D)``, k/v
    ``(..., Tk, H, D)``, ``mask`` (True = visible) broadcastable to
    ``(..., H, Tq, Tk)``."""
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    s = torch.einsum("...qhd,...khd->...hqk", q.float() * scale, k.float())
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    if mask is not None:
        p = p * mask
    out = torch.einsum("...hqk,...khd->...qhd", p, v.float())
    l = p.sum(dim=-1).transpose(-1, -2).unsqueeze(-1)
    return (out / l.clamp_min(1e-30)).to(q.dtype)


def causal_mask(tq, tk, device):
    """``(Tq, Tk)``, True where key position <= query position."""
    return (torch.arange(tk, device=device)[None, :]
            <= torch.arange(tq, device=device)[:, None])


def flash_attention_reference(q, k, v, causal=True):
    mask = causal_mask(q.shape[1], k.shape[1], q.device) if causal else None
    return masked_attention(q, k, v, mask)


def flash_decode_attention_reference(q, k, v, pos):
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = kpos[None, :] <= pos.long()[:, None]
    return masked_attention(q, k, v, mask[:, None, None, :])


def flash_paged_decode_attention_reference(q, k_pool, v_pool, tables, pos):
    b, mb = tables.shape
    bs = k_pool.shape[1]
    ctx = mb * bs
    t = tables.long()
    k = k_pool[t].reshape(b, ctx, *k_pool.shape[2:])
    v = v_pool[t].reshape(b, ctx, *v_pool.shape[2:])
    return flash_decode_attention_reference(q, k, v, pos)


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #

def _on_cpu(*ts):
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in ts}) != 1:
        raise ValueError(
            f"attention inputs must all lie on the CPU (plain version) or "
            f"on one CUDA device (kernel), got {[str(t.device) for t in ts]}")
    return False


def _check_float(name, *ts):
    dt = ts[0].dtype
    if dt not in _DTYPES or any(t.dtype != dt for t in ts):
        raise TypeError(f"{name}: need float32 or bfloat16 inputs of one "
                        f"dtype, got {[t.dtype for t in ts]}")
    d = ts[0].shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} has no kernel "
                         f"instantiation (have {HEAD_DIMS})")
    for t in ts:
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head_dim axis must be contiguous "
                             f"(stride 1), got strides {t.stride()}")


def _check_vector_rows(name, *ts):
    """The decode kernels read K rows four elements at a time."""
    for t in ts:
        if t.data_ptr() % (4 * t.element_size()) or \
                any(s % 4 for s in t.stride()[:-1]):
            raise ValueError(f"{name}: K/V rows must start on 4-element "
                             f"boundaries (strides {t.stride()})")


def _check_int32(name, *ts):
    for t in ts:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{name}: positions and tables must be "
                            f"contiguous int32, got {t.dtype}")


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _strides(*pairs):
    return (ctypes.c_int64 * len(pairs))(*pairs)


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {rc})")


def flash_attention(q, k, v, causal=True):
    """q, k, v ``(B, T, H, D)`` -> ``(B, T, H, D)``."""
    if _on_cpu(q, k, v):
        return flash_attention_reference(q, k, v, causal)
    _check_float("flash_attention", q, k, v)
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"flash_attention: q, k, v must share one "
                         f"(B, T, H, D) shape, got {q.shape}, {k.shape}, "
                         f"{v.shape}")
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    if t == 0 or b * h == 0:
        return out
    s = [x.stride()[i] for x in (q, k, v, out) for i in (0, 1, 2)]
    rc = _build.load().bigdl_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], b, t, h, d, _strides(*s), int(bool(causal)),
        1.0 / math.sqrt(d), _stream())
    _raise_on(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


def flash_decode_attention(q, k, v, pos):
    """q ``(B, 1, H, D)`` against a cache ``k, v (B, T, H, D)`` with
    frontier positions ``pos (B,)`` int32 -> ``(B, 1, H, D)``."""
    if _on_cpu(q, k, v, pos):
        return flash_decode_attention_reference(q, k, v, pos)
    name = "flash_decode_attention"
    _check_float(name, q, k, v)
    _check_vector_rows(name, k, v)
    _check_int32(name, pos)
    b, t1, h, d = q.shape
    if t1 != 1 or k.shape != v.shape or k.shape[0] != b or \
            k.shape[2:] != (h, d) or pos.shape != (b,):
        raise ValueError(f"{name}: need q (B, 1, H, D), k/v (B, T, H, D) "
                         f"and pos (B,), got {q.shape}, {k.shape}, "
                         f"{v.shape}, {pos.shape}")
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    s = (q.stride(0), q.stride(2), *k.stride()[:3], *v.stride()[:3],
         out.stride(0), out.stride(2))
    rc = _build.load().bigdl_flash_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        pos.data_ptr(), _DTYPES[q.dtype], b, h, d, k.shape[1],
        _strides(*s), 1.0 / math.sqrt(d), _stream())
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


def flash_paged_decode_attention(q, k_pool, v_pool, tables, pos):
    """q ``(B, 1, H, D)`` against pools ``(NB, bs, H, D)`` addressed by
    block tables ``(B, MB)`` int32 at frontier ``pos (B,)`` int32 ->
    ``(B, 1, H, D)``.  Only the ``ceil((pos + 1) / bs)`` blocks a row
    has mapped are read."""
    if _on_cpu(q, k_pool, v_pool, tables, pos):
        return flash_paged_decode_attention_reference(q, k_pool, v_pool,
                                                      tables, pos)
    name = "flash_paged_decode_attention"
    _check_float(name, q, k_pool, v_pool)
    _check_vector_rows(name, k_pool, v_pool)
    _check_int32(name, tables, pos)
    b, t1, h, d = q.shape
    nb, bs = k_pool.shape[:2]
    if t1 != 1 or k_pool.shape != v_pool.shape or \
            k_pool.shape[2:] != (h, d) or tables.dim() != 2 or \
            tables.shape[0] != b or pos.shape != (b,):
        raise ValueError(f"{name}: need q (B, 1, H, D), pools (NB, bs, H, "
                         f"D), tables (B, MB), pos (B,), got {q.shape}, "
                         f"{k_pool.shape}, {tables.shape}, {pos.shape}")
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    s = (q.stride(0), q.stride(2), *k_pool.stride()[:3],
         *v_pool.stride()[:3], out.stride(0), out.stride(2))
    rc = _build.load().bigdl_flash_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), out.data_ptr(),
        tables.data_ptr(), pos.data_ptr(), _DTYPES[q.dtype], b, h, d, nb,
        bs, tables.shape[1], tables.stride(0), _strides(*s),
        1.0 / math.sqrt(d), _stream())
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out
