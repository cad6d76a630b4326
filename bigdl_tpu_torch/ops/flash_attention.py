"""Flash attention: four hand-written CUDA kernels
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``) and their
plain PyTorch versions.

Counterpart of ``bigdl_tpu/ops/flash_attention.py``, with the same
``(B, T, H, D)`` layout at every public function:

- ``flash_attention(q, k, v, causal)``: full or causal attention (K1),
  differentiable: with grad enabled it runs through ``FlashAttention``,
  whose forward also writes each row's logsumexp and whose backward is
  the K1-bwd kernel (``flash_attention_bwd``);
- ``flash_decode_attention(q, k, v, pos)``: one query row per batch row
  against a contiguous cache, masked at ``kpos <= pos[b]`` (K2);
- ``flash_paged_decode_attention(q, k_pool, v_pool, tables, pos)``: the
  same through per-row block tables into a ``(NB, bs, H, D)`` pool (K3);
  with ``k_scale``/``v_scale`` the pools are int8 with one fp32 scale per
  (position, head) vector, dequantized inside the kernel, and the output
  is fp32 (K3q, the TPU kernel's ``quantized=True`` path).

Each wrapper sends a CPU tensor to its ``*_reference`` version and a CUDA
tensor to its kernel; it raises on anything the kernel does not take
(there is no fallback).  ``LAUNCHES`` counts kernel launches per wrapper,
so a run can show that its main path went through the kernels, and
``BF16_LAUNCHES`` the bf16 share of K1's and K1-bwd's.  A CUDA graph
capture issues no launch: inside ``deferred_launch_counts()`` every
launch issued to the capturing stream, from any thread (the autograd
engine runs a backward on a thread of its own, on the stream its forward
ran on), is recorded instead of counted, and every replay of the graph
adds that record (``add_launch_counts``).  ``ops/cross_entropy.py``
counts through the same machinery (``count_launch``).

Unlike the TPU kernels, the CUDA kernels mask ragged edges themselves:
any sequence length, cache length and block size is taken.
"""

import contextlib
import ctypes
import functools
import math

import torch

from bigdl_tpu_torch.ops import _build

#: kernel launches per wrapper since the last ``reset_launch_counts()``
LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0,
            "flash_decode_attention": 0, "flash_paged_decode_attention": 0,
            "flash_paged_decode_attention_int8": 0}

#: of ``LAUNCHES``, those with bf16 inputs (the m16n8k16 instantiations)
BF16_LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}

HEAD_DIMS = (16, 32, 64, 96, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


#: count tables by name: a record keeps its launches under these names
_TABLES = {"flash_attention": LAUNCHES, "flash_attention_bf16": BF16_LAUNCHES}
#: capturing stream (its ``cuda_stream`` handle) -> the record its
#: launches go to
_recording = {}


def register_launch_table(table, counts):
    """Count under the name ``table`` into ``counts``, a dict of kernel
    name -> launches, for ``count_launch`` and the records."""
    _TABLES[table] = counts


def reset_launch_counts():
    for counts in (LAUNCHES, BF16_LAUNCHES):
        for name in counts:
            counts[name] = 0


def count_launch(table, name):
    """One launch of kernel ``name`` into count table ``table``, or into
    the record of the current stream while it is being captured."""
    counts = _TABLES[table]
    if _recording:
        record = _recording.get(torch.cuda.current_stream().cuda_stream)
        if record is not None:
            counts = record.setdefault(table, {})
    counts[name] = counts.get(name, 0) + 1


def _count_launch(name, dtype):
    count_launch("flash_attention", name)
    if dtype == torch.bfloat16 and name in BF16_LAUNCHES:
        count_launch("flash_attention_bf16", name)


@contextlib.contextmanager
def deferred_launch_counts():
    """Launches issued to the current stream inside the block, by any
    thread, are recorded in the yielded ``{table: {kernel: launches}}``
    dict instead of counted: under CUDA graph capture nothing is launched
    until the graph is replayed."""
    handle = torch.cuda.current_stream().cuda_stream
    record = {}
    outer = _recording.get(handle)
    _recording[handle] = record
    try:
        yield record
    finally:
        if outer is None:
            del _recording[handle]
        else:
            _recording[handle] = outer


def add_launch_counts(record, into=None):
    """Add a ``deferred_launch_counts`` record to the count tables (the
    launches of one replay of the graph whose capture recorded it), or,
    with ``into``, to another record."""
    for table, add in record.items():
        counts = _TABLES[table] if into is None else \
            into.setdefault(table, {})
        for name, n in add.items():
            counts[name] = counts.get(name, 0) + n


# --------------------------------------------------------------------------- #
# Plain versions
# --------------------------------------------------------------------------- #

def masked_attention(q, k, v, mask=None, scale=None):
    """The one plain attention body of the port (``nn.attention``'s
    ``dot_product_attention`` and the ``*_reference`` versions below):
    fp32 softmax (fp64 for fp64 inputs, which finite-difference checks
    use) with the kernels' -inf-safe normalisation, so a row that sees no
    key gives zeros, not NaN.  q ``(..., Tq, H, D)``, k/v
    ``(..., Tk, H, D)``, ``mask`` (True = visible) broadcastable to
    ``(..., H, Tq, Tk)``."""
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    s = torch.einsum("...qhd,...khd->...hqk", q.to(ct) * scale, k.to(ct))
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    if mask is not None:
        p = p * mask
    out = torch.einsum("...hqk,...khd->...qhd", p, v.to(ct))
    l = p.sum(dim=-1).transpose(-1, -2).unsqueeze(-1)
    return (out / l.clamp_min(1e-30)).to(q.dtype)


def causal_mask(tq, tk, device):
    """``(Tq, Tk)``, True where key position <= query position."""
    return (torch.arange(tk, device=device)[None, :]
            <= torch.arange(tq, device=device)[:, None])


def flash_attention_reference(q, k, v, causal=True):
    mask = causal_mask(q.shape[1], k.shape[1], q.device) if causal else None
    return masked_attention(q, k, v, mask)


def flash_attention_bwd_reference(q, k, v, dout, causal=True):
    """``(dq, dk, dv)``: autograd of the plain version."""
    with torch.enable_grad():
        qkv = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out = flash_attention_reference(*qkv, causal)
        return torch.autograd.grad(out, qkv, dout)


def flash_decode_attention_reference(q, k, v, pos):
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = kpos[None, :] <= pos.long()[:, None]
    return masked_attention(q, k, v, mask[:, None, None, :])


def flash_paged_decode_attention_reference(q, k_pool, v_pool, tables, pos,
                                           k_scale=None, v_scale=None):
    """Gathers each row's mapped context; an int8 pool is dequantized
    after the gather (``payload * scale``, as ``dequantize_blockwise``)
    and gives fp32, as the kernel does."""
    b, mb = tables.shape
    bs = k_pool.shape[1]
    ctx = mb * bs
    t = tables.long()
    k = k_pool[t].reshape(b, ctx, *k_pool.shape[2:])
    v = v_pool[t].reshape(b, ctx, *v_pool.shape[2:])
    if k_scale is None:
        return flash_decode_attention_reference(q, k, v, pos)
    k = k.float() * k_scale[t].reshape(b, ctx, *k_scale.shape[2:])
    v = v.float() * v_scale[t].reshape(b, ctx, *v_scale.shape[2:])
    return flash_decode_attention_reference(q.float(), k, v, pos)


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
                        f"dtype, got {[t.dtype for t in ts]} (no kernel "
                        f"takes float16: ROADMAP A1)")
    d = ts[0].shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} has no kernel "
                         f"instantiation (have {HEAD_DIMS})")
    for t in ts:
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head_dim axis must be contiguous "
                             f"(stride 1), got strides {t.stride()}")


def _check_vector_rows(name, *ts, width=4):
    """The decode kernels read K rows ``width`` elements at a time: four
    fp32/bf16 values, or sixteen int8 values (one 16-byte load)."""
    for t in ts:
        if t.stride(-1) != 1 or t.data_ptr() % (width * t.element_size()) \
                or any(s % width for s in t.stride()[:-1]):
            raise ValueError(f"{name}: K/V rows must be contiguous and start "
                             f"on {width}-element boundaries (strides "
                             f"{t.stride()})")


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


def _check_attention(name, q, k, v):
    _check_float(name, q, k, v)
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"{name}: q, k, v must share one (B, T, H, D) "
                         f"shape, got {q.shape}, {k.shape}, {v.shape}")


#: streaming multiprocessors of the H100 SXM: the count the grid sizes
#: below are stated and tested at; a launch reads its card's own
#: (``sm_count``)
H100_SXM_SMS = 132


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device):
    """The streaming multiprocessors of CUDA ``device``, which K1's, K2's
    and K3's grids should fill (132 on an H100 SXM, 114 on an H100
    PCIe); read from the card once per device."""
    device = torch.device(device)
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return _sm_count(index)


def query_tile_rows(b, h, t, sms=H100_SXM_SMS):
    """K1's query rows a block: 64 (four warps), or 16 (one warp) when the
    64-row grid of ``b * h * ceil(t / 64)`` blocks would leave some of the
    ``sms`` SMs idle, as at B1 T200 H12 on 132 (48 blocks; 156 with 16
    rows)."""
    return 16 if b * h * -(-t // 64) < sms else 64


#: key positions a tile of K2/K3/K3q (``kPgTile`` in
#: csrc/flash_attention.cu)
DECODE_TILE = 32
#: K2/K3/K3q's largest split count: the portable thread-block cluster size
DECODE_MAX_SPLITS = 8


def decode_splits(bh, limit, sms=H100_SXM_SMS):
    """The split count S of K2, K3 and K3q: each of the ``bh = B * H`` rows
    is read by the S blocks of one cluster, each taking every S-th tile of
    the row's visible positions.  About three blocks an SM,
    ``3 * sms // bh`` (the kernels' 48 KB ring lets three share an SM),
    from 1 to ``DECODE_MAX_SPLITS``, and no more than the tiles of the
    addressable length ``limit`` (K2: the cache's T; K3:
    ``tables.shape[1] * bs``).  On 132 SMs, B8 H12 gives 4 (384 blocks),
    B9 H12 3 (324) and B1 H12 8; on 114 SMs (H100 PCIe) B8 H12 gives 3,
    short of the residency cliff that 4 would cross there.  One rule
    serves all three kernels: forced from 1 to 8 on the H100
    (``tools/torch_decode_splits.py``), K2 and K3 rank the split counts
    alike at the same B * H, at 8 rows and at 9."""
    tiles = -(-limit // DECODE_TILE)
    return max(1, min(DECODE_MAX_SPLITS, 3 * sms // max(bh, 1), tiles))


def _flash_forward(q, k, v, causal, with_lse):
    """Launch K1; ``with_lse`` also returns the rows' logsumexp
    ``(B, H, T)`` fp32 for the backward."""
    _check_attention("flash_attention", q, k, v)
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if t == 0 or b * h == 0:
        return out, lse
    s = [x.stride()[i] for x in (q, k, v, out) for i in (0, 1, 2)]
    rc = _build.load().bigdl_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], b, t, h, d, _strides(*s),
        int(bool(causal))
        | (2 if query_tile_rows(b, h, t, sm_count(q.device)) == 16 else 0),
        1.0 / math.sqrt(d), None if lse is None else lse.data_ptr(),
        _stream())
    _raise_on(rc, "flash_attention")
    _count_launch("flash_attention", q.dtype)
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, causal=True):
    """Gradient of ``flash_attention``: q, k, v, its output ``out``, the
    rows' logsumexp ``lse (B, H, T)`` fp32 from the forward and ``dout``
    -> ``(dq, dk, dv)``, each ``(B, T, H, D)`` in the inputs' dtype.
    CPU tensors take autograd of the plain version (``out`` and ``lse``
    are not needed there)."""
    if _on_cpu(q, k, v, dout):
        return flash_attention_bwd_reference(q, k, v, dout, causal)
    name = "flash_attention_bwd"
    _check_attention(name, q, k, v)
    _check_float(name, q, out, dout)
    b, t, h, d = q.shape
    if out.shape != q.shape or dout.shape != q.shape or \
            lse.shape != (b, h, t) or lse.dtype != torch.float32 or \
            not lse.is_contiguous():
        raise ValueError(f"{name}: need out and dout {tuple(q.shape)} and "
                         f"a contiguous fp32 lse {(b, h, t)}, got "
                         f"{tuple(out.shape)}, {tuple(dout.shape)}, "
                         f"{tuple(lse.shape)} {lse.dtype}")
    grads = [torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
             for _ in range(3)]
    if t == 0 or b * h == 0:
        return tuple(grads)
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    s = [x.stride()[i] for x in (q, k, v, out, dout, *grads)
         for i in (0, 1, 2)]
    rc = _build.load().bigdl_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        *(g.data_ptr() for g in grads), _DTYPES[q.dtype], b, t, h, d,
        _strides(*s), int(bool(causal)), 1.0 / math.sqrt(d), _stream())
    _raise_on(rc, name)
    _count_launch(name, q.dtype)
    return tuple(grads)


class FlashAttention(torch.autograd.Function):
    """K1 with its gradient.  On CUDA tensors the forward launches K1 and
    keeps its output and row logsumexp, and the backward launches K1-bwd;
    on CPU tensors the forward is the plain version and the backward is
    autograd of it."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v)
            return flash_attention_reference(q, k, v, causal)
        out, lse = _flash_forward(q, k, v, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        # read once: under a non-reentrant checkpoint each read unpacks
        # (recomputes) the saved tensors
        saved = ctx.saved_tensors
        if len(saved) == 3:
            grads = flash_attention_bwd_reference(*saved, dout, ctx.causal)
        else:
            grads = flash_attention_bwd(*saved, dout, ctx.causal)
        return (*grads, None)


def flash_attention(q, k, v, causal=True):
    """q, k, v ``(B, T, H, D)`` -> ``(B, T, H, D)``; differentiable in
    q, k and v when grad is enabled (``FlashAttention``)."""
    on_cpu = _on_cpu(q, k, v)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal)
    if on_cpu:
        return flash_attention_reference(q, k, v, causal)
    return _flash_forward(q, k, v, causal, with_lse=False)[0]


def flash_decode_attention(q, k, v, pos):
    """q ``(B, 1, H, D)`` against a cache ``k, v (B, T, H, D)`` with
    frontier positions ``pos (B,)`` int32 -> ``(B, 1, H, D)``.  Only the
    ``min(pos + 1, T)`` visible positions of a row are read, by the
    ``decode_splits`` blocks of one cluster."""
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
    t = k.shape[1]
    rc = _build.load().bigdl_flash_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        pos.data_ptr(), _DTYPES[q.dtype], b, h, d, t, _strides(*s),
        1.0 / math.sqrt(d), decode_splits(b * h, t, sm_count(q.device)),
        _stream())
    _raise_on(rc, name)
    _count_launch(name, q.dtype)
    return out


def _check_paged(name, q, k_pool, v_pool, tables, pos):
    b, t1, h, d = q.shape
    if t1 != 1 or k_pool.shape != v_pool.shape or k_pool.dim() != 4 or \
            k_pool.shape[2:] != (h, d) or tables.dim() != 2 or \
            tables.shape[0] != b or pos.shape != (b,):
        raise ValueError(f"{name}: need q (B, 1, H, D), pools (NB, bs, H, "
                         f"D), tables (B, MB), pos (B,), got {q.shape}, "
                         f"{k_pool.shape}, {tables.shape}, {pos.shape}")


def flash_paged_decode_attention(q, k_pool, v_pool, tables, pos,
                                 k_scale=None, v_scale=None):
    """q ``(B, 1, H, D)`` against pools ``(NB, bs, H, D)`` addressed by
    block tables ``(B, MB)`` int32 at frontier ``pos (B,)`` int32 ->
    ``(B, 1, H, D)``.  Only the ``ceil((pos + 1) / bs)`` blocks a row
    has mapped are read.

    ``k_scale``/``v_scale`` (both or neither, ``(NB, bs, H, 1)`` fp32)
    select the int8 pool layout: the pools are int8, each row is
    dequantized inside the kernel (K3q) and the output is fp32."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale or neither")
    if k_scale is not None:
        return _paged_decode_int8(q, k_pool, v_pool, tables, pos, k_scale,
                                  v_scale)
    if _on_cpu(q, k_pool, v_pool, tables, pos):
        return flash_paged_decode_attention_reference(q, k_pool, v_pool,
                                                      tables, pos)
    name = "flash_paged_decode_attention"
    _check_float(name, q, k_pool, v_pool)
    _check_vector_rows(name, k_pool, v_pool)
    _check_int32(name, tables, pos)
    _check_paged(name, q, k_pool, v_pool, tables, pos)
    b, _, h, d = q.shape
    nb, bs = k_pool.shape[:2]
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    s = (q.stride(0), q.stride(2), *k_pool.stride()[:3],
         *v_pool.stride()[:3], out.stride(0), out.stride(2))
    rc = _build.load().bigdl_flash_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), out.data_ptr(),
        tables.data_ptr(), pos.data_ptr(), _DTYPES[q.dtype], b, h, d, nb,
        bs, tables.shape[1], tables.stride(0), _strides(*s),
        1.0 / math.sqrt(d),
        decode_splits(b * h, tables.shape[1] * bs, sm_count(q.device)),
        _stream())
    _raise_on(rc, name)
    _count_launch(name, q.dtype)
    return out


def _paged_decode_int8(q, k_pool, v_pool, tables, pos, k_scale, v_scale):
    """K3q: int8 pools and their scales, read in place by the kernel."""
    if _on_cpu(q, k_pool, v_pool, tables, pos, k_scale, v_scale):
        return flash_paged_decode_attention_reference(
            q, k_pool, v_pool, tables, pos, k_scale, v_scale)
    name = "flash_paged_decode_attention_int8"
    _check_float(name, q)
    _check_int32(name, tables, pos)
    _check_paged(name, q, k_pool, v_pool, tables, pos)
    b, _, h, d = q.shape
    nb, bs = k_pool.shape[:2]
    if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
        raise TypeError(f"{name}: pools must be int8 with scales, got "
                        f"{k_pool.dtype}, {v_pool.dtype}")
    _check_vector_rows(name, k_pool, v_pool, width=16)
    for t in (k_scale, v_scale):
        if t.dtype != torch.float32 or t.shape != (nb, bs, h, 1):
            raise ValueError(f"{name}: scales must be fp32 {(nb, bs, h, 1)}"
                             f", got {t.dtype} {tuple(t.shape)}")
    out = torch.empty((b, 1, h, d), dtype=torch.float32, device=q.device)
    s = (q.stride(0), q.stride(2), *k_pool.stride()[:3],
         *v_pool.stride()[:3], out.stride(0), out.stride(2),
         *k_scale.stride()[:3], *v_scale.stride()[:3])
    rc = _build.load().bigdl_flash_paged_decode_attention_int8(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), out.data_ptr(),
        tables.data_ptr(), pos.data_ptr(), _DTYPES[q.dtype], b, h, d, nb,
        bs, tables.shape[1], tables.stride(0), _strides(*s),
        1.0 / math.sqrt(d),
        decode_splits(b * h, tables.shape[1] * bs, sm_count(q.device)),
        _stream())
    _raise_on(rc, name)
    _count_launch(name, q.dtype)
    return out
