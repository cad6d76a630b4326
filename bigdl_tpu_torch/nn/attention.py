"""Attention and transformer blocks (counterpart of
``bigdl_tpu/nn/attention.py``).

Layout ``(N, T, D)`` with heads split last, ``(N, T, H, Dh)``; softmax in
fp32.  Three attention modes share one ``MultiHeadAttention``:

- full sequence (``forward``), through the K1 kernel;
- contiguous KV cache (``_apply_cached``): prefill through K1, one-token
  decode through K2;
- paged KV pool (``_apply_paged``): chunk prefill through a gather and
  plain attention (as in the JAX package, which keeps it outside
  Pallas), one-token decode through K3.

``use_flash="auto"`` takes the kernel wrappers of ``ops/flash_attention``
for every shape (they launch the CUDA kernel for CUDA tensors and run
their plain version for CPU tensors); ``"never"`` takes the plain path
below (the A/B baseline on the card).  Unlike the TPU kernels the CUDA
kernels mask ragged edges themselves, so no shape gate applies.

The KV caches and pools are written IN PLACE (``copy_`` / index
assignment), where the JAX steps donate them; padding rows and padded
tokens write into the trash row or trash block, which is never read.
"""

import math
import re

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.containers import (stack_layer_trees,
                                           unstack_layer_trees)
from bigdl_tpu_torch.nn.initialization import Xavier, normal
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import Container, Module
from bigdl_tpu_torch.nn.normalization import LayerNorm
from bigdl_tpu_torch.ops import flash_attention as fa
from bigdl_tpu_torch.utils.device import resolve_device


def dot_product_attention(q, k, v, causal=False, mask=None, scale=None):
    """Plain attention; q, k, v ``(..., T, H, Dh)`` with heads on axis -2.
    Computes in fp32 whatever the input dtype, through the same body as
    the kernels' plain versions (``ops.flash_attention.masked_attention``)."""
    if causal:
        keep = fa.causal_mask(q.shape[-3], k.shape[-3], q.device)
        mask = keep if mask is None else mask & keep
    return fa.masked_attention(q, k, v, mask, scale)


def _int32(x, device):
    return torch.as_tensor(x, dtype=torch.int32, device=device)


class MultiHeadAttention(Module):
    """Self-attention with a fused qkv projection."""

    def __init__(self, hidden_size: int, num_heads: int, causal: bool = False,
                 use_flash: str = "auto", generator=None):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} is not a multiple "
                             f"of num_heads {num_heads}")
        if use_flash not in ("auto", "never"):
            raise ValueError(f"use_flash must be 'auto' or 'never', got "
                             f"{use_flash!r}")
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.causal = causal
        self.use_flash = use_flash
        d = hidden_size
        init = Xavier()
        self.qkv_weight = torch.nn.Parameter(
            init.init(generator, (3 * d, d), d, d))
        self.qkv_bias = torch.nn.Parameter(torch.zeros(3 * d))
        self.out_weight = torch.nn.Parameter(
            init.init(generator, (d, d), d, d))
        self.out_bias = torch.nn.Parameter(torch.zeros(d))

    @property
    def _flash(self):
        return self.use_flash == "auto"

    def _project_qkv(self, x):
        """Fused projection, split into ``(N, T, H, Dh)`` views of one
        buffer (the kernels read their strides; nothing is copied)."""
        dt = x.dtype
        qkv = F.linear(x, self.qkv_weight.to(dt), self.qkv_bias.to(dt))
        shape = (self.num_heads, self.head_dim)
        return [t.unflatten(-1, shape)
                for t in qkv.split(self.hidden_size, dim=-1)]

    def _project_out(self, y):
        n, t = y.shape[:2]
        dt = y.dtype
        return F.linear(y.reshape(n, t, self.hidden_size),
                        self.out_weight.to(dt), self.out_bias.to(dt))

    def forward(self, x):
        q, k, v = self._project_qkv(x)
        if self._flash:
            y = fa.flash_attention(q, k, v, causal=self.causal)
        else:
            y = dot_product_attention(q, k, v, causal=self.causal)
        return self._project_out(y)

    # ----- contiguous KV cache ---------------------------------------------- #
    def init_cache(self, batch: int, max_len: int, dtype=torch.float32):
        shape = (int(batch), int(max_len), self.num_heads, self.head_dim)
        device = self.qkv_weight.device
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def _apply_cached(self, x, cache, pos):
        """PREFILL (``pos is None``): the whole padded prompt ``(N, T, D)``,
        K/V written at ``[0, T)``, causal attention over the prompt.
        DECODE (``pos`` ``(N,)``): one token per row, written at
        ``pos[i]`` (clamped into the cache like ``dynamic_update_slice``),
        attention masked at ``kpos <= pos[i]``.  Writes ``cache`` in
        place and returns ``(y, cache)``."""
        n, t, _d = x.shape
        q, k, v = self._project_qkv(x)
        max_len = cache["k"].shape[1]
        if pos is None:
            if t > max_len:
                raise ValueError(f"prompt length {t} exceeds the cache's "
                                 f"max_len {max_len}")
            cache["k"][:, :t].copy_(k)
            cache["v"][:, :t].copy_(v)
            if self._flash:
                y = fa.flash_attention(q, k, v, causal=self.causal)
            else:
                y = dot_product_attention(q, k, v, causal=self.causal)
        else:
            if t != 1:
                raise ValueError(
                    f"decode steps take one token per row, got T={t}")
            pos = _int32(pos, x.device)
            rows = torch.arange(n, device=x.device)
            at = pos.long().clamp(0, max_len - 1)
            cache["k"][rows, at] = k[:, 0].to(cache["k"].dtype)
            cache["v"][rows, at] = v[:, 0].to(cache["v"].dtype)
            ck, cv = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
            if self._flash:
                y = fa.flash_decode_attention(q, ck, cv, pos)
            else:
                mask = (torch.arange(max_len, device=x.device)[None, :]
                        <= pos[:, None])[:, None, None, :]
                y = dot_product_attention(q, ck, cv, mask=mask)
        return self._project_out(y), cache

    # ----- paged KV pool ---------------------------------------------------- #
    def init_paged_cache(self, num_blocks: int, block_size: int,
                         dtype=torch.float32):
        """One ``(num_blocks, block_size, heads, head_dim)`` pool per K and
        V; the caller counts the trash block (the last id) in
        ``num_blocks``."""
        shape = (int(num_blocks), int(block_size), self.num_heads,
                 self.head_dim)
        device = self.qkv_weight.device
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def _apply_paged(self, x, pool, tables, pos, lengths):
        """Attention against a paged pool through per-row block tables
        (padded with the trash block id, the pool's last block).

        CHUNK PREFILL (``lengths`` ``(N,)``): one chunk per row whose first
        ``lengths[i]`` tokens are real and start at ``pos[i]``; K/V scatter
        through the table (padding tokens into the trash block) and
        attention gathers the row's whole mapped context, masked causally
        at each token's absolute position.
        DECODE (``lengths is None``): one token per row written at
        ``pos[i]``.  Writes ``pool`` in place and returns ``(y, pool)``."""
        n, t, _d = x.shape
        dev = x.device
        bs = pool["k"].shape[1]
        max_blocks = tables.shape[1]
        trash = pool["k"].shape[0] - 1
        tables = _int32(tables, dev)
        pos = _int32(pos, dev)
        q, k, v = self._project_qkv(x)
        cdt = pool["k"].dtype

        def gather_ctx(name):
            ctx = max_blocks * bs
            return pool[name][tables.long()].reshape(
                n, ctx, self.num_heads, self.head_dim).to(x.dtype)

        if lengths is not None:                           # chunk prefill
            lengths = _int32(lengths, dev)
            steps = torch.arange(t, dtype=torch.int32, device=dev)
            gpos = pos[:, None] + steps[None, :]
            valid = steps[None, :] < lengths[:, None]
            # jnp.take clips; torch indexing would raise -- clip explicitly
            logical = (gpos // bs).clamp(0, max_blocks - 1).long()
            phys = torch.gather(tables, 1, logical)
            phys = torch.where(valid, phys, torch.full_like(phys, trash))
            off = gpos % bs
            flat = (n * t, self.num_heads, self.head_dim)
            idx = (phys.reshape(-1).long(), off.reshape(-1).long())
            pool["k"].index_put_(idx, k.reshape(flat).to(cdt))
            pool["v"].index_put_(idx, v.reshape(flat).to(cdt))
            ctx = max_blocks * bs
            mask = (torch.arange(ctx, dtype=torch.int32, device=dev)
                    [None, None, :] <= gpos[:, :, None])[:, None]
            y = dot_product_attention(q, gather_ctx("k"), gather_ctx("v"),
                                      mask=mask)
        else:                                             # one-token step
            if t != 1:
                raise ValueError(
                    f"paged decode steps take one token per row, got T={t}")
            logical = (pos // bs).clamp(0, max_blocks - 1).long()
            phys = torch.gather(tables, 1, logical[:, None])[:, 0]
            idx = (phys.long(), (pos % bs).long())
            pool["k"].index_put_(idx, k[:, 0].to(cdt))
            pool["v"].index_put_(idx, v[:, 0].to(cdt))
            if self._flash:
                y = fa.flash_paged_decode_attention(
                    q, pool["k"].to(x.dtype), pool["v"].to(x.dtype),
                    tables, pos)
            else:
                ctx = max_blocks * bs
                mask = (torch.arange(ctx, device=dev)[None, :]
                        <= pos[:, None])[:, None, None, :]
                y = dot_product_attention(q, gather_ctx("k"),
                                          gather_ctx("v"), mask=mask)
        return self._project_out(y), pool


class TransformerBlock(Container):
    """Pre-LN block: x + MHA(LN(x)); x + MLP(LN(x)).  ``jax.nn.gelu``
    defaults to the tanh approximation, and so does this block."""

    def __init__(self, hidden_size, num_heads, mlp_ratio=4, causal=True,
                 use_flash="auto", generator=None):
        super().__init__()
        self.ln1 = LayerNorm(hidden_size)
        self.attn = MultiHeadAttention(hidden_size, num_heads, causal,
                                       use_flash, generator)
        self.ln2 = LayerNorm(hidden_size)
        self.fc1 = Linear(hidden_size, mlp_ratio * hidden_size,
                          generator=generator)
        self.fc2 = Linear(mlp_ratio * hidden_size, hidden_size,
                          generator=generator)

    def _mlp(self, x):
        h = F.gelu(self.fc1(self.ln2(x)), approximate="tanh")
        return x + self.fc2(h)

    def forward(self, x):
        return self._mlp(x + self.attn(self.ln1(x)))

    def apply_cached(self, x, cache, pos):
        a, cache = self.attn._apply_cached(self.ln1(x), cache, pos)
        return self._mlp(x + a), cache

    def apply_paged(self, x, pool, tables, pos, lengths=None):
        a, pool = self.attn._apply_paged(self.ln1(x), pool, tables, pos,
                                         lengths)
        return self._mlp(x + a), pool


class TransformerLM(Container):
    """Decoder-only LM: embed + blocks + LN + untied head.

    Parameters: ``wte (V, d)``, ``wpe (max_len, d)``, ``head (V, d)``,
    ``block{i}`` and ``ln_f`` -- the JAX unrolled layout.  A JAX model
    built with ``scan_layers=True`` loads through the bridge, which
    unstacks its ``"blocks"`` entry.  Weights are drawn on the CPU from
    ``torch.Generator().manual_seed(seed)`` and then moved to ``device``
    (``None`` means the CUDA card)."""

    def __init__(self, vocab_size, hidden_size, num_heads, num_layers,
                 max_len=2048, mlp_ratio=4, use_flash="auto", device=None,
                 seed=0):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.max_len = max_len
        d = hidden_size
        self.wte = torch.nn.Parameter(normal(gen, (vocab_size, d), 0.02))
        self.wpe = torch.nn.Parameter(normal(gen, (max_len, d), 0.01))
        self.head = torch.nn.Parameter(normal(gen, (vocab_size, d), 0.02))
        self.blocks = [self.add(f"block{i}", TransformerBlock(
            hidden_size, num_heads, mlp_ratio, use_flash=use_flash,
            generator=gen)) for i in range(num_layers)]
        self.ln_f = LayerNorm(hidden_size)
        self.to(device)

    @property
    def device(self):
        return self.wte.device

    def _logits(self, x):
        return F.linear(self.ln_f(x), self.head.to(x.dtype))

    def forward(self, input, cache=None, pos=None):
        """Full forward ``(N, T)`` token ids -> logits ``(N, T, V)``; with
        ``cache`` the cached prefill/decode of ``_apply_cached``."""
        if cache is not None:
            return self._apply_cached(input, cache, pos)
        t = input.shape[1]
        x = self.wte[input.long()] + self.wpe[:t][None]
        for b in self.blocks:
            x = b(x)
        return self._logits(x)

    # ----- contiguous KV cache ---------------------------------------------- #
    def init_cache(self, batch: int, max_len=None, dtype=torch.float32):
        """``{"block{i}": {"k", "v"}}`` of ``(batch, max_len, H, Dh)``
        zeros; ``max_len`` defaults to the positional table's."""
        max_len = self.max_len if max_len is None else int(max_len)
        if max_len > self.max_len:
            raise ValueError(f"cache max_len {max_len} exceeds the model's "
                             f"positional table ({self.max_len})")
        return {f"block{i}": b.attn.init_cache(batch, max_len, dtype)
                for i, b in enumerate(self.blocks)}

    def _apply_cached(self, input, cache, pos):
        """Prefill (``pos=None``: whole padded prompt) or one-token decode
        (``pos`` ``(N,)``).  Returns ``(logits, cache)``, cache written in
        place."""
        t = input.shape[1]
        x = self.wte[input.long()]
        if pos is None:
            x = x + self.wpe[:t][None]
        else:
            pos = _int32(pos, x.device)
            # jnp.take clips: an inactive slot's position stays in range
            at = pos.long().clamp(0, self.max_len - 1)
            x = x + self.wpe[at][:, None, :]
        for i, b in enumerate(self.blocks):
            x, cache[f"block{i}"] = b.apply_cached(x, cache[f"block{i}"],
                                                   pos)
        return self._logits(x), cache

    # ----- paged KV pool ---------------------------------------------------- #
    def init_paged_cache(self, num_blocks: int, block_size: int,
                         dtype=torch.float32):
        """Per-layer pools of ``num_blocks + 1`` blocks: the extra one, id
        ``num_blocks``, is the trash block."""
        return {f"block{i}": b.attn.init_paged_cache(int(num_blocks) + 1,
                                                     block_size, dtype)
                for i, b in enumerate(self.blocks)}

    def apply_paged(self, input, pool, tables, *, pos, lengths=None):
        """Chunk prefill (``lengths`` given, ``input`` ``(N, Tc)`` starting
        at ``pos``) or one-token decode (``input`` ``(N, 1)`` at ``pos``).
        Returns ``(logits, pool)``, pool written in place."""
        t = input.shape[1]
        dev = self.device
        pos = _int32(pos, dev)
        x = self.wte[input.long()]
        if lengths is not None:
            gpos = pos[:, None] + torch.arange(t, dtype=torch.int32,
                                               device=dev)[None, :]
            # padding tokens past max_len reuse the last row (they write
            # to the trash block and are never read)
            x = x + self.wpe[gpos.long().clamp(0, self.max_len - 1)]
        else:
            x = x + self.wpe[pos.long().clamp(0, self.max_len - 1)][:, None]
        for i, b in enumerate(self.blocks):
            x, pool[f"block{i}"] = b.apply_paged(x, pool[f"block{i}"],
                                                 tables, pos, lengths)
        return self._logits(x), pool


#: matches the unrolled per-block keys ("block0".."block{N-1}")
_BLOCK_KEY = re.compile(r"^block(\d+)$")


def stack_block_params(params):
    """Unrolled tree (``"block{i}"`` keys) -> the scan layout (one
    ``"blocks"`` entry, every leaf stacked on a leading layer axis)."""
    idx = sorted(int(m.group(1)) for k in params
                 if (m := _BLOCK_KEY.match(k)))
    if not idx:
        raise ValueError("no 'block{i}' entries to stack (already the "
                         "scan layout?)")
    if idx != list(range(len(idx))):
        raise ValueError(f"non-contiguous block indices {idx}")
    out = {k: v for k, v in params.items() if not _BLOCK_KEY.match(k)}
    out["blocks"] = stack_layer_trees([params[f"block{i}"] for i in idx])
    return out


def unstack_block_params(params):
    """Scan-layout tree (stacked ``"blocks"``) -> ``"block{i}"`` keys."""
    if "blocks" not in params:
        raise ValueError("no 'blocks' entry to unstack (already the "
                         "unrolled layout?)")
    out = {k: v for k, v in params.items() if k != "blocks"}
    for i, p in enumerate(unstack_layer_trees(params["blocks"])):
        out[f"block{i}"] = p
    return out
