"""Attention and transformer blocks (counterpart of
``bigdl_tpu/nn/attention.py``).

Layout ``(N, T, D)`` with heads split last, ``(N, T, H, Dh)``; softmax in
fp32.  Three attention modes share one ``MultiHeadAttention``:

- full sequence (``forward``), through the K1 kernel;
- contiguous KV cache (``_apply_cached``): prefill through K1, one-token
  decode through K2;
- paged KV pool (``_apply_paged``): chunk prefill through a gather and
  plain attention (as in the JAX package, which keeps it outside
  Pallas), one-token decode through K3; an int8 pool (payloads plus one
  fp32 scale per (position, head) vector) quantizes every K/V write and
  decodes through K3q, which dequantizes inside the kernel.

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

from bigdl_tpu_torch.nn import dropout as _dropout
from bigdl_tpu_torch.nn.containers import (ScanLayers, remat,
                                           resolve_checkpoint_policy,
                                           stack_layer_trees,
                                           unstack_layer_trees)
from bigdl_tpu_torch.nn.initialization import Xavier, normal
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import Container, Module
from bigdl_tpu_torch.nn.normalization import LayerNorm
from bigdl_tpu_torch.nn.quantized import int8_matmul
from bigdl_tpu_torch.ops import flash_attention as fa
from bigdl_tpu_torch.ops.quantization import (dequantize_blockwise,
                                              quantize_blockwise)
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
    """Self-attention with a fused qkv projection.  ``dropout`` applies
    to the projected output in training (``nn.dropout``: the mask is a
    hash of the step's key, ``dropout_salt`` -- the layer index in a
    ``TransformerLM`` -- and the element index); eval is the identity."""

    def __init__(self, hidden_size: int, num_heads: int, causal: bool = False,
                 use_flash: str = "auto", generator=None,
                 dropout: float = 0.0):
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
        self.dropout = float(dropout)
        self.dropout_salt = 0
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
        buffer (the kernels read their strides; nothing is copied).  An
        int8 twin (``qkv_weight_q`` held) contracts in int8; attention
        itself stays in the activation dtype.  One implementation for
        the full-sequence, cached and paged paths."""
        dt = x.dtype
        if "qkv_weight_q" in self._parameters:
            qkv = (int8_matmul(x, self.qkv_weight_q, self.qkv_scale)
                   + self.qkv_bias).to(dt)
        else:
            qkv = F.linear(x, self.qkv_weight.to(dt), self.qkv_bias.to(dt))
        shape = (self.num_heads, self.head_dim)
        return [t.unflatten(-1, shape)
                for t in qkv.split(self.hidden_size, dim=-1)]

    def _project_out(self, y):
        n, t = y.shape[:2]
        dt = y.dtype
        y = y.reshape(n, t, self.hidden_size)
        if "out_weight_q" in self._parameters:
            return (int8_matmul(y, self.out_weight_q, self.out_scale)
                    + self.out_bias).to(dt)
        return F.linear(y, self.out_weight.to(dt), self.out_bias.to(dt))

    def forward(self, x):
        q, k, v = self._project_qkv(x)
        if self._flash:
            y = fa.flash_attention(q, k, v, causal=self.causal)
        else:
            y = dot_product_attention(q, k, v, causal=self.causal)
        y = self._project_out(y)
        if self.training and self.dropout > 0:
            y = _dropout.dropout(y, self.dropout, self.dropout_salt)
        return y

    # ----- contiguous KV cache ---------------------------------------------- #
    def init_cache(self, batch: int, max_len: int, dtype=torch.float32):
        shape = (int(batch), int(max_len), self.num_heads, self.head_dim)
        device = self.qkv_bias.device
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
        ``num_blocks``.

        ``dtype=torch.int8`` selects the quantized layout: int8 payloads
        plus fp32 absmax scales ``k_scale``/``v_scale`` of shape
        ``(num_blocks, block_size, heads, 1)``, one per head_dim vector
        (the ``ops.quantization`` blockwise format with the block =
        head_dim).  The scales keep the payload's 4-D rank, so block
        copies and byte counts treat every leaf alike."""
        shape = (int(num_blocks), int(block_size), self.num_heads,
                 self.head_dim)
        device = self.qkv_bias.device
        if dtype == torch.int8:
            sshape = shape[:-1] + (1,)
            return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                    "v": torch.zeros(shape, dtype=torch.int8, device=device),
                    "k_scale": torch.zeros(sshape, device=device),
                    "v_scale": torch.zeros(sshape, device=device)}
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def _paged_quant(self, x):
        """K/V vectors ``(..., heads, head_dim)`` -> (int8 payload, fp32
        scales ``(..., heads, 1)``): one absmax scale per head_dim vector;
        a non-finite vector dequantizes to exact zero."""
        q8, sc = quantize_blockwise(x.reshape(-1), self.head_dim,
                                    scale_dtype=torch.float32)
        return q8.reshape(x.shape), sc.reshape(x.shape[:-1] + (1,))

    def _paged_dequant(self, q8, sc, dt):
        """Inverse of ``_paged_quant`` over gathered context:
        ``(..., heads, head_dim)`` int8 + ``(..., heads, 1)`` scales ->
        ``dt`` values."""
        lead = q8.shape[:-2]
        flat = q8.reshape(lead + (q8.shape[-2] * q8.shape[-1],))
        out = dequantize_blockwise(flat, sc.reshape(lead + (-1,)),
                                   self.head_dim)
        return out.reshape(q8.shape).to(dt)

    def _apply_paged(self, x, pool, tables, pos, lengths):
        """Attention against a paged pool through per-row block tables
        (padded with the trash block id, the pool's last block).

        CHUNK PREFILL (``lengths`` ``(N,)``): one chunk per row whose first
        ``lengths[i]`` tokens are real and start at ``pos[i]``; K/V scatter
        through the table (padding tokens into the trash block) and
        attention gathers the row's whole mapped context, masked causally
        at each token's absolute position.
        DECODE (``lengths is None``): one token per row written at
        ``pos[i]``.  Writes ``pool`` in place and returns ``(y, pool)``.

        On an int8 pool every written K/V vector is quantized first and
        its payload and scale land at the same (block, offset), so the
        tables, block copies and prefix sharing do not see the format."""
        n, t, _d = x.shape
        dev = x.device
        bs = pool["k"].shape[1]
        max_blocks = tables.shape[1]
        trash = pool["k"].shape[0] - 1
        quant = "k_scale" in pool
        tables = _int32(tables, dev)
        pos = _int32(pos, dev)
        q, k, v = self._project_qkv(x)
        cdt = pool["k"].dtype

        def scatter(idx, kf, vf):
            if quant:
                for name, val in (("k", kf), ("v", vf)):
                    q8, sc = self._paged_quant(val)
                    pool[name].index_put_(idx, q8)
                    pool[name + "_scale"].index_put_(idx, sc)
            else:
                pool["k"].index_put_(idx, kf.to(cdt))
                pool["v"].index_put_(idx, vf.to(cdt))

        def gather_ctx(name):
            """The row's whole mapped context, dequantized on an int8
            pool (the chunk prefill and plain decode paths only: the
            kernels read the pool in place)."""
            ctx = max_blocks * bs
            shape = (n, ctx, self.num_heads)
            raw = pool[name][tables.long()].reshape(*shape, self.head_dim)
            if quant:
                sc = pool[name + "_scale"][tables.long()].reshape(*shape, 1)
                return self._paged_dequant(raw, sc, x.dtype)
            return raw.to(x.dtype)

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
            scatter(idx, k.reshape(flat), v.reshape(flat))
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
            scatter(idx, k[:, 0], v[:, 0])
            if self._flash and quant:
                y = fa.flash_paged_decode_attention(
                    q, pool["k"], pool["v"], tables, pos,
                    k_scale=pool["k_scale"],
                    v_scale=pool["v_scale"]).to(x.dtype)
            elif self._flash:
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
                 use_flash="auto", generator=None, dropout=0.0):
        super().__init__()
        self.ln1 = LayerNorm(hidden_size)
        self.attn = MultiHeadAttention(hidden_size, num_heads, causal,
                                       use_flash, generator, dropout)
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

    def init_paged_cache(self, num_blocks: int, block_size: int,
                         dtype=torch.float32):
        """This block's paged K/V pool (the attention sublayer's)."""
        return self.attn.init_paged_cache(num_blocks, block_size, dtype)

    def apply_paged(self, x, pool, tables, pos, lengths=None):
        a, pool = self.attn._apply_paged(self.ln1(x), pool, tables, pos,
                                         lengths)
        return self._mlp(x + a), pool


class TransformerLM(Container):
    """Decoder-only LM: embed + blocks + LN + untied head.

    Parameters: ``wte (V, d)``, ``wpe (max_len, d)``, ``head (V, d)``,
    ``ln_f`` and the blocks in one of JAX's two layouts:

    - unrolled (``scan_layers=False``): ``block{i}``, each block a child;
    - scanned (``scan_layers=True``): one ``blocks`` entry
      (``nn.ScanLayers``) whose every leaf has a leading layer axis.

    Both layouts draw the same initial weights from one seed (the blocks
    are built alike, then stacked), and either loads a JAX tree of
    either layout through the bridge.  ``remat_policy`` (a
    ``nn.containers`` policy name) rematerialises the blocks in
    training: in the scanned layout every layer always (``None`` keeps
    each layer's input only), in the unrolled one each block when a
    policy is named, as the JAX model does.  The KV caches and pools
    follow the parameters' layout: ``{"block{i}": ...}`` or
    ``{"blocks": ...}`` with a leading layer axis, whose layer views are
    contiguous.  Weights are drawn on the CPU from
    ``torch.Generator().manual_seed(seed)`` and then moved to ``device``
    (``None`` means the CUDA card)."""

    def __init__(self, vocab_size, hidden_size, num_heads, num_layers,
                 max_len=2048, mlp_ratio=4, use_flash="auto", device=None,
                 seed=0, scan_layers=False, remat_policy=None):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.max_len = max_len
        self.scan_layers = bool(scan_layers)
        self.remat_policy = resolve_checkpoint_policy(remat_policy)
        d = hidden_size
        self.wte = torch.nn.Parameter(normal(gen, (vocab_size, d), 0.02))
        self.wpe = torch.nn.Parameter(normal(gen, (max_len, d), 0.01))
        self.head = torch.nn.Parameter(normal(gen, (vocab_size, d), 0.02))
        blocks = [TransformerBlock(hidden_size, num_heads, mlp_ratio,
                                   use_flash=use_flash, generator=gen)
                  for _ in range(num_layers)]
        if self.scan_layers:
            # model.blocks is the ScanLayers: blocks[i] is layer i
            self.add("blocks", ScanLayers(blocks, remat_policy))
        else:
            self.blocks = blocks
            for i, b in enumerate(blocks):
                b.attn.dropout_salt = i
                self.add(f"block{i}", b)
        self.ln_f = LayerNorm(hidden_size)
        self.to(device)

    @property
    def scan(self):
        """The ``ScanLayers`` of the scanned layout, else None."""
        blocks = self._modules.get("blocks")
        return blocks if isinstance(blocks, ScanLayers) else None

    @property
    def device(self):
        return self.wte.device

    def _logits(self, x):
        return F.linear(self.ln_f(x), self.head.to(x.dtype))

    def _layers(self, tree):
        """``(block, its part of tree)`` per layer: the blocks, or the
        scanned stack's layer views with views of the stacked tree."""
        if self.scan is None:
            return [(b, tree[f"block{i}"])
                    for i, b in enumerate(self.blocks)]
        stacked = tree["blocks"]
        return [(view, {k: t[i] for k, t in stacked.items()})
                for i, view in enumerate(self.scan.layer_views())]

    def _stacked_cache(self, per_layer):
        """One layer's cache leaves -> zeros of the model's layout."""
        if self.scan is None:
            return {f"block{i}": per_layer() for i in range(len(self.blocks))}
        one = per_layer()
        return {"blocks": {k: torch.zeros((len(self.blocks), *t.shape),
                                          dtype=t.dtype, device=t.device)
                           for k, t in one.items()}}

    def forward(self, input, cache=None, pos=None):
        """Full forward ``(N, T)`` token ids -> logits ``(N, T, V)``; with
        ``cache`` the cached prefill/decode of ``_apply_cached``."""
        if cache is not None:
            return self._apply_cached(input, cache, pos)
        t = input.shape[1]
        x = self.wte[input.long()] + self.wpe[:t][None]
        if self.scan is not None:
            x = self.scan(x)
        else:
            for b in self.blocks:
                if self.training and self.remat_policy is not None:
                    x = remat(b, x, policy=self.remat_policy)
                else:
                    x = b(x)
        return self._logits(x)

    # ----- contiguous KV cache ---------------------------------------------- #
    def init_cache(self, batch: int, max_len=None, dtype=torch.float32):
        """``{"block{i}": {"k", "v"}}`` of ``(batch, max_len, H, Dh)``
        zeros, or ``{"blocks": ...}`` with a leading layer axis when
        scanned; ``max_len`` defaults to the positional table's."""
        max_len = self.max_len if max_len is None else int(max_len)
        if max_len > self.max_len:
            raise ValueError(f"cache max_len {max_len} exceeds the model's "
                             f"positional table ({self.max_len})")
        return self._stacked_cache(
            lambda: self.blocks[0].attn.init_cache(batch, max_len, dtype))

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
        for b, c in self._layers(cache):
            x, _ = b.apply_cached(x, c, pos)
        return self._logits(x), cache

    # ----- paged KV pool ---------------------------------------------------- #
    def init_paged_cache(self, num_blocks: int, block_size: int,
                         dtype=torch.float32):
        """Per-layer pools of ``num_blocks + 1`` blocks (the layout of
        ``init_cache``): the extra one, id ``num_blocks``, is the trash
        block.  ``dtype=torch.int8`` gives the quantized layout
        (``MultiHeadAttention.init_paged_cache``)."""
        return self._stacked_cache(lambda: self.blocks[0].init_paged_cache(
            int(num_blocks) + 1, block_size, dtype))

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
        for b, p in self._layers(pool):
            x, _ = b.apply_paged(x, p, tables, pos, lengths)
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
