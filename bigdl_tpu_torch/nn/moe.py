"""Mixture-of-Experts layers (counterpart of ``bigdl_tpu/nn/moe.py``:
``MoE`` :26, ``MoETransformerBlock`` :115, ``MoETransformerLM`` :146).

Top-k routing with softmax probabilities over a router ``gate (D, E)``
and experts stacked on a leading dimension (``w1 (E, D, F)``, ``b1 (E,
F)``, ``w2 (E, F, D)``, ``b2 (E, D)``), JAX's keys.  The routing is
JAX's, rule for rule:

- ``lax.top_k`` breaks ties toward the lower expert index (a stable
  descending sort here);
- a (token, choice)'s slot in its expert is a **choice-major** count:
  every first choice comes before any second choice;
- the capacity is ``max(k, ceil(k * tokens / E * capacity_factor))``,
  and a (token, choice) past it is dropped;
- ``jax.nn.gelu`` is the tanh approximation;
- the auxiliary loss is ``E * sum(first-choice share * mean prob)``.

JAX dispatches and combines through dense ``(T, E, C)`` one-hot
einsums; the port moves each kept (token, choice) into its slot with
one ``index_copy`` and gathers its expert's output back, the same
values with ``O(T k + E C D)`` memory and static shapes (a CUDA graph
captures it).

Expert parallelism (``parallel/ep.py``) sets three hooks on a rank's
copy: ``ep`` (the ``"expert"`` axis's collectives: the rank holds
experts ``[expert_offset, expert_offset + E / P)``, the branch's
inputs enter through ``CopyToAxis`` and the combined output leaves
through ``ReduceFromAxis``) and ``route`` (the ``"data"`` axis's: the
routing is the global batch's, as in JAX's one program -- the capacity
counts every data shard's tokens, and a token's slot counts the tokens
of the shards before it, choice by choice; the auxiliary loss's means
are global).

``MoE.forward`` returns ``(out, aux)`` (JAX's ``apply`` returns the aux
loss in its state); ``MoETransformerLM(input)`` returns the logits, and
``(logits, aux)`` with ``return_aux=True``.
"""

import math

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.attention import MultiHeadAttention
from bigdl_tpu_torch.nn.initialization import Xavier, normal
from bigdl_tpu_torch.nn.module import Container, Module
from bigdl_tpu_torch.nn.normalization import LayerNorm
from bigdl_tpu_torch.parallel.collectives import (CopyToAxis, PMean,
                                                  ReduceFromAxis)
from bigdl_tpu_torch.utils.device import resolve_device


class MoE(Module):
    """Top-k routed expert MLP: ``(N, T, D) -> ((N, T, D), aux)``."""

    #: expert parallelism's hooks (module docstring)
    ep = None
    route = None
    expert_offset = 0

    def __init__(self, hidden_size: int, num_experts: int, k: int = 2,
                 mlp_ratio: int = 4, capacity_factor: float = 1.25,
                 name=None, generator=None):
        super().__init__(name)
        self.hidden_size = hidden_size
        self.num_experts = num_experts
        self.k = min(k, num_experts)
        self.mlp_ratio = mlp_ratio
        self.capacity_factor = capacity_factor
        d, f, e = hidden_size, mlp_ratio * hidden_size, num_experts
        init = Xavier()
        self.gate = torch.nn.Parameter(init.init(generator, (d, e), d, e))
        self.w1 = torch.nn.Parameter(torch.stack(
            [init.init(generator, (d, f), d, f) for _ in range(e)]))
        self.b1 = torch.nn.Parameter(torch.zeros(e, f))
        self.w2 = torch.nn.Parameter(torch.stack(
            [init.init(generator, (f, d), f, d) for _ in range(e)]))
        self.b2 = torch.nn.Parameter(torch.zeros(e, d))

    def _capacity(self, tokens: int) -> int:
        # k*tokens routing assignments share E expert slots
        return max(self.k, int(math.ceil(
            self.k * tokens / self.num_experts * self.capacity_factor)))

    def _positions(self, sel):
        """Each (token, choice)'s slot in its expert, choice-major over
        the global batch: ``sel (T, k, E)`` one-hot -> ``(T, k)``."""
        within = sel.cumsum(0) - sel                 # earlier tokens
        counts = sel.sum(0)                          # (k, E) this shard
        if self.route is not None and self.route.world > 1:
            every = self.route.all_gather(counts.reshape(-1)).reshape(
                self.route.world, *counts.shape)
            total = every.sum(0)
            earlier = every[:self.route.rank].sum(0)  # shards before
        else:
            total, earlier = counts, torch.zeros_like(counts)
        before = total.cumsum(0) - total             # earlier choices
        pos = within + (before + earlier)[None]
        return (pos * sel).sum(-1)

    def forward(self, input):
        n, t, d = input.shape
        e, k = self.num_experts, self.k
        tokens = n * t
        shards = self.route.world if self.route is not None else 1
        cap = self._capacity(tokens * shards)
        dt = input.dtype
        x = input.reshape(tokens, d)

        logits = (x @ self.gate.to(dt)).float()
        probs = torch.softmax(logits, dim=-1)                 # (T, E)
        ranked, order = torch.sort(probs, dim=-1, descending=True,
                                   stable=True)
        gate_vals, idx = ranked[:, :k], order[:, :k]         # (T, k)
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(
            1e-9)
        # one-hot by comparison: F.one_hot checks its range on the host
        sel = (idx[..., None] == torch.arange(e, device=idx.device)).float()
        pos = self._positions(sel)
        fits = pos < cap
        gate_vals = gate_vals * fits.float()

        # this rank's experts [e0, e0 + el): a kept (token, choice) goes
        # to its slot, every other one to the trash row past the end
        el = self.w1.shape[0]
        e0 = self.expert_offset
        mine = fits & (idx >= e0) & (idx < e0 + el)
        slot = (idx - e0) * cap + pos.long()
        trash = el * cap
        dst = torch.where(mine, slot, torch.full_like(slot, trash))
        xin, gv = x, gate_vals
        if self.ep is not None:
            xin = CopyToAxis.apply(x, self.ep)
            gv = CopyToAxis.apply(gate_vals, self.ep)
        src = xin[:, None, :].expand(tokens, k, d).reshape(tokens * k, d)
        ex_in = xin.new_zeros(trash + 1, d).index_copy(
            0, dst.reshape(-1), src)[:trash].view(el, cap, d)

        h = torch.bmm(ex_in, self.w1.to(dt)) + self.b1[:, None, :].to(dt)
        h = F.gelu(h, approximate="tanh")
        h = torch.bmm(h, self.w2.to(dt)) + self.b2[:, None, :].to(dt)
        picked = h.reshape(trash, d).index_select(
            0, dst.clamp_max(trash - 1).reshape(-1))
        w = torch.where(mine, gv, torch.zeros_like(gv)).to(dt)
        out = (picked.view(tokens, k, d) * w[..., None]).sum(1)
        if self.ep is not None:
            out = ReduceFromAxis.apply(out, self.ep)

        # load-balance aux loss: E * mean(fraction_routed) . mean(prob)
        frac = sel[:, 0, :].mean(0)           # first-choice assignment share
        mean_prob = probs.mean(0)
        if shards > 1:
            frac = self.route.pmean(frac)
            mean_prob = PMean.apply(mean_prob, self.route)
        aux = (frac * mean_prob).sum() * e
        return out.reshape(n, t, d), aux


class MoETransformerBlock(Container):
    """Pre-LN block with MoE in place of the dense MLP; ``forward`` ->
    ``(out, aux)``."""

    def __init__(self, hidden_size, num_heads, num_experts, k=2,
                 mlp_ratio=4, capacity_factor=1.25, causal=True,
                 use_flash="auto", generator=None):
        super().__init__()
        self.ln1 = LayerNorm(hidden_size)
        self.attn = MultiHeadAttention(hidden_size, num_heads, causal,
                                       use_flash, generator)
        self.ln2 = LayerNorm(hidden_size)
        self.moe = MoE(hidden_size, num_experts, k, mlp_ratio,
                       capacity_factor, generator=generator)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        h, aux = self.moe(self.ln2(x))
        return x + h, aux


class MoETransformerLM(Container):
    """Decoder-only MoE LM: ``wte``, ``wpe``, ``head`` (untied),
    ``block{i}`` and ``ln_f``, JAX's tree.  Weights are drawn on the CPU
    from ``torch.Generator().manual_seed(seed)`` and moved to ``device``
    (None: the CUDA card)."""

    def __init__(self, vocab_size, hidden_size, num_heads, num_layers,
                 num_experts, k=2, max_len=2048, mlp_ratio=4,
                 capacity_factor=1.25, use_flash="auto", device=None,
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
        self.blocks = [MoETransformerBlock(hidden_size, num_heads,
                                           num_experts, k, mlp_ratio,
                                           capacity_factor,
                                           use_flash=use_flash,
                                           generator=gen)
                       for _ in range(num_layers)]
        for i, b in enumerate(self.blocks):
            self.add(f"block{i}", b)
        self.ln_f = LayerNorm(hidden_size)
        self.to(device)

    @property
    def device(self):
        return self.wte.device

    def forward(self, input, return_aux=False):
        t = input.shape[1]
        x = self.wte[input.long()] + self.wpe[:t][None]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for b in self.blocks:
            x, a = b(x)
            aux = aux + a
        logits = F.linear(self.ln_f(x), self.head.to(x.dtype))
        return (logits, aux) if return_aux else logits
