"""Ring attention: exact attention over a sequence-sharded mesh axis
(counterpart of ``bigdl_tpu/parallel/ring_attention.py``:
``ring_self_attention`` :30, ``sequence_shard_attention`` :81).

Each rank holds ``T_local`` consecutive positions of the sequence.  K/V
blocks travel around the ring, one ``PPermute`` hop (``perm = [(j, (j -
1) % n)]``: a rank receives the block of the next one) per step, and
each hop updates an online softmax in fp32 -- running max ``m``,
normaliser ``l``, accumulator ``o`` -- whatever the input dtype.  The
causal mask uses global positions, so a fully masked remote block
contributes exactly 0.  The output is ``o / max(l, 1e-30)``.

Plain PyTorch, as JAX's is plain ``jnp``: the JAX package runs no Pallas
kernel here.  The gradient comes by autograd through the hops and the
``PPermute`` transposes, as JAX's comes by autodiff.  The last hop's
permutation is not sent (JAX's ``lax.scan`` sends one more that nothing
reads).
"""

import math

import torch

from bigdl_tpu_torch.parallel.collectives import PPermute


def ring_self_attention(q, k, v, collectives, causal=False):
    """This rank's blocks ``q, k, v (B, T_local, H, Dh)`` of a sequence
    sharded over ``collectives``' ranks in rank order -> ``(B, T_local,
    H, Dh)`` in ``q``'s dtype: exact attention over the whole sequence,
    up to fp32 accumulation order."""
    n_dev, my = collectives.world, collectives.rank
    b, t, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    q32 = q.float()
    o = torch.zeros((b, h, t, d), dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, t), dtype=torch.float32, device=dev)
    m = torch.full((b, h, t), -math.inf, dtype=torch.float32, device=dev)
    qpos = my * t + torch.arange(t, device=dev)
    perm = [(j, (j - 1) % n_dev) for j in range(n_dev)]
    kb, vb = k, v
    for i in range(n_dev):
        src = (my + i) % n_dev           # origin rank of the current block
        scores = torch.einsum("bqhd,bkhd->bhqk", q32, kb.float()) * scale
        if causal:
            kpos = src * t + torch.arange(t, device=dev)
            mask = (kpos[None, :] <= qpos[:, None]).float()
        else:
            mask = torch.ones((t, t), dtype=torch.float32, device=dev)
        scores = torch.where(mask > 0, scores,
                             torch.full_like(scores, -math.inf))
        new_m = torch.maximum(m, scores.amax(dim=-1))
        safe_m = torch.where(torch.isfinite(new_m), new_m,
                             torch.zeros_like(new_m))
        p = torch.exp(scores - safe_m[..., None]) * mask
        corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m),
                           torch.zeros_like(m))
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                               vb.float())
        m = new_m
        if i + 1 < n_dev:
            kb = PPermute.apply(kb, collectives, perm)
            vb = PPermute.apply(vb, collectives, perm)
    out = o / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def sequence_shard_attention(q, k, v, mesh, axis_name="seq", causal=False):
    """Global ``(B, T, H, D)`` tensors (the same on every rank) -> this
    rank's ``(B, T / n, H, D)`` block of ring attention over the mesh
    axis ``axis_name`` (JAX's ``shard_map`` wrapper; a helper for the
    tests)."""
    coll = mesh.collectives(axis_name)
    t = q.shape[1] // coll.world
    sl = slice(coll.rank * t, (coll.rank + 1) * t)
    return ring_self_attention(q[:, sl], k[:, sl], v[:, sl], coll,
                               causal=causal)
