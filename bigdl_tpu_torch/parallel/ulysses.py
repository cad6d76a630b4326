"""Ulysses sequence parallelism (counterpart of
``bigdl_tpu/parallel/ulysses.py`` ``ulysses_self_attention`` :23).

One tiled ``AllToAll`` re-shards the activations from sequence-sharded
``(N, T / P, H, Dh)`` to head-sharded ``(N, T, H / P, Dh)``, full
attention over the whole sequence runs on each rank's heads, and a
second ``AllToAll`` restores the sequence sharding.  The local attention
is K1 (``ops.flash_attention.flash_attention``, with K1-bwd for its
gradient) where JAX calls ``dot_product_attention``, which is the
function K1 computes; ``use_flash=False`` takes the plain version.
"""

from bigdl_tpu_torch.ops import flash_attention as fa
from bigdl_tpu_torch.parallel.collectives import AllToAll


def ulysses_self_attention(q, k, v, collectives, causal=False,
                           use_flash=True):
    """``q, k, v (N, T_local, H, Dh)``, the sequence sharded over
    ``collectives``' ranks -> ``(N, T_local, H, Dh)``."""
    p = collectives.world
    h = q.shape[2]
    if h % p:
        raise ValueError(
            f"ulysses needs num_heads ({h}) divisible by the sequence "
            f"axis size ({p})")
    qg, kg, vg = (AllToAll.apply(x, collectives, 2, 1) for x in (q, k, v))
    if use_flash:
        y = fa.flash_attention(qg, kg, vg, causal=causal)
    else:
        from bigdl_tpu_torch.nn.attention import dot_product_attention

        y = dot_product_attention(qg, kg, vg, causal=causal)
    return AllToAll.apply(y, collectives, 1, 2)
