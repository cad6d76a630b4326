#!/usr/bin/env python3
"""Kernel times of several checkouts of the repository on one card, in
turn, for an A/B comparison of two commits (parent, change, change,
parent) within one run.

    python3 tools/torch_kernel_ab.py build/parent . . build/parent

Each checkout runs in a fresh process that imports its own
``chip_smoke.py`` and ``bigdl_tpu_torch``, builds its kernels into its
own build directory, and times phase 3's rows (K1, K2, K3, and the
empty-kernel floor where the checkout has it) and, where the checkout
has it, phase 8's (K3q), then K1 and K1-bwd at phase 3's and
phase 6's shapes (``K1_SHAPES``, ``K1_BWD_SHAPES``: fp32, H 12, D 64,
causal, q/k/v views of one fused buffer) through the checkout's own
wrappers, so that a checkout without a row still gets it timed: device
time from CUDA-graph replays.
Prints one JSON line per checkout, with the card's name and power limit:
``{"checkout": ..., "card": ..., "<kernel>_<case>": ms, ...}``.  Needs a
CUDA card.
"""

import json
import subprocess
import sys
from pathlib import Path


#: (B, T) of the K1 forward rows and of the K1-bwd rows
K1_SHAPES = ((2, 1024), (1, 200), (8, 1024))
K1_BWD_SHAPES = ((8, 1024), (8, 200))


def attention_rows(cs, fa):
    """K1 and K1-bwd device times (ms) at ``K1_SHAPES`` and
    ``K1_BWD_SHAPES``."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(0)
    h, d = cs.HEADS, cs.HEAD_DIM
    out = {}

    def views(b, t):
        qkv = torch.randn(b, t, 3 * h * d, generator=g, device="cuda")
        return [x.unflatten(-1, (h, d)) for x in qkv.split(h * d, dim=-1)]

    for b, t in K1_SHAPES:
        q, k, v = views(b, t)
        out[f"K1_causal_B{b}_T{t}"] = cs.device_ms(
            lambda: fa.flash_attention(q, k, v, True))[0]
    for b, t in K1_BWD_SHAPES:
        q, k, v = views(b, t)
        do = torch.randn(b, t, h, d, generator=g, device="cuda")
        o, lse = fa._flash_forward(q, k, v, True, with_lse=True)
        out[f"K1-bwd_causal_B{b}_T{t}"] = cs.device_ms(
            lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, True))[0]
    return out


def one(root):
    root = str(Path(root).resolve())
    sys.path.insert(0, root)
    import chip_smoke as cs
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import flash_attention as fa

    _build.build()
    _build.load()
    card = cs.card_line()
    rows = []
    cs.emit = rows.append            # keep every case's row, print none
    cs.kernel_phase(fa, card)
    if hasattr(cs, "int8_kernel_phase"):
        cs.int8_kernel_phase(fa, card)
    print(json.dumps({"checkout": root, "card": card,
                      **{f"{r['name']}_{r['case']}": r["ms"]
                         for r in rows},
                      **attention_rows(cs, fa)}), flush=True)


def main(argv):
    if len(argv) == 2 and argv[0] == "--one":
        one(argv[1])
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
