#!/usr/bin/env python3
"""K2, K3 and K3q device times against their split count, on one card.

    python3 tools/torch_decode_splits.py

K2 (``flash_decode_attention``, a contiguous cache), K3
(``flash_paged_decode_attention``) and K3q (its int8 pools) read each
(b, h) row with the S blocks of one thread-block cluster; the wrapper
picks S (``ops.flash_attention.decode_splits``, from the card's SM
count).  This tool forces S from 1 to 8 and times K3 and K3q (fp32 q, H
12, D 64, 1024 positions a row, as ``chip_smoke.py`` phases 3 and 8)
and K2 (a 1024-position cache, as phase 3), each at 8 rows (the paged
engines' slots) and at 9 (the contiguous engine's, with its trash row),
on three sets of frontiers: random ones as in phase 3 (K2's with rows 0
and 1 at positions 0 and 1023, as there), every row at position 0 (one
tile: the kernel's fixed cost), and every row at the last position (the
most bytes).  It also times an empty kernel launched as K2 is and as K3
is, the floor under them.  Device time from CUDA-graph replays
(``chip_smoke.device_ms``).  Prints one JSON line per (kernel, rows, block
size, frontiers, S) and one per floor, each with the card's name and
power limit.  Needs a CUDA card.
"""

import json
import sys
from pathlib import Path

import torch

# run as a script from a checkout: the package sits beside tools/
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

B, HEADS, HEAD_DIM, MAX_LEN = 8, 12, 64, 1024
#: K2's rows: the contiguous engine's 8 slots and its trash row
K2_B = 9


def pools(g, nb, bs):
    """fp32 K and V pools, then each one's int8 form and fp32 scales:
    (k, v, k8, k_scale, v8, v_scale)."""
    from bigdl_tpu_torch.ops.quantization import quantize_blockwise

    shape = (nb, bs, HEADS, HEAD_DIM)
    out = [torch.randn(shape, generator=g, device="cuda") for _ in range(2)]
    for x in out[:2]:
        q8, sc = quantize_blockwise(x.reshape(-1), HEAD_DIM,
                                    scale_dtype=torch.float32)
        out += [q8.reshape(shape), sc.reshape(nb, bs, HEADS, 1)]
    return out


def forced(fa, splits):
    """``decode_splits`` forced to ``splits``, whatever the shape."""
    fa.decode_splits = lambda bh, limit, sms, s=splits: s


def frontier_sets(g, rows, pin_ends):
    """Random frontiers (with ``pin_ends``, rows 0 and 1 at 0 and the
    last position, as phase 3's K2 row), every row at 0, every row at
    the last position."""
    rand = torch.randint(0, MAX_LEN, (rows,), generator=g, device="cuda",
                         dtype=torch.int32)
    if pin_ends:
        rand[0], rand[1] = 0, MAX_LEN - 1
    return {"random": rand, "zero": torch.zeros_like(rand),
            "full": torch.full_like(rand, MAX_LEN - 1)}


def sweep_paged(cs, fa, g, rows, card, chosen, sms):
    """K3 and K3q over ``rows`` rows of 1024 positions, S forced 1-8."""
    for bs in (16, 128):
        mb = MAX_LEN // bs
        nb = rows * mb + 1
        kp, vp, k8, ks, v8, vs = pools(g, nb, bs)
        tables = torch.randperm(nb - 1, generator=g, device="cuda") \
            .reshape(rows, mb).to(torch.int32)
        q = torch.randn(rows, 1, HEADS, HEAD_DIM, generator=g, device="cuda")
        for label, pos in frontier_sets(g, rows, False).items():
            for splits in range(1, fa.DECODE_MAX_SPLITS + 1):
                forced(fa, splits)
                k3 = cs.device_ms(lambda: fa.flash_paged_decode_attention(
                    q, kp, vp, tables, pos))[0]
                k3q = cs.device_ms(lambda: fa.flash_paged_decode_attention(
                    q, k8, v8, tables, pos, k_scale=ks, v_scale=vs))[0]
                print(json.dumps({
                    "kernel": "K3", "rows": rows, "bs": bs,
                    "frontiers": label,
                    "visible_positions": int((pos.long() + 1).sum()),
                    "splits": splits,
                    "chosen": splits == chosen(rows * HEADS, MAX_LEN, sms),
                    "k3_ms": k3, "k3q_ms": k3q, "card": card}), flush=True)
            fa.decode_splits = chosen


def sweep_contiguous(cs, fa, g, rows, card, chosen, sms):
    """K2 over a cache of ``rows`` rows of 1024 positions, S forced 1-8."""
    shape = (rows, MAX_LEN, HEADS, HEAD_DIM)
    k, v = (torch.randn(shape, generator=g, device="cuda") for _ in range(2))
    q = torch.randn(rows, 1, HEADS, HEAD_DIM, generator=g, device="cuda")
    for label, pos in frontier_sets(g, rows, True).items():
        for splits in range(1, fa.DECODE_MAX_SPLITS + 1):
            forced(fa, splits)
            k2 = cs.device_ms(lambda: fa.flash_decode_attention(
                q, k, v, pos))[0]
            print(json.dumps({
                "kernel": "K2", "rows": rows, "frontiers": label,
                "visible_positions": int((pos.long() + 1).sum()),
                "splits": splits,
                "chosen": splits == chosen(rows * HEADS, MAX_LEN, sms),
                "k2_ms": k2, "card": card}), flush=True)
        fa.decode_splits = chosen


def main():
    if not torch.cuda.is_available():
        print("torch_decode_splits: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from bigdl_tpu_torch.ops import flash_attention as fa

    card = cs.card_line()
    g = torch.Generator(device="cuda").manual_seed(0)
    chosen = fa.decode_splits
    sms = fa.sm_count("cuda")
    # each kernel at the other's rows too: K3's engine has 8, K2's 9
    for rows in (B, K2_B):
        sweep_paged(cs, fa, g, rows, card, chosen, sms)
    for rows in (K2_B, B):
        sweep_contiguous(cs, fa, g, rows, card, chosen, sms)
    for rows in (B, K2_B):
        for splits in range(1, fa.DECODE_MAX_SPLITS + 1):
            ms = cs.device_ms(lambda: cs.launch_empty_kernel(
                rows * HEADS, splits))[0]
            print(json.dumps({"empty_kernel_clusters": rows * HEADS,
                              "splits": splits, "ms": ms, "card": card}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
