#!/usr/bin/env python3
"""K6q's small route against its three-node route by input size, on one
card: where ``ops.act_quant.SMALL_LIMIT`` should sit.

    python3 tools/torch_act_quant_limit.py

The small route (``act_quant_small``: one launch of one thread-block
cluster of 1-8 blocks, each re-reading its share of x from L2) and the
three-node route (a memset, the absmax pass, the quantize pass) are timed
on the same fp32 and bf16 inputs from 512 to 2 M elements, each held
bitwise against the plain version.  Device time from CUDA-graph replays
(``chip_smoke.device_ms``), with the input rewritten by a copy ahead of
every call, as a producer would leave it in L2.  Prints one JSON line per
(dtype, size) with both times and the card's name and power limit, then
one line with the largest size up to which the small route is faster at
every size measured, by dtype.  Needs a CUDA card.
"""

import json
import sys
from pathlib import Path

import torch

# run as a script from a checkout: the package sits beside tools/
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SIZES = (512, 6144, 24576, 49152, 98304, 196608, 262144, 393216, 524288,
         786432, 1048576, 1572864, 2097152)


def main():
    if not torch.cuda.is_available():
        print("torch_act_quant_limit: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import act_quant as k6q

    _build.build()
    _build.load()
    card = chip_smoke.card_line()
    print(card, flush=True)
    g = torch.Generator(device="cuda").manual_seed(15)
    limits = {}
    for dtype in (torch.float32, torch.bfloat16):
        wins = True
        for n in SIZES:
            src = torch.randn(n, generator=g, device="cuda").to(dtype)
            x = src.clone()
            want = k6q.act_quant_reference(x)
            row = {"dtype": str(dtype), "elements": n,
                   "small_blocks": k6q.small_blocks(n), "card": card}
            for route in ("act_quant_small", "act_quant"):
                got = k6q.quantize_route(x, route)
                torch.cuda.synchronize()
                if not (torch.equal(got[0], want[0]) and
                        torch.equal(got[1], want[1])):
                    raise AssertionError(f"{route} at {n} {dtype}: not the "
                                         f"plain version's codes")

                def call(route=route):
                    x.copy_(src)
                    k6q.quantize_route(x, route)

                row[f"{route}_ms"] = chip_smoke.device_ms(call)
            copy_ms = chip_smoke.device_ms(lambda: x.copy_(src))
            row["copy_ms"] = copy_ms
            small = row["act_quant_small_ms"][0] - copy_ms[0]
            three = row["act_quant_ms"][0] - copy_ms[0]
            row["small_over_three"] = small / three
            wins = wins and small < three
            if wins:
                limits[str(dtype)] = n
            print(json.dumps(row), flush=True)
    print(json.dumps({"small_route_faster_up_to": limits, "card": card}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
