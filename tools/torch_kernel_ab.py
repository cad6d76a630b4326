#!/usr/bin/env python3
"""Kernel times of several checkouts of the repository on one card, in
turn, for an A/B comparison of two commits (parent, change, change,
parent) within one run.

    python3 tools/torch_kernel_ab.py build/parent . . build/parent

Each checkout runs in a fresh process that imports its own
``chip_smoke.py`` and ``bigdl_tpu_torch``, builds its kernels into its
own build directory, and times phase 3's rows (K1, K2, K3) and, where the
checkout has it, phase 8's (K3q): device time from CUDA-graph replays.
Prints one JSON line per checkout, with the card's name and power limit:
``{"checkout": ..., "card": ..., "<kernel>_<case>": ms, ...}``.  Needs a
CUDA card.
"""

import json
import subprocess
import sys
from pathlib import Path


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
                         for r in rows}}), flush=True)


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
