#!/usr/bin/env python3
"""Kernel times of several checkouts of the repository on one card, in
turn, for an A/B comparison of two commits (parent, change, change,
parent) within one run.

    python3 tools/torch_kernel_ab.py build/parent . . build/parent

Each checkout runs in a fresh process that imports its own
``chip_smoke.py`` and ``bigdl_tpu_torch``, builds its kernels into its
own build directory, and times phase 3's rows (K1, K2, K3, and the
empty-kernel floor where the checkout has it) and, where the checkout
has it, phase 8's (K3q) and phase 13's K6 rows (``int8_conv_rows``:
ResNet-50's convolutions at batch 128 and two coverage shapes, each
held bitwise against its plain version) and its K7 and K6q rows
(``INT8_ELEMENTWISE_ROWS``: ``bn_act_row`` and ``act_quant_rows`` at
ResNet-50's shapes at batch 128, bitwise too), then K1 and K1-bwd at
phase 3's and phase 6's shapes (``K1_SHAPES``, ``K1_BWD_SHAPES``: fp32, H 12, D 64,
causal, q/k/v views of one fused buffer) through the checkout's own
wrappers, so that a checkout without a row still gets it timed: device
time from CUDA-graph replays.
Prints one JSON line per checkout, with the card's name and power limit:
``{"checkout": ..., "card": ..., "<kernel>_<case>": ms, "K6_<row>": ms,
...}``.  Then,
for each checkout after the first, one line comparing the SASS of every
attention kernel instantiation it shares with the first (``cuobjdump
-sass`` of each checkout's ``flash_attention`` library; the split-KV
kernel's ``PAGED = true`` flag is dropped from its name, so K3 and K3q
of a checkout that has the flag meet those of one that has not):
``{"sass_vs": ..., "identical": [...], "differ": {name: [line, first's,
other's]}, ...}``, SASS compared with its padding collapsed.  Needs a
CUDA card.
"""

import json
import re
import subprocess
import sys
from pathlib import Path


#: (B, T) of the K1 forward rows and of the K1-bwd rows
K1_SHAPES = ((2, 1024), (1, 200), (8, 1024))
K1_BWD_SHAPES = ((8, 1024), (8, 200))
#: K7's rows (shape, form: 1 BN + ReLU, 2 BN + add + ReLU) and K6q's
#: (shape, route), at ResNet-50's sizes at batch 128
INT8_ELEMENTWISE_ROWS = (
    (((128, 112, 112, 64), 1), ((128, 56, 56, 256), 2),
     ((128, 14, 14, 1024), 2)),
    (((128, 56, 56, 256), "act_quant_given"),
     ((128, 14, 14, 1024), "act_quant_given"),
     ((128, 56, 56, 64), "act_quant")))


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


def row_key(r):
    phase = r.get("phase")
    if phase == "int8_conv":
        return f"K6_{r['shape']}"
    if phase == "bn_act":
        return f"K7_{r['shape']} {r['form']}"
    if phase == "act_quant":
        return f"K6q_{r['route']}_{r['shape']}"
    return f"{r['name']}_{r['case']}"


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
    if hasattr(cs, "int8_conv_rows"):
        cs.int8_conv_rows(card)
    if hasattr(cs, "bn_act_row"):
        k7_rows, k6q_rows = INT8_ELEMENTWISE_ROWS
        for i, (shape, form) in enumerate(k7_rows):
            cs.bn_act_row(card, shape, form, i)
        cs.act_quant_rows(card, k6q_rows)
    print(json.dumps({"checkout": root, "card": card,
                      **{row_key(r): r["ms"] for r in rows},
                      **attention_rows(cs, fa)}), flush=True)


#: nvcc's name for a source's anonymous namespace, which differs between
#: checkouts of different sources
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")


def sass_bodies(root):
    """Each kernel instantiation's SASS in a checkout's built
    ``flash_attention`` library, by name (``paged_decode_kernel<fLi64ELb0>``
    for a mangled name with plain template arguments, ``PAGED = true``
    dropped)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs
    from bigdl_tpu_torch.ops import _build

    lib, = (p for p in (Path(root) / "build" /
                        "bigdl_tpu_torch_kernels").iterdir()
            if re.fullmatch(r"libflash_attention_[0-9a-f]{16}\.so", p.name))
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    bodies, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = cs.kernel_name(ANON.sub(
                "_GLOBAL__N_", line.split("Function :")[-1].strip()))
            name = re.sub(r"^(paged_decode_kernel<\w+Lb[01])ELb1>$", r"\1>",
                          name)
            bodies[name] = []
        elif name is not None:
            # the anonymous namespace's name carries a hash of the source,
            # and cuobjdump pads columns to the longest name
            bodies[name].append(" ".join(ANON.sub("_GLOBAL__N_",
                                                  line).split()))
    return bodies


def first_difference(a, b):
    """The first pair of SASS lines where two bodies part."""
    i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
             min(len(a), len(b)))
    return [i, a[i] if i < len(a) else None, b[i] if i < len(b) else None]


def main(argv):
    if len(argv) == 2 and argv[0] == "--one":
        one(argv[1])
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)
    first = sass_bodies(argv[0])
    for root in dict.fromkeys(argv[1:]):
        other = sass_bodies(root)
        shared = sorted(set(first) & set(other))
        print(json.dumps({
            "sass_vs": [str(Path(argv[0]).resolve()),
                        str(Path(root).resolve())],
            "identical": [k for k in shared if first[k] == other[k]],
            "differ": {k: first_difference(first[k], other[k])
                       for k in shared if first[k] != other[k]},
            "only_first": sorted(set(first) - set(other)),
            "only_other": sorted(set(other) - set(first))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
