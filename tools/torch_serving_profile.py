#!/usr/bin/env python3
"""Where the time of a generation run goes on the card, for the PyTorch
port (``bigdl_tpu_torch``): ``torch.profiler`` over one
``ServingEngine.generate`` burst on TransformerLM "small" (random weights
from a seed).

    python3 tools/torch_serving_profile.py [--kv-cache paged|contiguous]
        [--use-flash auto|never]

The burst is the one ``chip_smoke.py`` serves: 8 greedy prompts of 17 to
700 tokens, 32 new tokens each, 8 decode slots.  Prints JSON lines: the card (name, power limit), the burst's wall time,
the device's busy time (union of kernel intervals) and idle share, and
device time by kernel name, largest first, with each kernel's share of
the busy time.  Needs a CUDA card.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# run as a script from a checkout: the package sits beside tools/
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

REQUESTS, MAX_NEW_TOKENS, TOP_KERNELS = 8, 32, 15


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()


def union_us(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kv-cache", default="paged",
                    choices=("paged", "contiguous"))
    ap.add_argument("--use-flash", default="auto", choices=("auto", "never"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_serving_profile: needs a CUDA card", file=sys.stderr)
        return 1
    from bigdl_tpu_torch.models import synthetic_corpus, transformer_lm
    from bigdl_tpu_torch.serving import ServingEngine

    card = card_line()
    vocab = 32000
    model = transformer_lm("small", vocab_size=vocab, device="cuda", seed=0,
                           use_flash=args.use_flash)
    lengths = np.linspace(17, 700, REQUESTS).astype(int)

    def prompts(seed):
        toks, _ = synthetic_corpus(REQUESTS, 700, vocab, seed=seed)
        return [toks[i, :n] for i, n in enumerate(lengths)]

    with ServingEngine(model, decode_slots=REQUESTS,
                       decode_max_len=1024, kv_cache=args.kv_cache) as eng:
        eng.precompile()
        warm = [eng.generate(p, max_new_tokens=MAX_NEW_TOKENS)
                for p in prompts(1)]
        [f.result(600) for f in warm]
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        # fresh prompts: no prefix-cache hits from the warm-up burst
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            futs = [eng.generate(p, max_new_tokens=MAX_NEW_TOKENS)
                    for p in prompts(2)]
            out = [f.result(600) for f in futs]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = union_us([(e.time_range.start, e.time_range.end)
                        for e in kernels])
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    tokens = sum(len(o) for o in out)
    print(json.dumps({
        "card": card, "kv_cache": args.kv_cache,
        "use_flash": args.use_flash, "requests": REQUESTS,
        "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "kernel_launches": len(kernels)}), flush=True)
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[
            :TOP_KERNELS]:
        print(json.dumps({"kernel": name[:120], "launches": n,
                          "device_ms": t / 1e3,
                          "share_of_busy": t / max(busy_us, 1e-9)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
