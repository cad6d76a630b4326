#!/usr/bin/env python3
"""Where the time of a generation run goes on the card, for the PyTorch
port (``bigdl_tpu_torch``): ``torch.profiler`` over one
``ServingEngine.generate`` burst on TransformerLM "small" (random weights
from a seed).

    python3 tools/torch_serving_profile.py [--kv-cache paged|contiguous]
        [--use-flash auto|never] [--kv-cache-dtype fp32|int8]
        [--quantize] [--speculative K] [--package-root DIR]

The burst is the one ``chip_smoke.py`` serves: 8 greedy prompts of 17 to
700 tokens, 32 new tokens each, 8 decode slots.  After ``precompile()``
and a warm-up burst, ``TIMED_BURSTS`` bursts are timed without the
profiler (each one's tokens/s, ascending; the median burst's tokens/s,
wall time and TTFT) and one more under it.  Prints JSON lines: the card (name, power
limit); what ``precompile()`` returned and the generation steps built,
built after it and replayed (``stats()["generate"]["graphs"]``, null on
a tree without them); the bursts' wall time, tokens/s and TTFT; the
device's busy time (union of kernel intervals) and idle share under the
profiler; the host's CUDA calls (launches, graph launches, copies) by
name, per tick of the profiled burst and per decode tick (two profiled
requests of one short prompt, of 17 tokens and of 1, differenced); the
peak memory allocated over the whole run; and device time by kernel
name, largest first, with each kernel's share of the busy time.

``--package-root`` imports ``bigdl_tpu_torch`` from another checkout
(for example a ``git archive`` of a parent commit under ``build/``),
which builds its own kernels, so one call can measure two trees in
turns with the same tool.  Needs a CUDA card.
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
#: the prompts' seeds of the unprofiled bursts (1: the warm-up, 2: the
#: profiled burst, 4: the decode-tick requests)
TIMED_BURSTS = (3, 5, 6, 7, 8)
#: the host's launch calls (CUDA runtime and driver API) as the profiler
#: names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch")


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


def host_calls(prof):
    """The host's CUDA launch and copy calls in a profile, by name."""
    calls = {}
    for e in prof.events():
        if e.name in LAUNCH_CALLS or e.name.startswith("cudaMemcpy"):
            calls[e.name] = calls.get(e.name, 0) + 1
    return calls


def per_decode_tick(eng, prompt, acts, new_tokens=17):
    """Host calls per decode tick: a request of ``new_tokens`` less one of
    a single token, over their difference in scheduler ticks."""
    counts = []
    for n in (1, new_tokens):
        ticks = eng._gen.stats()["ticks"]
        with torch.profiler.profile(activities=acts) as prof:
            eng.generate(prompt, max_new_tokens=n).result(600)
            torch.cuda.synchronize()
        counts.append((host_calls(prof), eng._gen.stats()["ticks"] - ticks))
    (c1, t1), (cn, tn) = counts
    per = {k: (cn.get(k, 0) - c1.get(k, 0)) / (tn - t1)
           for k in set(c1) | set(cn)}
    return per, tn - t1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kv-cache", default="paged",
                    choices=("paged", "contiguous"))
    ap.add_argument("--use-flash", default="auto", choices=("auto", "never"))
    ap.add_argument("--kv-cache-dtype", default="fp32",
                    choices=("fp32", "int8"))
    ap.add_argument("--quantize", action="store_true",
                    help="serve the int8 twin")
    ap.add_argument("--speculative", type=int, default=0,
                    help="draft tokens a round with the int8 twin")
    ap.add_argument("--package-root", default=None,
                    help="checkout to import bigdl_tpu_torch from")
    args = ap.parse_args(argv)
    if args.package_root:
        sys.path.insert(0, str(Path(args.package_root).resolve()))
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

    def burst(seed):
        t0 = time.perf_counter()
        futs = [eng.generate(p, max_new_tokens=MAX_NEW_TOKENS)
                for p in prompts(seed)]
        out = [f.result(600) for f in futs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ttft = sorted(f.first_token_s for f in futs)
        return sum(len(o) for o in out), wall, ttft[len(ttft) // 2]

    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with ServingEngine(model, decode_slots=REQUESTS,
                       decode_max_len=1024, kv_cache=args.kv_cache,
                       kv_cache_dtype=args.kv_cache_dtype,
                       quantize=args.quantize,
                       speculative=args.speculative) as eng:
        t0 = time.perf_counter()
        precompiled = eng.precompile()
        precompile_s = time.perf_counter() - t0
        burst(1)                                # warm-up
        # fresh prompts in each burst: no prefix-cache hits
        timed = sorted((burst(seed) for seed in TIMED_BURSTS),
                       key=lambda b: b[0] / b[1])
        plain_tokens, plain_wall, ttft = timed[len(timed) // 2]
        ticks = eng._gen.stats()["ticks"]
        with torch.profiler.profile(activities=acts) as prof:
            tokens, wall, prof_ttft = burst(2)
        ticks = eng._gen.stats()["ticks"] - ticks
        tick_calls, decode_ticks = per_decode_tick(eng, prompts(4)[0][:8],
                                                   acts)
        graphs = eng.stats()["generate"].get("graphs") \
            if hasattr(eng, "stats") else None
    peak = torch.cuda.max_memory_allocated()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = union_us([(e.time_range.start, e.time_range.end)
                        for e in kernels])
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    calls = host_calls(prof)
    print(json.dumps({
        "card": card, "package_root": args.package_root or ".",
        "kv_cache": args.kv_cache,
        "use_flash": args.use_flash, "kv_cache_dtype": args.kv_cache_dtype,
        "quantize": args.quantize, "speculative": args.speculative,
        "requests": REQUESTS, "precompile_returned": precompiled,
        "precompile_s": precompile_s, "graphs": graphs,
        "tokens_per_s_unprofiled": plain_tokens / plain_wall,
        "tokens_per_s_unprofiled_bursts": [n / w for n, w, _ in timed],
        "wall_s_unprofiled": plain_wall, "ttft_median_s": ttft,
        "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
        "ttft_median_s_profiled": prof_ttft,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "kernel_launches": len(kernels), "ticks": ticks,
        "host_calls": calls,
        "host_launches_per_tick": sum(calls.get(n, 0)
                                      for n in LAUNCH_CALLS) / ticks,
        "host_calls_per_decode_tick": tick_calls,
        "host_launches_per_decode_tick": sum(
            tick_calls.get(n, 0) for n in LAUNCH_CALLS),
        "decode_ticks_profiled": decode_ticks,
        "peak_memory_bytes": peak}), flush=True)
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[
            :TOP_KERNELS]:
        print(json.dumps({"kernel": name[:120], "launches": n,
                          "device_ms": t / 1e3,
                          "share_of_busy": t / max(busy_us, 1e-9)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
