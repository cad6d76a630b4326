#!/usr/bin/env python3
"""Where the time of a training step goes on the card, for the PyTorch
port (``bigdl_tpu_torch``): ``torch.profiler`` over a few steps of
``Optimizer(...).optimize()`` on TransformerLM "small" (vocab 32000,
max_len 1024, batch 8, random weights from a seed), after two warm-up
steps and the same number of steps timed without the profiler.

    python3 tools/torch_training_profile.py [--use-flash auto|never]
        [--criterion fused|plain] [--compute-dtype fp32|bf16] [--steps 3]

``--use-flash never`` takes the plain attention and ``--criterion plain``
the plain cross-entropy, the baselines of ``chip_smoke.py`` phase 7;
``--compute-dtype bf16`` trains with ``set_compute_dtype(torch.bfloat16)``
(bf16 forward and backward on fp32 masters).  Prints JSON lines: the
card (name, power limit), the steps' wall time and tokens/s with and
without the profiler, the device's busy time (union of kernel
intervals) and idle share against either wall, the shares of the port's
own kernels and of the library's matrix products, the peak device
memory of the run (warm-up included), and device time by kernel name,
largest first; then one more step under the allocator's history, and
what was live at its peak, summed by the innermost source line of the
port (or of the tool) that allocated it.  Needs a CUDA card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import torch

# run as a script from a checkout: the package sits beside tools/
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_serving_profile import card_line, union_us  # noqa: E402

VOCAB, SEQ, BATCH, WARMUP, TOP_KERNELS = 32000, 1024, 8, 2, 15
TOP_ALLOCATIONS = 12


def allocation_site(frames):
    """The innermost frame of the port's package (else of any file that
    is not torch's own) as ``file:line function``."""
    for pred in (lambda f: "bigdl_tpu_torch" in f["filename"],
                 lambda f: "/torch/" not in f["filename"]):
        for f in frames:
            if pred(f):
                name = f["filename"].split("bigdl_tpu_torch/")[-1]
                return f"{name}:{f['line']} {f['name']}"
    return "unknown"


def live_at_peak(trace):
    """Replay one device's allocator trace: the bytes live at the highest
    point, summed by allocation site, and that point's total."""
    live, total, peak, at_peak = {}, 0, -1, {}
    for ev in trace:
        if ev["action"] == "alloc":
            live[ev["addr"]] = (ev["size"], ev.get("frames", []))
            total += ev["size"]
            if total > peak:
                peak, at_peak = total, dict(live)
        elif ev["action"] in ("free_requested", "free") and \
                ev["addr"] in live:
            total -= live.pop(ev["addr"])[0]
    sites = {}
    for size, frames in at_peak.values():
        site = allocation_site(frames)
        n, b = sites.get(site, (0, 0))
        sites[site] = (n + 1, b + size)
    return peak, sites


def memory_peak(opt, trigger):
    """One more step (``trigger``: the end after it) with the allocator's
    history recorded: prints the live bytes at its peak by allocation
    site, largest first."""
    opt.set_end_when(trigger)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(max_entries=1_000_000)
    try:
        opt.optimize()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    peak, sites = live_at_peak(snap["device_traces"][0])
    # the trace holds the step's own allocations: ``before`` (weights,
    # optimizer state, staged batches) lies under them
    print(json.dumps({"allocated_before_step_bytes": before,
                      "step_allocations_live_at_peak_bytes": peak,
                      "sites": len(sites)}), flush=True)
    for site, (n, b) in sorted(sites.items(), key=lambda kv: -kv[1][1])[
            :TOP_ALLOCATIONS]:
        print(json.dumps({"live_at_peak": site, "blocks": n, "bytes": b}),
              flush=True)


#: name fragments of the port's hand-written kernels
OWN = ("flash_attn_kernel", "bwd_delta_kernel", "bwd_dkdv_kernel",
       "bwd_dq_kernel", "ce_fwd_kernel", "ce_bwd_kernel")
#: name fragments of the library's matrix products (cuBLAS, CUTLASS)
GEMM = ("gemm", "nvjet", "xmma")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--use-flash", default="auto", choices=("auto", "never"))
    ap.add_argument("--criterion", default="fused",
                    choices=("fused", "plain"))
    ap.add_argument("--compute-dtype", default="fp32",
                    choices=("fp32", "bf16"))
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_training_profile: needs a CUDA card", file=sys.stderr)
        return 1
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
    from bigdl_tpu_torch.models import synthetic_corpus, transformer_lm

    card = card_line()
    model = transformer_lm("small", VOCAB, max_len=SEQ, device="cuda",
                           seed=0, use_flash=args.use_flash)
    inner = nn.FusedSoftmaxCrossEntropyCriterion() \
        if args.criterion == "fused" else nn.CrossEntropyCriterion()
    x, y = synthetic_corpus(BATCH * (WARMUP + 2 * args.steps), SEQ, VOCAB)
    opt = optim.Optimizer(model, array_dataset(x, y)
                          >> SampleToMiniBatch(BATCH),
                          nn.TimeDistributedCriterion(inner),
                          optim.Adam(learning_rate=1e-4))
    if args.compute_dtype == "bf16":
        opt.set_compute_dtype(torch.bfloat16)
    opt.set_end_when(optim.Trigger.max_iteration(WARMUP))
    torch.cuda.reset_peak_memory_stats()
    opt.optimize()
    torch.cuda.synchronize()
    # the same number of steps without the profiler first: its host cost
    # slows a host-bound step, so this wall is the step's own
    opt.set_end_when(optim.Trigger.max_iteration(WARMUP + args.steps))
    t0 = time.perf_counter()
    opt.optimize()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    opt.set_end_when(optim.Trigger.max_iteration(WARMUP + 2 * args.steps))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        opt.optimize()
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
    own_us = sum(t for name, (_, t) in by_name.items()
                 if any(o in name for o in OWN))
    gemm_us = sum(t for name, (_, t) in by_name.items()
                  if any(g in name.lower() for g in GEMM))
    tokens = args.steps * BATCH * SEQ
    print(json.dumps({
        "card": card, "use_flash": args.use_flash,
        "criterion": args.criterion, "compute_dtype": args.compute_dtype,
        "steps": args.steps, "wall_s": wall,
        "step_s": wall / args.steps, "tokens_per_s": tokens / wall,
        "unprofiled_step_s": plain_wall / args.steps,
        "unprofiled_tokens_per_s": tokens / plain_wall,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "device_idle_share_unprofiled": 1.0 - busy_us / 1e6 / plain_wall,
        "own_kernels_share_of_busy": own_us / max(busy_us, 1e-9),
        "gemm_share_of_busy": gemm_us / max(busy_us, 1e-9),
        "kernel_launches": len(kernels),
        "peak_memory_bytes": torch.cuda.max_memory_allocated()}),
        flush=True)
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[
            :TOP_KERNELS]:
        print(json.dumps({"kernel": name[:120], "launches": n,
                          "device_ms": t / 1e3,
                          "share_of_busy": t / max(busy_us, 1e-9)}),
              flush=True)
    memory_peak(opt,
                optim.Trigger.max_iteration(WARMUP + 2 * args.steps + 1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
