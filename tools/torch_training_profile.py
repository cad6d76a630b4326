#!/usr/bin/env python3
"""Where the time of a training step goes on the card, for the PyTorch
port (``bigdl_tpu_torch``): ``torch.profiler`` over a few steps of
``Optimizer(...).optimize()`` on TransformerLM "small" (vocab 32000,
max_len 1024, batch 8, random weights from a seed), after two warm-up
steps and the same number of steps timed without the profiler.

    python3 tools/torch_training_profile.py [--use-flash auto|never]
        [--criterion fused|plain] [--compute-dtype fp32|bf16] [--steps 3]
        [--sync-every K] [--package-root DIR]

``--use-flash never`` takes the plain attention and ``--criterion plain``
the plain cross-entropy, the baselines of ``chip_smoke.py`` phase 7;
``--compute-dtype bf16`` trains with ``set_compute_dtype(torch.bfloat16)``
(bf16 forward and backward on fp32 masters); ``--sync-every K`` reads the
loss every K-th step only (``set_sync_every``).  ``--package-root``
imports ``bigdl_tpu_torch`` from another checkout (for example a ``git
archive`` of a parent commit under ``build/``), which builds its own
kernels, so one call can measure two trees in turns.  Prints JSON lines:
the card (name, power limit), the steps' wall time and tokens/s with and
without the profiler, the device's busy time (union of kernel
intervals) and idle share against either wall, the host's CUDA launch
and copy calls per step, the shares of the port's own kernels and of
the library's matrix products, the steps compiled (CUDA graphs captured,
on a tree that has them, and their pool's bytes), the peak device memory
allocated and reserved over the run (warm-up and capture included), the
memory the run keeps at its end (allocated, and reserved once the
allocator's cache is emptied, with the graphs alive), and device time
by kernel name, largest first; then one more run of one step under the
allocator's history, and what was live at its peak, summed by the
innermost source line of the port (or of the tool) that allocated it.
All steps of the measurement are one ``optimize()``: each builds its
compiled step anew.  Needs a CUDA card.
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

from torch_serving_profile import (LAUNCH_CALLS, card_line,  # noqa: E402
                                   host_calls, union_us)

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


class StepClock:
    """An end trigger that also marks ``opt``'s loop: called at the top of
    every step with the loop's own state dict (the staging probe passes
    a copy, which is not marked), it ends the run after ``steps`` steps
    counted from its first call; at step ``i`` (0 = the first) it syncs
    the card when ``i`` is in ``sync_at``, records the time in
    ``marks[i]`` and runs ``then[i]()``."""

    def __init__(self, opt, steps, sync_at=(), then=None):
        self.opt, self.steps = opt, steps
        self.sync_at, self.then = set(sync_at), then or {}
        self.first, self.marks = None, {}

    def __call__(self, state):
        if self.first is None:
            self.first = state["neval"]
        i = state["neval"] - self.first
        if state is self.opt.driver_state and i not in self.marks:
            if i in self.sync_at:
                torch.cuda.synchronize()
            self.marks[i] = time.perf_counter()
            if i in self.then:
                self.then[i]()
        return i >= self.steps


def memory_peak(opt, trigger):
    """One more run of one step (``trigger``: the end after it; on a tree
    with compiled steps, its eager warm-up, capture and one replay) with
    the allocator's history recorded: prints the live bytes at its peak
    by allocation site, largest first."""
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
    ap.add_argument("--sync-every", type=int, default=1)
    ap.add_argument("--package-root", default=None,
                    help="checkout to import bigdl_tpu_torch from")
    args = ap.parse_args(argv)
    if args.package_root:
        sys.path.insert(0, str(Path(args.package_root).resolve()))
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
    x, y = synthetic_corpus(BATCH * (WARMUP + 2 * args.steps + 2), SEQ,
                            VOCAB)
    opt = optim.Optimizer(model, array_dataset(x, y)
                          >> SampleToMiniBatch(BATCH),
                          nn.TimeDistributedCriterion(inner),
                          optim.Adam(learning_rate=1e-4))
    if args.compute_dtype == "bf16":
        opt.set_compute_dtype(torch.bfloat16)
    if args.sync_every != 1:
        opt.set_sync_every(args.sync_every)
    # one run: WARMUP steps (on a tree with compiled steps the first
    # captures), ``steps`` timed without the profiler (its host cost slows
    # a host-bound step, so this wall is the step's own), ``steps`` under
    # it, then the memory the run keeps, read with its graphs alive, and
    # one more step, so the profiled window stages as many batches as it
    # runs
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    kept = {}

    def keeps():
        kept["allocated_bytes"] = torch.cuda.memory_allocated()
        torch.cuda.empty_cache()
        kept["reserved_with_graphs_bytes"] = torch.cuda.memory_reserved()

    a, b, c = WARMUP, WARMUP + args.steps, WARMUP + 2 * args.steps
    clock = StepClock(opt, c + 1, sync_at=(a, b, c),
                      then={b: prof.start, c: lambda: (prof.stop(),
                                                       keeps())})
    opt.set_end_when(clock)
    torch.cuda.reset_peak_memory_stats()
    opt.optimize()
    torch.cuda.synchronize()
    plain_wall = clock.marks[b] - clock.marks[a]
    wall = clock.marks[c] - clock.marks[b]
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
    calls = host_calls(prof)
    compiled = getattr(opt, "compiled_stats", None)
    print(json.dumps({
        "card": card, "package": str(Path(
            sys.modules["bigdl_tpu_torch"].__file__).parent),
        "use_flash": args.use_flash,
        "criterion": args.criterion, "compute_dtype": args.compute_dtype,
        "sync_every": args.sync_every,
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
        "host_launch_calls_per_step": sum(
            calls.get(n, 0) for n in LAUNCH_CALLS) / args.steps,
        "host_calls_per_step": {n: c / args.steps
                                for n, c in sorted(calls.items())},
        "compiled": None if compiled is None else {
            k: v for k, v in compiled.items() if k != "keys"},
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
        **kept}),
        flush=True)
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[
            :TOP_KERNELS]:
        print(json.dumps({"kernel": name[:120], "launches": n,
                          "device_ms": t / 1e3,
                          "share_of_busy": t / max(busy_us, 1e-9)}),
              flush=True)
    memory_peak(opt, optim.Trigger.max_iteration(
        opt.driver_state["neval"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
