#!/usr/bin/env python3
"""Where the time of a training step goes on the card, for the PyTorch
port (``bigdl_tpu_torch``): ``torch.profiler`` over a few steps of
``Optimizer(...).optimize()`` on TransformerLM "small" (vocab 32000,
max_len 1024, batch 8, random weights from a seed), after two warm-up
steps.

    python3 tools/torch_training_profile.py [--use-flash auto|never]
        [--criterion fused|plain] [--steps 3]

``--use-flash never`` takes the plain attention and ``--criterion plain``
the plain cross-entropy, the baselines of ``chip_smoke.py`` phase 7.
Prints JSON lines: the card (name, power limit), the steps' wall time and
tokens/s, the device's busy time (union of kernel intervals) and idle
share, the share of the port's own kernels, and device time by kernel
name, largest first.  Needs a CUDA card.
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
#: name fragments of the port's hand-written kernels
OWN = ("flash_attn_kernel", "bwd_delta_kernel", "bwd_dkdv_kernel",
       "bwd_dq_kernel", "ce_fwd_kernel", "ce_bwd_kernel")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--use-flash", default="auto", choices=("auto", "never"))
    ap.add_argument("--criterion", default="fused",
                    choices=("fused", "plain"))
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
    x, y = synthetic_corpus(BATCH * (WARMUP + args.steps), SEQ, VOCAB)
    opt = optim.Optimizer(model, array_dataset(x, y)
                          >> SampleToMiniBatch(BATCH),
                          nn.TimeDistributedCriterion(inner),
                          optim.Adam(learning_rate=1e-4))
    opt.set_end_when(optim.Trigger.max_iteration(WARMUP))
    opt.optimize()
    torch.cuda.synchronize()
    opt.set_end_when(optim.Trigger.max_iteration(WARMUP + args.steps))
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
    tokens = args.steps * BATCH * SEQ
    print(json.dumps({
        "card": card, "use_flash": args.use_flash,
        "criterion": args.criterion, "steps": args.steps, "wall_s": wall,
        "step_s": wall / args.steps, "tokens_per_s": tokens / wall,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "own_kernels_share_of_busy": own_us / max(busy_us, 1e-9),
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
