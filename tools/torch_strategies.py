#!/usr/bin/env python3
"""The port's model-parallel strategies at a world of four on NCCL, one
process a card: ``Optimizer(strategy=...)`` (``bigdl_tpu_torch/optim/
strategy_optimizer.py``) training TransformerLM "small" (768 wide, 12
heads of 64, 12 layers, vocab 32000, random weights from seed 0) at B8
T1024 in fp32 with ``Adam(1e-4)``, or its MoE sibling at the same widths
(8 experts, k 2, capacity factor 1.25); the heterogeneous pipeline leg
trains AlexNetOWT (no dropout, 1000 classes, seed 0) at batch 128 of
224 x 224 x 3 images with SGD.

    python3 tools/torch_strategies.py [--steps 8] [--out DIR]
        [--legs tp,sp_ring,sp_ulysses,ep,pp_gpipe,pp_1f1b,pp_tp_gpipe,
                pp_tp_1f1b,pp_het]
        [--meshes 1x4,2x2] [--no-recipe] [--het-batch 128]
        [--device cpu --width 32 --layers 2 --vocab 64 --seq-len 16]

needs four cards (``--device cpu`` rehearses the same program on gloo at
the sizes given, with no time worth reading).  The parent starts four ranks (this script with
``--rank R``, ``file://`` rendezvous in ``--out``), waits for them under a
deadline and kills them on a hang.  Each rank runs every leg on every
mesh -- tp over ``("data", "model")``, sp with ring and with Ulysses
attention over ``("data", "seq")``, ep over ``("data", "expert")``, pp
with GPipe and with 1F1B over ``("data", "pipe")`` (4 microbatches; on
1x4 three blocks a stage, the stage hops ``batch_isend_irecv``), pp
with tensor parallelism (``tensor_parallel=True``) with GPipe and with
1F1B over ``("data", "pipe", "model")`` on 1x2x2 only (six blocks a
stage, each stage's blocks over two ranks), and the heterogeneous
Sequential pipeline (``pp_het``: AlexNetOWT cut by parameter count, 4
microbatches) over ``("data", "pipe")`` -- for ``--steps`` steps, each
step one CUDA graph with NCCL's collectives captured in it, then
``models/run.py transformer-train --sp 4`` once.  Per leg and rank it
records the losses, the mean step time over steps 3 to ``steps - 2``
(host clock, ending in a sync), tokens/s (images/s for ``pp_het``) of
the global batch, the peak memory allocated, the graphs built, and,
under
``torch.profiler`` over the last two steps, the device's busy time and
the NCCL kernels' share of it (the collectives' share of the step).
Rank 0 prints one JSON line a leg (every rank's numbers in it) and
writes them all to ``DIR/strategies.json``; the last line is the card
line of every rank.  Held: the ranks' losses equal, the same strategy's
losses on the two meshes within 1e-4 relative, every step captured.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_serving_profile import union_us  # noqa: E402

BATCH, WORLD = 8, 4
#: the legs: mesh axes, the sequence mode (sp) or schedule (pp), and the
#: meshes the leg runs on (None: ``--meshes``)
LEGS = {"tp": (("data", "model"), None, None),
        "sp_ulysses": (("data", "seq"), "ulysses", None),
        "ep": (("data", "expert"), None, None),
        "sp_ring": (("data", "seq"), "ring", None),
        "pp_gpipe": (("data", "pipe"), "gpipe", None),
        "pp_1f1b": (("data", "pipe"), "1f1b", None),
        "pp_tp_gpipe": (("data", "pipe", "model"), "gpipe", "1x2x2"),
        "pp_tp_1f1b": (("data", "pipe", "model"), "1f1b", "1x2x2"),
        "pp_het": (("data", "pipe"), "gpipe", None)}
PP_MICRO = 4
MOE = {"num_experts": 8, "k": 2, "capacity_factor": 1.25}
LOSS_RTOL = 1e-4
TIMEOUT_S = 480


class _Losses:
    def __init__(self):
        self.losses = []

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.losses.append(float(value))


def _sync(args):
    if args.device == "cuda":
        torch.cuda.synchronize()


class _Clock:
    """End trigger: stops after ``steps`` steps, syncing and marking the
    host clock at the top of each from ``first`` on, and running the
    last ``profiled`` steps under ``torch.profiler``."""

    def __init__(self, opt, steps, first, profiled, sync):
        self.opt, self.steps, self.first, self.sync = opt, steps, first, sync
        self.profiled = profiled
        self.start, self.marks, self.prof = None, {}, None

    def __call__(self, state):
        if self.start is None:
            self.start = state["neval"]
        i = state["neval"] - self.start
        if state is self.opt.driver_state and i >= self.first \
                and i not in self.marks:
            self.sync()
            self.marks[i] = time.perf_counter()
            if i == self.steps - self.profiled:
                self.prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                self.prof.__enter__()
            elif i == self.steps:
                self.prof.__exit__(None, None, None)
        return i >= self.steps


def _model(leg, args):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.nn.moe import MoETransformerLM

    shape = (args.vocab, args.width, args.width // 64 or 4, args.layers)
    if leg == "ep":
        return MoETransformerLM(*shape, max_len=args.seq_len,
                                device=args.device, seed=0, **MOE)
    mode = LEGS[leg][1] if leg.startswith("sp") else None
    return nn.TransformerLM(*shape, max_len=args.seq_len,
                            device=args.device, seed=0,
                            seq_axis_name="seq" if mode else None,
                            seq_mode=mode or "ring")


def _profiled(prof, n):
    """Device busy ms a step and the NCCL kernels' share of it, over the
    ``n`` steps the profiler saw."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = union_us([(e.time_range.start, e.time_range.end)
                     for e in kernels])
    nccl = union_us([(e.time_range.start, e.time_range.end)
                     for e in kernels if "nccl" in e.name.lower()])
    return {"device_busy_ms": busy / 1e3 / n,
            "nccl_ms": nccl / 1e3 / n,
            "collective_share": nccl / busy if busy else None}


def _images(args):
    """Two batches of ``--het-batch`` images (NHWC, seed 0) and their
    classes."""
    g = torch.Generator().manual_seed(0)
    n = 2 * args.het_batch
    return (torch.randn((n, 224, 224, 3), generator=g).numpy(),
            torch.randint(0, 1000, (n,), generator=g,
                          dtype=torch.int32).numpy())


def run_leg(leg, mesh_shape, args, x, y):
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
    from bigdl_tpu_torch.models.alexnet import AlexNetOWT
    from bigdl_tpu_torch.utils.engine import Engine

    axes = LEGS[leg][0]
    steps = args.steps
    mesh = Engine.build_mesh(mesh_shape, axes)
    strategy = leg.split("_")[0]
    kw = {"n_microbatches": PP_MICRO, "schedule": LEGS[leg][1]} \
        if strategy == "pp" else {}
    batch = BATCH
    if leg == "pp_het":
        kw.pop("schedule")
        batch = args.het_batch
        model = AlexNetOWT(1000, has_dropout=False, device=args.device,
                           seed=0)
        x, y = _images(args)
        crit, method = nn.ClassNLLCriterion(), optim.SGD(
            learning_rate=0.01, momentum=0.9)
    else:
        if leg.startswith("pp_tp"):
            kw["tensor_parallel"] = True
        model = _model(leg, args)
        crit = nn.TimeDistributedCriterion(
            nn.FusedSoftmaxCrossEntropyCriterion())
        method = optim.Adam(learning_rate=1e-4)
    opt = optim.Optimizer(
        model, array_dataset(x, y) >> SampleToMiniBatch(batch), crit,
        method, strategy=strategy, mesh=mesh, device=args.device, **kw)
    summary = _Losses()
    opt.set_train_summary(summary)
    first, profiled = 2, 2
    clock = _Clock(opt, steps, first, profiled, lambda: _sync(args))
    opt.set_end_when(clock)
    if args.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    opt.optimize()
    last = steps - profiled
    step_s = (clock.marks[last] - clock.marks[first]) / (last - first)
    rate = ("images_per_s", batch / step_s) if leg == "pp_het" \
        else ("tokens_per_s", batch * args.seq_len / step_s)
    row = {"leg": leg, "mesh": dict(mesh.shape),
           "losses": summary.losses, "step_s": step_s, rate[0]: rate[1],
           "peak_allocated_bytes": torch.cuda.max_memory_allocated()
           if args.device == "cuda" else None,
           "route": opt.captured_route,
           "graphs": opt.compiled_stats["captured"],
           "replays": opt.compiled_stats["replays"],
           "graph_pool_bytes": opt.compiled_stats["pool_bytes"]}
    row.update(_profiled(clock.prof, profiled))
    del opt, model
    if args.device == "cuda":
        torch.cuda.empty_cache()
    return row


def run_recipe(args):
    from bigdl_tpu_torch.models import run

    t0 = time.perf_counter()
    argv = ["transformer-train", "--sp", "4", "--size",
            "small" if args.device == "cuda" else "tiny", "--vocab",
            str(args.vocab), "--seq-len", str(args.seq_len), "-b",
            str(BATCH), "--maxIteration", "4", "--synthN", "64"]
    opt = run.main(argv + ["--device", args.device])
    _sync(args)
    return {"leg": "recipe_sp4", "mesh": dict(opt.mesh.shape),
            "loss": opt.driver_state["loss"],
            "wall_s": time.perf_counter() - t0,
            "route": opt.captured_route,
            "graphs": opt.compiled_stats["captured"]}


def rank_main(args):
    import torch.distributed as dist

    from bigdl_tpu_torch.models import synthetic_corpus
    from bigdl_tpu_torch.ops import _build

    rank = args.rank
    on_card = args.device == "cuda"
    if on_card:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        _build.load()
    else:
        torch.set_num_threads(1)
    out = Path(args.out)
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=f"file://{out / 'rdv'}",
                            world_size=WORLD, rank=rank)
    rows = [{"leg": "card", "card": card_line(rank) if on_card
             else "cpu rehearsal"}]

    def record(row):
        # written after every leg: a rank killed later keeps what it did
        rows.append(row)
        (out / f"rank{rank}.json").write_text(json.dumps(rows))

    try:
        x, y = synthetic_corpus(64, args.seq_len, args.vocab)
        for leg in args.legs.split(","):
            for m in (LEGS[leg][2] or args.meshes).split(","):
                shape = tuple(int(s) for s in m.split("x"))
                t0 = time.perf_counter()
                try:
                    row = run_leg(leg, shape, args, x, y)
                except Exception as e:   # recorded; the other legs go on
                    row = {"leg": leg, "mesh": m, "error": repr(e)}
                record(dict(row, leg_wall_s=time.perf_counter() - t0))
        if not args.no_recipe:
            try:
                record(run_recipe(args))
            except Exception as e:
                record({"leg": "recipe_sp4", "error": repr(e)})
    finally:
        dist.destroy_process_group()
    return 0


def card_line(index):
    return subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def check(rows_by_rank, route):
    problems = []
    legs = {}
    for r, rows in enumerate(rows_by_rank):
        for row in rows:
            if "error" in row:
                problems.append(f"rank {r} {row['leg']} {row.get('mesh')}: "
                                f"{row['error']}")
            if "losses" not in row:
                continue
            legs.setdefault((row["leg"], str(row["mesh"])), []).append(row)
            if row["route"] != route or row["graphs"] != 1:
                problems.append(f"rank {r} {row['leg']}: not one captured "
                                f"graph ({row['route']}, {row['graphs']})")
    by_leg = {}
    for (leg, mesh), rows in legs.items():
        if any(r["losses"] != rows[0]["losses"] for r in rows):
            problems.append(f"{leg} {mesh}: the ranks' losses differ")
        by_leg.setdefault(leg, []).append(rows[0]["losses"])
    for leg, runs in by_leg.items():
        for other in runs[1:]:
            rel = max(abs(a - b) / abs(b) for a, b in zip(other, runs[0]))
            if rel > LOSS_RTOL:
                problems.append(f"{leg}: the meshes' losses differ by {rel}")
    return problems


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--out", default="build/strategies")
    p.add_argument("--legs", default=",".join(LEGS))
    p.add_argument("--meshes", default="1x4,2x2")
    p.add_argument("--no-recipe", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--width", type=int, default=768)
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--vocab", type=int, default=32000)
    p.add_argument("--seq-len", type=int, default=1024, dest="seq_len")
    p.add_argument("--het-batch", type=int, default=128, dest="het_batch")
    p.add_argument("--rank", type=int, default=None)
    args = p.parse_args()
    if args.rank is not None:
        return rank_main(args)
    if args.device == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < WORLD):
        print(f"torch_strategies: needs {WORLD} CUDA cards", file=sys.stderr)
        return 1
    # absolute: a relative path in a file:// URL reads as a host name
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    for f in out.glob("rank*.json"):
        f.unlink()
    (out / "rdv").unlink(missing_ok=True)
    cmd = [sys.executable, str(Path(__file__).resolve()), "--steps",
           str(args.steps), "--out", str(out), "--legs", args.legs,
           "--meshes", args.meshes, "--device", args.device, "--width",
           str(args.width), "--layers", str(args.layers), "--vocab",
           str(args.vocab), "--seq-len", str(args.seq_len), "--het-batch",
           str(args.het_batch)] + (
        ["--no-recipe"] if args.no_recipe else [])
    if args.device == "cuda":
        from bigdl_tpu_torch.ops import _build

        t0 = time.perf_counter()
        _build.build()              # once, before the ranks load it
        print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    logs = [open(out / f"rank{r}.log", "w") for r in range(WORLD)]
    env = dict(os.environ, OMP_NUM_THREADS="4")
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], stdout=logs[r],
                              stderr=subprocess.STDOUT, env=env)
             for r in range(WORLD)]
    deadline = time.monotonic() + TIMEOUT_S
    hung = False
    try:
        while any(q.poll() is None for q in procs):
            if time.monotonic() > deadline:
                hung = True
                break
            if any(q.returncode not in (None, 0) for q in procs):
                break
            time.sleep(0.5)
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
        for f in logs:
            f.close()
    bad = [r for r, q in enumerate(procs) if q.returncode != 0]
    for r in bad:
        print((out / f"rank{r}.log").read_text()[-3000:], file=sys.stderr)
    rows_by_rank = [json.loads((out / f"rank{r}.json").read_text())
                    if (out / f"rank{r}.json").exists() else []
                    for r in range(WORLD)]
    n_rows = min(len(rows) for rows in rows_by_rank)
    for i, row in enumerate(rows_by_rank[0][:n_rows]):
        if row["leg"] == "card" or "error" in row:
            continue
        print(json.dumps({**row, "by_rank": [
            {k: rows[i].get(k) for k in ("step_s", "peak_allocated_bytes",
                                         "collective_share", "nccl_ms",
                                         "device_busy_ms", "wall_s",
                                         "leg_wall_s")}
            for rows in rows_by_rank]}), flush=True)
    problems = check(rows_by_rank, "nccl-graph" if args.device == "cuda"
                     else "eager")
    if hung:
        problems.append(f"ranks killed at the {TIMEOUT_S} s deadline")
    problems += [f"rank {r} exited {procs[r].returncode}" for r in bad]
    (out / "strategies.json").write_text(json.dumps(
        {"ranks": rows_by_rank, "problems": problems}))
    print(json.dumps({"cards": [rows[0]["card"] if rows else None
                                for rows in rows_by_rank],
                      "problems": problems}))
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
