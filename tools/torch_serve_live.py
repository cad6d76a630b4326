#!/usr/bin/env python3
"""The train -> serve loop of the PyTorch port, live: a trainer child
writes snapshots while an engine serves, shadows, canaries and promotes
them (the port's copy of ``tools/serve_live.py``).

The driver serves the drill's TransformerLM through a ``ServingEngine``
under closed-loop client load while a trainer child
(``--role trainer``) trains the same model through ``LocalOptimizer``,
writing crash-safe snapshots into ``--out/ckpt``.  A
``RolloutController`` polls that directory and walks every new snapshot
through shadow -> canary -> cutover, each stage recorded in
``--out/serve/events.jsonl``.

    # the live loop on the CPU: 3 snapshot generations
    python -m tools.torch_serve_live --device cpu --out /tmp/live \\
        --steps 18 --ckptEvery 6

    # a poisoned candidate is caught in shadow and rejected
    python -m tools.torch_serve_live --device cpu --out /tmp/p --poison

    # SIGKILL mid-cutover; re-running with --noTrainer resumes from the
    # durable registry and serves the last committed version bit for bit
    python -m tools.torch_serve_live --device cpu --out /tmp/c \\
        --chaos kill:cutover:2

Without ``--device`` every process runs on the CUDA card and raises where
there is none.  The movielens workload needs the port's ``nn/sparse`` and
its dataset (ROADMAP A9) and is refused; ``--sloLatencyMs`` and
``--metricsPort`` need the metrics registry (A8) and are refused.

Artifacts under ``--out``: ``ckpt/`` (the trainer's snapshots),
``registry.json`` (the durable version registry, the JAX package's
format), ``serve/events.jsonl``, ``live_history.jsonl`` (one line per
served version: id, manifest digest, probe digest), ``trainer.log``,
``result.json``.  The model is built from ``--seed``, so the trainer and
the driver hold the same tree and the same baseline weights.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:                 # run as a script by the drills
    sys.path.insert(0, REPO)

#: the drill's TransformerLM (the JAX tool's, ``tools/serve_live.py``)
VOCAB, SEQ, WIDTH, HEADS, LAYERS = 48, 16, 32, 4, 2


def build_args(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--out", required=True, help="artifact root directory")
    ap.add_argument("--device", default=None,
                    help="torch device of every process (default: the "
                         "CUDA card)")
    ap.add_argument("--workload", choices=("transformer", "movielens"),
                    default="transformer")
    ap.add_argument("--steps", type=int, default=18,
                    help="trainer steps (a snapshot every --ckptEvery)")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--datasetSize", type=int, default=256)
    ap.add_argument("--ckptEvery", type=int, default=6)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--maxBatch", type=int, default=8,
                    help="serving max_batch_size")
    ap.add_argument("--maxWaitMs", type=float, default=1.0)
    ap.add_argument("--clients", type=int, default=2,
                    help="closed-loop client threads")
    ap.add_argument("--shadowFraction", type=float, default=0.5)
    ap.add_argument("--shadowRows", type=int, default=16,
                    help="real rows the shadow stage must compare")
    ap.add_argument("--agreement", type=float, default=None,
                    help="shadow min top-1 agreement against the live "
                         "version (opt-in)")
    ap.add_argument("--maxLogitRmse", type=float, default=100.0,
                    help="shadow max logit RMSE against live: the poison "
                         "catch")
    ap.add_argument("--canaryFraction", type=float, default=0.25)
    ap.add_argument("--canaryTicks", type=int, default=4)
    ap.add_argument("--stageTimeout", type=float, default=60.0)
    ap.add_argument("--watchSeconds", type=float, default=1.0,
                    help="post-cutover rollback watch window")
    ap.add_argument("--sloLatencyMs", type=float, default=None,
                    help="a latency SLO objective (refused: ROADMAP A8)")
    ap.add_argument("--metricsPort", type=int, default=None,
                    help="/metrics + /healthz (refused: ROADMAP A8)")
    ap.add_argument("--poison", action="store_true",
                    help="after the trainer completes, drop a poisoned "
                         "candidate snapshot; the rollout must reject it")
    ap.add_argument("--chaos", default=None,
                    help="deploy fault injection: kill:cutover:<n> "
                         "(SIGKILL the driver mid-way through its n-th "
                         "cutover)")
    ap.add_argument("--noTrainer", action="store_true",
                    help="serve + poll only (the restart leg of the chaos "
                         "drill)")
    ap.add_argument("--idleRounds", type=int, default=8,
                    help="stop after this many quiet poll rounds once the "
                         "trainer exited")
    ap.add_argument("--role", choices=("driver", "trainer"),
                    default="driver", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def refuse_unported(args):
    """The flags whose machinery is not ported, refused by name."""
    from bigdl_tpu_torch.utils.errors import UnsupportedFeatureError

    if args.workload == "movielens":
        raise UnsupportedFeatureError(
            "the movielens workload needs the port's nn/sparse and its "
            "movielens dataset: ROADMAP A9")
    for flag in ("sloLatencyMs", "metricsPort"):
        if getattr(args, flag, None) is not None:
            raise UnsupportedFeatureError(
                f"--{flag} needs the metrics registry and exporter "
                f"(observability/metrics.py): ROADMAP A8")
    if getattr(args, "traceSample", None) is not None:
        raise UnsupportedFeatureError(
            "--traceSample needs request tracing "
            "(observability/tracing.py): ROADMAP A8")


# --------------------------------------------------------------------------- #
# The workload: (model, eval features, labels, criterion) from a seed.
# --------------------------------------------------------------------------- #


def build_workload(args):
    """The drill's TransformerLM (vocab 48, d 32, 4 heads, 2 layers, seq
    16) with weights from ``args.seed`` on ``args.device``, seeded token
    features, next-token labels and the time-distributed cross-entropy."""
    import numpy as np

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.nn import TransformerLM

    refuse_unported(args)
    model = TransformerLM(VOCAB, WIDTH, HEADS, num_layers=LAYERS,
                          max_len=SEQ, device=args.device, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    x = rng.integers(0, VOCAB, (args.datasetSize, SEQ)).astype("int32")
    y = np.roll(x, -1, axis=1).astype("int32")
    crit = nn.TimeDistributedCriterion(nn.CrossEntropyCriterion())
    return model, x, y, crit


# --------------------------------------------------------------------------- #
# Trainer child: supervised training with a snapshot cadence.
# --------------------------------------------------------------------------- #


def run_trainer(args):
    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset

    model, x, y, crit = build_workload(args)
    ds = array_dataset(x, y, seed=args.seed) >> SampleToMiniBatch(args.batch)
    opt = optim.LocalOptimizer(
        model, ds, crit,
        optim.SGD(learning_rate=args.lr, momentum=0.9, dampening=0.0),
        device=args.device)
    opt.set_checkpoint(os.path.join(args.out, "ckpt"),
                       optim.Trigger.several_iteration(args.ckptEvery))
    opt.set_end_when(optim.Trigger.max_iteration(args.steps))
    opt.optimize()
    return 0


def poison_params(params):
    """The outlier-poisoning recipe on the output plane of a JAX-layout
    parameter tree (numpy leaves): the head's weight crushed to ~zero
    except one huge input column, so the logits collapse onto a rank-1
    ruin -- the candidate a shadow comparison must catch."""
    import numpy as np

    flat = []

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat.append((path + (k,), v))

    walk(params, ())
    mats = [(p, v) for p, v in flat if getattr(v, "ndim", 0) == 2]
    if not mats:
        raise ValueError("no 2-D weight plane to poison")
    heads = [(p, v) for p, v in mats if any("head" in str(k) for k in p)]
    path, leaf = heads[-1] if heads else mats[-1]
    w = np.array(leaf, np.float32) * 1e-5
    w.reshape(w.shape[0], -1)[:, 0] = \
        np.random.default_rng(9).standard_normal(w.shape[0]) * 1e3
    node = params
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = w
    return params


def write_poisoned_snapshot(args, model):
    """Drop a poisoned candidate into the checkpoint directory with a tag
    newer than anything the trainer wrote (manifest-stamped, so it passes
    intact resolution: the rollout must reject it, not the integrity
    layer)."""
    from bigdl_tpu_torch.interop.jax_params import to_jax_params
    from bigdl_tpu_torch.utils import file_io

    ckpt = os.path.join(args.out, "ckpt")
    os.makedirs(ckpt, exist_ok=True)
    target = os.path.join(ckpt, f"checkpoint.{args.steps + 1000}.pkl")
    file_io.atomic_save(
        {"model_params": poison_params(to_jax_params(model)),
         "model_state": None}, target)
    file_io.write_snapshot_manifest(target)
    return target


# --------------------------------------------------------------------------- #
# Driver: engine + registry + rollout + client load (+ chaos).
# --------------------------------------------------------------------------- #


class EventLog:
    """A telemetry sink: each ``record(kind, **fields)`` is one JSON line
    of ``<dir>/events.jsonl`` (flushed per line), kept in ``events`` too."""

    def __init__(self, directory):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, "events.jsonl")
        self._f = open(self.path, "a")
        self._lock = threading.Lock()
        self.events = []

    def record(self, kind, **fields):
        ev = {"kind": kind, "ts": time.time(), **fields}
        line = json.dumps(ev, default=str)
        with self._lock:
            self.events.append(ev)
            if not self._f.closed:
                self._f.write(line + "\n")
                self._f.flush()

    def set_serving_info(self, info):
        self.record("serving_info", **info)

    def close(self):
        with self._lock:
            self._f.close()


def serve_dir_of(out):
    """A fresh serve directory per invocation, so a restarted driver
    never overwrites the previous run's event trail."""
    serve_dir = os.path.join(out, "serve")
    k = 1
    while os.path.exists(os.path.join(serve_dir, "events.jsonl")):
        serve_dir = os.path.join(out, f"serve_r{k}")
        k += 1
    return serve_dir


def make_chaos(spec, out):
    """-> a ``chaos(stage, version)`` hook for the RolloutController, or
    None.  On the configured cutover it leaves a marker file and SIGKILLs
    this process."""
    from bigdl_tpu_torch.serving.deploy import parse_deploy_chaos

    parsed = parse_deploy_chaos(spec)
    if parsed is None:
        return None
    _, _, nth = parsed
    count = {"n": 0}

    def chaos(stage, version):
        if stage != "cutover":
            return
        count["n"] += 1
        if count["n"] == nth:
            with open(os.path.join(out, "chaos_fired.json"), "w") as f:
                json.dump({"cutover": nth, "version": version.version}, f)
            print(f"[torch_serve_live] chaos: SIGKILL mid-cutover #{nth} "
                  f"(v{version.version})", file=sys.stderr)
            sys.stderr.flush()
            os.kill(os.getpid(), signal.SIGKILL)

    return chaos


def child_env():
    """The environment of a child process: the repo on the path and one
    math thread (the drill's processes share the host's cores)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def start_trainer(args):
    """The trainer child, a fresh interpreter, its output in
    ``trainer.log``."""
    cmd = [sys.executable, os.path.join(REPO, "tools", "torch_serve_live.py"),
           "--role", "trainer", "--out", args.out, "--workload",
           args.workload, "--steps", str(args.steps), "--batch",
           str(args.batch), "--datasetSize", str(args.datasetSize),
           "--ckptEvery", str(args.ckptEvery), "--lr", str(args.lr),
           "--seed", str(args.seed)]
    if args.device is not None:
        cmd += ["--device", str(args.device)]
    with open(os.path.join(args.out, "trainer.log"), "w") as logf:
        proc = subprocess.Popen(cmd, env=child_env(), stdout=logf,
                                stderr=subprocess.STDOUT, cwd=REPO)
    print(f"[torch_serve_live] trainer pid {proc.pid}", file=sys.stderr)
    return proc


def stop_child(proc, timeout=30.0):
    """Terminate a child and wait for it (killed if it outlives
    ``timeout``)."""
    if proc is None:
        return
    if proc.poll() is None:
        proc.terminate()
    try:
        proc.wait(timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout)


def run_driver(args):
    import numpy as np

    from bigdl_tpu_torch.serving import (ModelRegistry, RolloutController,
                                         ServingEngine)
    from bigdl_tpu_torch.serving.worker import probe_digest

    os.makedirs(args.out, exist_ok=True)
    chaos = make_chaos(args.chaos, args.out)   # fail fast on a typo
    model, x, y, crit = build_workload(args)
    serve_dir = serve_dir_of(args.out)
    tel = EventLog(serve_dir)

    eng = ServingEngine(model, max_batch_size=args.maxBatch,
                        max_wait_ms=args.maxWaitMs, telemetry=tel,
                        device=args.device)
    eng.precompile(example_feature=x[0])
    execs0 = eng._executables()
    probe_rows = x[:4]
    probe_bucket = min(4, args.maxBatch)

    registry = ModelRegistry(os.path.join(args.out, "registry.json"))
    ctl = RolloutController(
        eng, registry, os.path.join(args.out, "ckpt"), telemetry=tel,
        shadow_fraction=args.shadowFraction,
        shadow_min_rows=args.shadowRows,
        min_top1_agreement=args.agreement,
        max_logit_rmse=args.maxLogitRmse,
        canary_fraction=args.canaryFraction,
        canary_min_ticks=args.canaryTicks,
        stage_timeout_s=args.stageTimeout,
        post_cutover_watch_s=args.watchSeconds, chaos=chaos)
    resumed = registry.live is not None
    if resumed:
        ctl.resume()
    else:
        ctl.baseline()

    history_path = os.path.join(args.out, "live_history.jsonl")

    def record_live():
        live = registry.live
        rec = {"version": live.version, "digest": live.digest,
               "probe": probe_digest(eng, probe_rows, probe_bucket),
               "ts": time.time()}
        with open(history_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())
        return rec

    record_live()

    stop = threading.Event()
    stats = {"ok": 0, "failed": 0}
    stats_lock = threading.Lock()

    def client(seed):
        idx = np.random.default_rng(seed)
        while not stop.is_set():
            try:
                eng.predict(x[int(idx.integers(0, len(x)))], timeout=30.0)
                with stats_lock:
                    stats["ok"] += 1
            except Exception:
                if stop.is_set():
                    return
                with stats_lock:
                    stats["failed"] += 1

    clients = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(args.clients)]
    for t in clients:
        t.start()

    trainer = None if args.noTrainer else start_trainer(args)
    poisoned_path = None
    idle = 0
    last_live = registry.live.version
    try:
        while True:
            v = ctl.poll_once()
            ctl.check_watch()
            if registry.live.version != last_live:
                last_live = registry.live.version
                record_live()
            with stats_lock:
                tel.record("client", **stats)
            trainer_done = trainer is None or trainer.poll() is not None
            if trainer_done and args.poison and poisoned_path is None:
                poisoned_path = write_poisoned_snapshot(args, model)
                print(f"[torch_serve_live] poisoned candidate: "
                      f"{poisoned_path}", file=sys.stderr)
                idle = 0
                continue
            idle = idle + 1 if (trainer_done and v is None) else 0
            if idle >= args.idleRounds:
                break
            time.sleep(0.1)
    finally:
        stop.set()
        for t in clients:
            t.join(5)
        stop_child(trainer)

    final = record_live()
    compiles = eng._executables() - execs0
    eng.close()
    with stats_lock:
        client_stats = dict(stats)
    tel.record("client", **client_stats)
    tel.close()

    result = {
        "workload": args.workload,
        "serve_dir": serve_dir,
        "resumed": resumed,
        "live_version": registry.live.version,
        "live_digest": registry.live.digest,
        "probe_digest": final["probe"],
        "client": client_stats,
        "compiles_after_precompile": compiles,
        "deploys": [{k: e.get(k) for k in ("version", "stage", "verdict",
                                           "reason")}
                    for e in ctl.events],
        "versions": registry.describe(),
    }
    tmp = os.path.join(args.out, "result.json.tmp")
    with open(tmp, "w") as f:
        json.dump(result, f, indent=1)
    os.replace(tmp, os.path.join(args.out, "result.json"))
    print(json.dumps(result))
    # healthy only if no client request failed and serving built no step
    # after precompile()
    return 0 if client_stats["failed"] == 0 and compiles == 0 else 3


def main(argv=None):
    args = build_args(argv)
    if args.role == "trainer":
        return run_trainer(args)
    # SIGTERM unwinds the driver, so its trainer child is stopped
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    return run_driver(args)


if __name__ == "__main__":
    sys.exit(main())
