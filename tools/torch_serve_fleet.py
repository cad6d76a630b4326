#!/usr/bin/env python3
"""The fleet chaos drill of the PyTorch port: N serving replicas under
closed-loop client load survive a SIGKILL and a rolling deploy with zero
failed requests (the port's copy of ``tools/serve_fleet.py``).

The driver process runs replica 0 in process (the staged-exposure
engine) and ``--replicas`` - 1 subprocess workers (``--role worker``
runs of this script, each a fresh interpreter started by
``subprocess.Popen``, speaking the binary wire of
``bigdl_tpu_torch/serving/transport.py``), all behind one
``ServingFleet`` with a ``FleetSupervisor``.  A trainer child
(``tools/torch_serve_live.py --role trainer``) writes snapshots; the
``RolloutController`` walks each through shadow -> canary on replica 0,
then a rolling cutover across the fleet -- drain one replica, gate it,
commit, undrain, next -- while the clients keep calling
``fleet.predict``.

    # 2 replicas on the CPU, kill replica 1 after 20 completed requests
    # (and a promoted snapshot)
    python -m tools.torch_serve_fleet --device cpu --out /tmp/f \\
        --replicas 2 --chaos kill:replica:1@20

    # a per-replica gate that fails on replica 1: the touched replicas
    # roll back, the untouched never left the old version
    python -m tools.torch_serve_fleet --device cpu --out /tmp/g \\
        --failGate 1

Without ``--device`` every process runs on the CUDA card and raises where
there is none.  ``result.json`` holds what the JAX drill writes: client
``ok`` / ``failed`` / ``shed``, the fleet's counters, the supervisor's
restarts, the live version, and the probe digests of the driver's engine
and of every worker (a restarted worker boots from the registry's
committed version, so its digest must match).  The exit code is 0 only
when no client request failed, serving built no step after
``precompile()``, every worker's digest matched and, under ``--chaos``,
the killed replica came back on the committed version.  ``--metricsPort``
and ``--traceSample`` need ROADMAP A8, the movielens workload A9; all are
refused.

Artifacts under ``--out``: ``ckpt/``, ``registry.json``,
``serve*/events.jsonl`` (the deploy and fleet events), ``replica_<i>.log``
and ``.port``, ``trainer.log``, ``result.json``.
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
if REPO not in sys.path:                      # --role worker re-invocation
    sys.path.insert(0, REPO)

#: seconds a worker may take from spawn to its port file
BOOT_TIMEOUT_S = 180.0


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
    ap.add_argument("--replicas", type=int, default=3,
                    help="fleet size: replica 0 in process, the rest "
                         "subprocess workers")
    ap.add_argument("--steps", type=int, default=12,
                    help="trainer steps (a snapshot every --ckptEvery)")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--datasetSize", type=int, default=256)
    ap.add_argument("--ckptEvery", type=int, default=6)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--maxBatch", type=int, default=8)
    ap.add_argument("--maxWaitMs", type=float, default=1.0)
    ap.add_argument("--kvCacheDtype", choices=("fp32", "int8"),
                    default="fp32",
                    help="paged KV block storage dtype on every replica")
    ap.add_argument("--speculative", type=int, default=0,
                    help="draft tokens per verify step (0 disables)")
    ap.add_argument("--clients", type=int, default=3,
                    help="closed-loop client threads")
    ap.add_argument("--hedge", action="store_true",
                    help="enable tail-latency hedging")
    ap.add_argument("--shadowRows", type=int, default=16)
    ap.add_argument("--canaryTicks", type=int, default=4)
    ap.add_argument("--maxLogitRmse", type=float, default=100.0)
    ap.add_argument("--stageTimeout", type=float, default=60.0)
    ap.add_argument("--drainTimeout", type=float, default=10.0)
    ap.add_argument("--chaos", default=None,
                    help="fleet fault injection: kill:replica:<i>@<tick> "
                         "(SIGKILL worker i once <tick> client requests "
                         "completed AND a version was promoted)")
    ap.add_argument("--failGate", type=int, default=None,
                    help="a per-replica deploy gate that fails on this "
                         "replica id (the rolling-rollback leg)")
    ap.add_argument("--noTrainer", action="store_true")
    ap.add_argument("--idleRounds", type=int, default=10,
                    help="stop after this many quiet poll rounds once the "
                         "trainer exited and chaos resolved")
    ap.add_argument("--maxSeconds", type=float, default=420.0,
                    help="wall deadline of the whole drill: a rejoin that "
                         "never happens fails the drill, not hangs it")
    ap.add_argument("--metricsPort", type=int, default=None,
                    help="/metrics + /healthz (refused: ROADMAP A8)")
    ap.add_argument("--traceSample", type=float, default=None,
                    help="request-trace head sampling (refused: ROADMAP "
                         "A8)")
    ap.add_argument("--transport", choices=("binary", "pickle"),
                    default="binary",
                    help="the fleet's wire: the binary frame protocol or "
                         "the pickle wire")
    ap.add_argument("--weightWire", choices=("fp32", "int8"),
                    default="fp32",
                    help="weight encoding of rolling deploys (int8: "
                         "blockwise-quantized staging traffic, binary "
                         "transport only)")
    # internal spellings: this script spawning itself
    ap.add_argument("--role", choices=("driver", "worker"),
                    default="driver", help=argparse.SUPPRESS)
    ap.add_argument("--replicaId", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--portFile", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--registry", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def exit_with_parent():
    """A worker's guard: exit once the process that spawned it is gone
    (a driver killed outright leaves no worker behind)."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(0)

    threading.Thread(target=watch, name="parent-watch", daemon=True).start()


def write_port_file(path, port):
    """Atomic: a half-written port file is never readable."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(port))
    os.replace(tmp, path)


# --------------------------------------------------------------------------- #
# Worker role: one engine behind the socket protocol.
# --------------------------------------------------------------------------- #


def run_worker(args):
    import torch

    from tools.torch_serve_live import build_workload

    from bigdl_tpu_torch.serving import ServingEngine
    from bigdl_tpu_torch.serving.worker import (ReplicaServer,
                                                boot_from_registry)

    torch.set_num_threads(1)
    exit_with_parent()
    model, x, y, crit = build_workload(args)   # the seed: the driver's
    #                                            tree and boot weights
    eng = ServingEngine(model, max_batch_size=args.maxBatch,
                        max_wait_ms=args.maxWaitMs,
                        kv_cache_dtype=args.kvCacheDtype,
                        speculative=args.speculative, device=args.device)
    eng.precompile(example_feature=x[0])
    booted = boot_from_registry(eng, args.registry)
    srv = ReplicaServer(eng, port=0, probe_features=x[:4],
                        probe_bucket=min(4, args.maxBatch),
                        transport=args.transport)
    if args.portFile:
        write_port_file(args.portFile, srv.port)
    print(f"[worker {args.replicaId}] serving on port {srv.port}"
          + (f", booted v{booted[0]}" if booted else ", boot weights"),
          file=sys.stderr)
    sys.stderr.flush()
    srv.serve_forever()
    return 0


# --------------------------------------------------------------------------- #
# Driver role: fleet + supervisor + rollout + clients + chaos.
# --------------------------------------------------------------------------- #


def wait_port_file(proc, port_file, what, log_name,
                   timeout=BOOT_TIMEOUT_S):
    """Block until ``proc`` writes its port file; raise if it dies first
    or ``timeout`` passes (the child is killed then)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(
                f"{what} died during boot (rc={proc.poll()}, see "
                f"{log_name})")
        if os.path.exists(port_file):
            with open(port_file) as f:
                port = f.read().strip()
            if port:
                return int(port)
        time.sleep(0.1)
    proc.kill()
    proc.wait(30)
    raise RuntimeError(f"{what} boot timed out after {timeout}s")


def make_spawn(args, rid):
    """-> ``spawn(attempt) -> (Popen, port)`` for worker ``rid``: a fresh
    interpreter running this script's worker role, its output appended to
    ``replica_<rid>.log``, blocking until the worker's atomic port file
    appears (written after its engine is precompiled and its server
    listens, so a returned worker is ready to serve)."""
    from tools.torch_serve_live import child_env

    port_file = os.path.join(args.out, f"replica_{rid}.port")

    def spawn(attempt):
        if os.path.exists(port_file):
            os.remove(port_file)
        cmd = [sys.executable, os.path.abspath(__file__),
               "--role", "worker", "--out", args.out,
               "--workload", args.workload, "--seed", str(args.seed),
               "--datasetSize", str(args.datasetSize),
               "--maxBatch", str(args.maxBatch),
               "--maxWaitMs", str(args.maxWaitMs),
               "--replicaId", str(rid), "--portFile", port_file,
               "--kvCacheDtype", args.kvCacheDtype,
               "--speculative", str(args.speculative),
               "--transport", args.transport,
               "--registry", os.path.join(args.out, "registry.json")]
        if args.device is not None:
            cmd += ["--device", str(args.device)]
        log_name = f"replica_{rid}.log"
        with open(os.path.join(args.out, log_name), "a") as logf:
            logf.write(f"--- spawn attempt {attempt} ---\n")
            logf.flush()
            proc = subprocess.Popen(cmd, env=child_env(), stdout=logf,
                                    stderr=subprocess.STDOUT, cwd=REPO)
        return proc, wait_port_file(proc, port_file, f"worker {rid}",
                                    log_name)

    return spawn


def run_driver(args):
    import numpy as np

    from tools.torch_serve_live import (EventLog, build_workload,
                                        serve_dir_of, start_trainer,
                                        stop_child)

    from bigdl_tpu_torch.serving import (FleetOverloadedError,
                                         FleetSupervisor, InProcessReplica,
                                         ModelRegistry, RolloutController,
                                         ServingEngine, ServingFleet,
                                         SubprocessReplica)
    from bigdl_tpu_torch.serving.deploy import parse_fleet_chaos
    from bigdl_tpu_torch.serving.worker import probe_digest
    from bigdl_tpu_torch.utils.errors import ConfigurationError

    os.makedirs(args.out, exist_ok=True)
    if args.transport == "binary" and "BIGDL_RUN_TOKEN" not in os.environ:
        # the shared handshake secret, minted before any worker spawns:
        # every worker (and every respawn) inherits it through its env
        from bigdl_tpu_torch.serving.transport import mint_run_token

        os.environ["BIGDL_RUN_TOKEN"] = mint_run_token()
    chaos = parse_fleet_chaos(args.chaos)      # fail fast on a typo
    if chaos is not None and not 1 <= chaos[1] < args.replicas:
        raise ConfigurationError(
            f"chaos target replica {chaos[1]} must be a subprocess "
            f"worker id in [1, {args.replicas - 1}] (replica 0 is the "
            f"driver's in-process exposure replica)")
    model, x, y, crit = build_workload(args)
    serve_dir = serve_dir_of(args.out)
    tel = EventLog(serve_dir)

    eng0 = ServingEngine(model, max_batch_size=args.maxBatch,
                         max_wait_ms=args.maxWaitMs, telemetry=tel,
                         kv_cache_dtype=args.kvCacheDtype,
                         speculative=args.speculative, device=args.device)
    eng0.precompile(example_feature=x[0])
    execs0 = eng0._executables()
    probe_rows = x[:4]
    probe_bucket = min(4, args.maxBatch)

    replicas = [InProcessReplica(eng0, rid=0)]
    trainer = supervisor = fleet = None
    try:
        for rid in range(1, args.replicas):
            rep = SubprocessReplica(make_spawn(args, rid), rid=rid,
                                    transport=args.transport)
            replicas.append(rep)
            rep.start(0)
        fleet = ServingFleet(replicas, telemetry=tel, hedge=args.hedge,
                             probe_features=probe_rows,
                             probe_bucket=probe_bucket,
                             breaker_reset_s=1.0, retry_backoff_s=0.02,
                             weight_wire=args.weightWire)
        supervisor = FleetSupervisor(fleet, max_restarts=3,
                                     backoff_base_s=0.3, backoff_max_s=5.0,
                                     jitter=0.25).start()
        registry = ModelRegistry(os.path.join(args.out, "registry.json"))
        replica_gate = None
        if args.failGate is not None:
            def replica_gate(rid, flt, handle, _bad=int(args.failGate)):
                if rid == _bad:
                    return False, "injected failing per-replica gate"
                return flt.gate_replica(rid, handle)
        ctl = RolloutController(
            fleet, registry, os.path.join(args.out, "ckpt"), telemetry=tel,
            shadow_fraction=0.5, shadow_min_rows=args.shadowRows,
            min_top1_agreement=None, max_logit_rmse=args.maxLogitRmse,
            canary_fraction=0.25, canary_min_ticks=args.canaryTicks,
            stage_timeout_s=args.stageTimeout,
            drain_timeout_s=args.drainTimeout, replica_gate=replica_gate)
        resumed = registry.live is not None
        if resumed:
            ctl.resume()
        else:
            ctl.baseline()

        stop = threading.Event()
        stats = {"ok": 0, "failed": 0, "shed": 0}
        stats_lock = threading.Lock()

        def client(seed):
            idx = np.random.default_rng(seed)
            while not stop.is_set():
                try:
                    fleet.predict(x[int(idx.integers(0, len(x)))],
                                  timeout=30.0)
                    with stats_lock:
                        stats["ok"] += 1
                except FleetOverloadedError:
                    with stats_lock:
                        stats["shed"] += 1
                    time.sleep(0.01)
                except Exception as e:
                    if stop.is_set():
                        return
                    with stats_lock:
                        stats["failed"] += 1
                    print(f"[torch_serve_fleet] CLIENT FAILURE: {e}",
                          file=sys.stderr)

        clients = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(args.clients)]
        for t in clients:
            t.start()
        trainer = None if args.noTrainer else start_trainer(args)

        chaos_record = None
        rejoined = None
        idle = 0
        t_start = time.time()
        try:
            while True:
                v = ctl.poll_once()
                ctl.check_watch()
                with stats_lock:
                    done_reqs = stats["ok"]
                    tel.record("client", **stats)
                # chaos: SIGKILL the worker once enough requests completed
                # and a snapshot version was promoted (so its restart boots
                # the registry's committed version, not boot weights)
                if chaos is not None and chaos_record is None \
                        and done_reqs >= chaos[2] \
                        and registry.live.path is not None:
                    _, rid, _ = chaos
                    rep = fleet._by_id(rid)
                    if rep.kind != "subprocess" or rep.proc is None:
                        raise RuntimeError(f"chaos target replica {rid} is not "
                                           f"a subprocess worker")
                    chaos_record = {"replica": rid, "pid": rep.proc.pid,
                                    "at_requests": done_reqs,
                                    "live_version": registry.live.version}
                    print(f"[torch_serve_fleet] chaos: SIGKILL replica {rid} "
                          f"(pid {rep.proc.pid}) at {done_reqs} requests",
                          file=sys.stderr)
                    os.kill(rep.proc.pid, signal.SIGKILL)
                    with open(os.path.join(args.out, "chaos_fired.json"),
                              "w") as f:
                        json.dump(chaos_record, f)
                # after the kill: wait for the supervisor to bring the replica
                # back, then check it serves the committed version bit for bit
                if chaos_record is not None and rejoined is None:
                    rep = fleet._by_id(chaos_record["replica"])
                    if rep.state == "serving" and rep.alive() \
                            and rep.proc.pid != chaos_record["pid"]:
                        health = rep.health()
                        rejoined = {
                            "replica": rep.rid, "pid": rep.proc.pid,
                            "version": (health.get("version") or {}),
                            "expected_version": registry.live.version,
                            "probe": rep.probe(bucket=probe_bucket),
                            "driver_probe": probe_digest(eng0, probe_rows,
                                                         probe_bucket)}
                        print(f"[torch_serve_fleet] replica {rep.rid} "
                              f"rejoined: {rejoined}", file=sys.stderr)
                trainer_done = trainer is None or trainer.poll() is not None
                chaos_target_gone = chaos_record is not None and \
                    fleet._by_id(chaos_record["replica"]).state == "closed"
                chaos_done = chaos is None or rejoined is not None \
                    or chaos_target_gone
                idle = idle + 1 if (trainer_done and v is None
                                    and chaos_done) else 0
                if idle >= args.idleRounds:
                    break
                if time.time() - t_start > args.maxSeconds:
                    print("[torch_serve_fleet] drill wall deadline reached",
                          file=sys.stderr)
                    break
                time.sleep(0.1)
        finally:
            stop.set()
            for t in clients:
                t.join(5)
            stop_child(trainer)
            supervisor.close()

        worker_probes = {}
        for rep in fleet.replicas:
            if rep.kind == "subprocess" and rep.state == "serving":
                try:
                    worker_probes[rep.rid] = rep.probe(bucket=probe_bucket)
                except Exception as e:
                    worker_probes[rep.rid] = f"unreachable: {e}"
        driver_probe = probe_digest(eng0, probe_rows, probe_bucket)
        compiles = eng0._executables() - execs0
        counters = fleet.counters()
        states = {rid: {k: d[k] for k in ("kind", "state", "served", "failed",
                                          "breaker")}
                  for rid, d in fleet.replica_states().items()}
        with stats_lock:
            client_stats = dict(stats)
        tel.record("client", **client_stats)

        probes_ok = all(p == driver_probe for p in worker_probes.values())
        rejoin_ok = chaos is None or (
            rejoined is not None
            and rejoined["probe"] == rejoined["driver_probe"]
            and rejoined["version"].get("version")
            == rejoined["expected_version"])
        result = {
            "workload": args.workload,
            "serve_dir": serve_dir,
            "resumed": resumed,
            "replicas": args.replicas,
            "live_version": registry.live.version,
            "live_digest": registry.live.digest,
            "client": client_stats,
            "fleet": counters,
            "replica_states": states,
            "supervisor_restarts": supervisor.events,
            "chaos": chaos_record,
            "rejoined": rejoined,
            "driver_probe": driver_probe,
            "worker_probes": worker_probes,
            "probes_match": probes_ok,
            "compiles_after_precompile": compiles,
            "deploys": [{k: e.get(k) for k in ("version", "stage", "verdict",
                                               "reason", "replica")}
                        for e in ctl.events],
            "versions": registry.describe(),
        }
        tmp = os.path.join(args.out, "result.json.tmp")
        with open(tmp, "w") as f:
            json.dump(result, f, indent=1)
        os.replace(tmp, os.path.join(args.out, "result.json"))
        print(json.dumps(result))
        ok = (client_stats["failed"] == 0 and compiles == 0 and probes_ok
              and rejoin_ok)
        return 0 if ok else 3
    finally:
        stop_child(trainer)
        if supervisor is not None:
            supervisor.close()
        if fleet is not None:
            fleet.close()
        else:
            for rep in replicas:
                rep.close()
        tel.close()


def main(argv=None):
    args = build_args(argv)
    from tools.torch_serve_live import refuse_unported

    refuse_unported(args)
    if args.role == "worker":
        return run_worker(args)
    # SIGTERM unwinds the driver, so its workers and trainer are stopped
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    return run_driver(args)


if __name__ == "__main__":
    sys.exit(main())
