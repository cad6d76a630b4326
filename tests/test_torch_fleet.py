"""The port's serving fleet (``bigdl_tpu_torch/serving/fleet.py``) against
the JAX package's (``bigdl_tpu/serving/fleet.py``) on the CPU, and the
port's fleet drill (``tools/torch_serve_fleet.py``).

Held against JAX: ``CircuitBreaker`` makes the same transitions, states
and admissions for the same scripted outcomes on an injected clock; with
stub replicas (scripted futures, no engine) the two fleets decide the
same for retries, an all-failing fleet, admission shedding, hedging and
drain refusals: the same result or exception type, counters and
per-replica served / failed / breaker state.  The port alone:
``FleetSupervisor`` restarts one real CPU worker (a fresh interpreter of
the drill's worker role) that rejoins with the in-process replica's
probe digest; the small drill (2 replicas, a SIGKILL, 2 clients) ends
with zero failed requests and the killed replica back on the committed
version with an equal digest; no module of the port, neither new tool
and not ``chip_smoke.py`` imports ``jax`` or ``bigdl_tpu``.

The full 3-replica drills are marked ``slow``, as the JAX package's are.
Every child is a fresh interpreter with ``OMP_NUM_THREADS=1`` and its
output in ``tmp_path``, killed and waited for with a timeout; every
listener binds ``127.0.0.1:0``.
"""

import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from bigdl_tpu.serving import fleet as jf
from bigdl_tpu.serving import transport as jt
from bigdl_tpu_torch.serving import fleet as tf
from bigdl_tpu_torch.serving import transport as tt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (jf, jt), "torch": (tf, tt)}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- #
# Circuit breaker.
# --------------------------------------------------------------------------- #

BREAKER_SCRIPTS = {
    "opens_on_consecutive_failures_only": (
        {"failure_threshold": 3},
        ["fail", "fail", "ok", "fail", "fail", "acq", "fail", "acq"]),
    "half_open_probe_recovers": (
        {"failure_threshold": 2, "reset_timeout_s": 1.0},
        ["fail", "fail", "acq", "t0.5", "acq", "t0.6", "acq", "acq", "ok",
         "acq"]),
    "half_open_probe_failure_reopens": (
        {"failure_threshold": 1, "reset_timeout_s": 1.0},
        ["fail", "t1.0", "acq", "fail", "acq", "t1.0", "acq", "ok"]),
    "cancel_releases_a_probe": (
        {"failure_threshold": 1, "reset_timeout_s": 1.0,
         "half_open_max_probes": 1},
        ["fail", "t2", "acq", "acq", "cancel", "acq", "cancel", "acq"]),
    "force_open_and_reset": (
        {}, ["acq", "force", "acq", "t10", "acq", "reset", "acq", "fail"]),
    "two_probes": (
        {"failure_threshold": 2, "reset_timeout_s": 0.5,
         "half_open_max_probes": 2},
        ["fail", "fail", "t0.5", "acq", "acq", "acq", "fail", "acq",
         "t0.5", "acq", "ok", "acq"]),
}


def _run_breaker(mod, kw, script):
    t = {"now": 0.0}
    edges = []
    br = mod.CircuitBreaker(clock=lambda: t["now"],
                            on_transition=lambda a, b: edges.append((a, b)),
                            **kw)
    trail = []
    for op in script:
        if op.startswith("t"):
            t["now"] += float(op[1:])
            out = None
        elif op == "acq":
            out = br.acquire()
        else:
            out = getattr(br, {"ok": "record_success",
                               "fail": "record_failure",
                               "cancel": "record_cancel",
                               "force": "force_open",
                               "reset": "reset"}[op])()
        trail.append((op, out, br.state))
    return trail, edges


@pytest.mark.parametrize("name", sorted(BREAKER_SCRIPTS))
def test_breaker_transitions_match_jax(name):
    kw, script = BREAKER_SCRIPTS[name]
    assert _run_breaker(tf, kw, script) == _run_breaker(jf, kw, script)
    with pytest.raises(ValueError, match="failure_threshold"):
        tf.CircuitBreaker(failure_threshold=0)


# --------------------------------------------------------------------------- #
# Routing decisions with stub replicas.
# --------------------------------------------------------------------------- #


def _stub_class(mod, wire):
    class Stub(mod.Replica):
        """A replica whose ``submit`` runs a scripted behaviour: ``ok``
        (resolved at once), ``fail`` (a failed future), ``drain`` (a
        typed ``EngineDraining`` refusal from the worker), ``slow``
        (resolved after ``delay``), ``block`` (resolved when ``release``
        is set)."""

        kind = "in_process"

        def __init__(self, behaviour, rid=None, delay=1.0, release=None):
            super().__init__(rid)
            self.behaviour = behaviour
            self.delay = delay
            self.release = release
            self.timers = []

        def submit(self, feature, timeout=None, admit_timeout=None):
            fut = Future()
            b = self.behaviour
            if b == "ok":
                fut.set_result(("served by", self.rid, feature))
            elif b == "fail":
                fut.set_exception(RuntimeError("poisoned replica"))
            elif b == "drain":
                raise wire.ReplicaCallError("draining",
                                            error_type="EngineDraining")
            elif b in ("slow", "block"):
                def later():
                    if b == "block":
                        self.release.wait(10.0)
                    else:
                        time.sleep(self.delay)
                    if not fut.done():
                        fut.set_result(("served by", self.rid, feature))
                th = threading.Thread(target=later, daemon=True)
                th.start()
                self.timers.append(th)
            return fut

        def abandon(self, fut):
            fut.cancel()

        def alive(self):
            return True

        def close(self):
            for th in self.timers:
                th.join(10.0)

    return Stub


def _decide(pkg, case):
    mod, wire = PKGS[pkg]
    Stub = _stub_class(mod, wire)
    kw = dict(retry_backoff_s=0.001, retry_backoff_max_s=0.002,
              rng=random.Random(0), sleep=lambda s: None,
              breaker_reset_s=60.0)
    release = threading.Event()
    if case == "retries":
        reps = [Stub("fail"), Stub("ok"), Stub("ok")]
        n = 6
    elif case == "all_fail":
        reps = [Stub("fail"), Stub("fail")]
        kw["retry_limit"] = 2
        n = 1
    elif case == "drain_refusal":
        reps = [Stub("drain"), Stub("ok")]
        kw["breaker_failures"] = 1
        n = 6
    elif case == "hedge":
        reps = [Stub("slow", delay=0.6), Stub("ok")]
        kw.update(hedge=True, hedge_min_delay_s=0.03, hedge_min_samples=5)
        n = 1
    elif case == "shed":
        reps = [Stub("block", release=release), Stub("block",
                                                     release=release)]
        kw["admission_limit"] = 1
        n = 1
    fleet = mod.ServingFleet(reps, **kw)
    outcomes = []
    background = None
    try:
        if case == "hedge":
            for _ in range(10):
                fleet._note_latency(0.005)
        if case == "shed":
            background = threading.Thread(
                target=lambda: outcomes.append(
                    ("bg", fleet.predict("held", timeout=10.0)[1])),
                daemon=True)
            background.start()
            deadline = time.monotonic() + 5.0
            while fleet._inflight_total < 1:
                assert time.monotonic() < deadline
                time.sleep(0.005)
        for i in range(n):
            t0 = time.perf_counter()
            try:
                y = fleet.predict(f"x{i}", timeout=10.0)
                outcomes.append(("ok", y[1]))
            except Exception as e:
                outcomes.append((type(e).__name__,
                                 "fast" if time.perf_counter() - t0 < 0.5
                                 else "slow"))
        release.set()
        if background is not None:
            background.join(10.0)
        states = {r.rid: (r.state, r.served, r.failed, r.breaker.state)
                  for r in fleet.replicas}
        return outcomes, fleet.counters(), states
    finally:
        release.set()
        fleet.close()


@pytest.mark.parametrize("case", ["retries", "all_fail", "drain_refusal",
                                  "hedge", "shed"])
def test_routing_decides_as_jax_does(case):
    got = _decide("torch", case)
    want = _decide("jax", case)
    assert got == want
    outcomes, counters, states = got
    if case == "retries":
        assert counters["ok"] == 6 and counters["retries"] >= 1
        assert states[0][3] == "open"
    elif case == "all_fail":
        assert outcomes == [("FleetUnavailableError", "fast")]
    elif case == "drain_refusal":
        assert states[0] == ("serving", 0, 0, "closed")
    elif case == "hedge":
        assert outcomes == [("ok", 1)]
        assert counters["hedges"] == 1 and counters["hedge_wins"] == 1
    elif case == "shed":
        assert ("FleetOverloadedError", "fast") in outcomes
        assert counters["shed"] == 1


def test_fleet_refuses_a8_arguments_and_validates():
    with pytest.raises(ValueError, match="at least one replica"):
        tf.ServingFleet([])
    Stub = _stub_class(tf, tt)
    with pytest.raises(ValueError, match="admission_limit"):
        tf.ServingFleet([Stub("ok")], admission_limit=0)
    for kw in ({"metrics": object()}, {"trace_sample": 0.5}):
        with pytest.raises(NotImplementedError, match="A8"):
            tf.ServingFleet([Stub("ok")], **kw)


# --------------------------------------------------------------------------- #
# Real worker processes.
# --------------------------------------------------------------------------- #


def _drill_args(out, *extra):
    from tools.torch_serve_fleet import build_args

    return build_args(["--device", "cpu", "--out", str(out), *extra])


def test_supervisor_restarts_a_cpu_worker(tmp_path):
    """One worker (the drill's worker role, a fresh interpreter) is
    SIGKILLed; ``FleetSupervisor.check`` on an injected clock marks it
    dead, restarts it after its backoff, and it rejoins serving the same
    digest as the in-process replica."""
    from tools.torch_serve_fleet import make_spawn
    from tools.torch_serve_live import build_workload

    from bigdl_tpu_torch.serving import ServingEngine
    from bigdl_tpu_torch.serving.worker import probe_digest

    args = _drill_args(tmp_path, "--maxBatch", "4")
    model, x, _, _ = build_workload(args)
    eng = ServingEngine(model, max_batch_size=4, max_wait_ms=1.0,
                        device="cpu")
    eng.precompile(example_feature=x[0])
    worker = tf.SubprocessReplica(make_spawn(args, 1), rid=1,
                                  request_timeout_s=20.0)
    fleet = None
    try:
        worker.start(0)
        fleet = tf.ServingFleet([tf.InProcessReplica(eng, rid=0), worker],
                                retry_backoff_s=0.01)
        t = {"now": 0.0}
        sup = tf.FleetSupervisor(fleet, clock=lambda: t["now"],
                                 backoff_base_s=1.0, jitter=0.0)
        want = probe_digest(eng, x[:4], 4)
        assert worker.probe(features=x[:4], bucket=4) == want
        pid = worker.proc.pid
        os.kill(pid, signal.SIGKILL)
        worker.proc.wait(10)
        assert sup.check() == []
        assert worker.state == "dead" and worker.breaker.state == "open"
        for i in range(4):                  # the survivor serves
            fleet.predict(x[i], timeout=20.0)
        t["now"] = 1.1
        assert sup.check() == [1]
        assert worker.state == "serving" and worker.proc.pid != pid
        assert sup.events[0]["cause"] == "process_death"
        assert worker.probe(features=x[:4], bucket=4) == want
        np.testing.assert_array_equal(
            worker._call("predict", feature=x[5], timeout=20.0),
            eng.predict_at(x[5], 1))
        h = worker.health()
        assert h["pid"] == worker.proc.pid
    finally:
        if fleet is not None:
            fleet.close()
        else:
            worker.close()
            eng.close()
        if worker.proc is not None and worker.proc.poll() is None:
            worker.proc.kill()
            worker.proc.wait(10)


def test_int8_weight_wire_serves_one_weight_set(tmp_path):
    """A candidate staged across a fleet on its int8 weight wire: the
    worker gets the blockwise int8 payload (a quarter of the fp32 bytes),
    the in-process replica stages the tree as the wire delivers it, and
    after the commit both serve the same digest, that of an engine given
    the quantized-then-dequantized tree directly.  The wire is the
    fleet's one setting."""
    from tools.torch_serve_fleet import make_spawn
    from tools.torch_serve_live import build_workload

    from bigdl_tpu_torch.serving import ServingEngine
    from bigdl_tpu_torch.serving.worker import probe_digest

    args = _drill_args(tmp_path, "--maxBatch", "4")
    model, x, _, _ = build_workload(args)
    eng = ServingEngine(model, max_batch_size=4, max_wait_ms=1.0,
                        device="cpu")
    eng.precompile(example_feature=x[0])
    worker = tf.SubprocessReplica(make_spawn(args, 1), rid=1,
                                  request_timeout_s=20.0)
    fleet = ref = None
    try:
        with pytest.raises(ValueError, match="weight_wire"):
            tf.ServingFleet([tf.InProcessReplica(eng, rid=0)],
                            weight_wire="int4")
        worker.start(0)
        fleet = tf.ServingFleet([tf.InProcessReplica(eng, rid=0), worker],
                                probe_features=x[:4], probe_bucket=4,
                                weight_wire="int8")
        cand = build_workload(_drill_args(tmp_path, "--seed", "1"))[0] \
            .parameters_tree()
        handle = fleet.stage_weights(params=cand)
        assert set(handle["per_replica"]) == {0, 1}
        assert fleet.gate_replica(1, handle) == (True, None)
        fleet.commit_staged(handle, version=2)
        # the drill model's leaves under 1024 elements ship raw
        sent = fleet.wire_stats()["stage_tree"]["bytes_sent"]
        assert sent < tt.tree_wire_bytes(cand) / 2
        ref_model = build_workload(args)[0]
        ref = ServingEngine(ref_model, max_batch_size=4, device="cpu")
        ref.refresh_params(tt.dequantize_wire_tree(
            tt.quantize_tree_for_wire(cand)))
        want = probe_digest(ref, x[:4], 4)
        assert probe_digest(eng, x[:4], 4) == want
        assert worker.probe(features=x[:4], bucket=4) == want
        assert worker.health()["version"]["version"] == 2
    finally:
        if ref is not None:
            ref.close()
        if fleet is not None:
            fleet.close()
        else:
            worker.close()
            eng.close()
        if worker.proc is not None and worker.proc.poll() is None:
            worker.proc.kill()
            worker.proc.wait(10)


def _run_drill(tmp_path, name, extra, timeout):
    """The drill as a child process, its output in files; terminated
    (then killed) if it outlives ``timeout``."""
    out = tmp_path / name
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.pop("BIGDL_RUN_TOKEN", None)
    with open(tmp_path / f"{name}.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tools.torch_serve_fleet", "--device",
             "cpu", "--out", str(out), "--clients", "2", "--steps", "6",
             "--ckptEvery", "6", "--shadowRows", "8", "--canaryTicks", "2",
             "--idleRounds", "5", *extra],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(30)
    text = (tmp_path / f"{name}.log").read_text()
    assert rc == 0, text[-4000:]
    with open(out / "result.json") as f:
        return json.load(f), out


def _held_drill(result, out, replicas):
    assert result["client"]["failed"] == 0 and result["client"]["ok"] > 0
    assert result["compiles_after_precompile"] == 0
    assert result["chaos"]["replica"] == 1
    assert result["rejoined"]["probe"] == result["rejoined"]["driver_probe"]
    assert result["rejoined"]["version"]["version"] \
        == result["live_version"] >= 2
    assert result["probes_match"] is True
    assert len(result["worker_probes"]) == replicas - 1
    assert len(result["supervisor_restarts"]) >= 1
    evs = [json.loads(line)
           for line in open(os.path.join(result["serve_dir"],
                                         "events.jsonl"))]
    fleet = [e for e in evs if e["kind"] == "fleet"]
    assert any(e.get("event") == "state" and e.get("state") == "dead"
               and e.get("replica") == 1 for e in fleet)
    assert any(e.get("event") == "restart" and e.get("replica") == 1
               for e in fleet)


@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_small_drill_survives_a_sigkill(tmp_path, wire):
    """2 replicas, 2 clients, worker 1 SIGKILLed after 20 requests and a
    promoted snapshot: zero failed requests, the supervisor restarts it,
    and it rejoins on the committed version with an equal digest.  On
    the int8 weight wire the restarted worker boots the snapshot as the
    wire delivered it to the fleet, which the registry records."""
    result, out = _run_drill(tmp_path, "drill",
                             ["--replicas", "2", "--chaos",
                              "kill:replica:1@20", "--maxSeconds", "240",
                              "--weightWire", wire], timeout=300)
    _held_drill(result, out, 2)
    with open(out / "registry.json") as f:
        live = [v for v in json.load(f)["versions"]
                if v["version"] == result["live_version"]]
    assert live[0].get("weight_wire") == (None if wire == "fp32" else wire)


@pytest.mark.slow
def test_three_replica_drill_rejoins_committed_version(tmp_path):
    result, out = _run_drill(tmp_path, "drill3",
                             ["--replicas", "3", "--chaos",
                              "kill:replica:1@40", "--steps", "12"],
                             timeout=560)
    _held_drill(result, out, 3)


@pytest.mark.slow
def test_failing_gate_rolls_back_only_touched_replicas(tmp_path):
    result, out = _run_drill(tmp_path, "gate",
                             ["--replicas", "3", "--failGate", "1",
                              "--weightWire", "int8"], timeout=560)
    assert result["client"]["failed"] == 0
    assert result["probes_match"] is True
    assert result["live_version"] == 1
    cuts = {d["replica"]: d["verdict"] for d in result["deploys"]
            if d["stage"] == "cutover"}
    assert cuts[0] == "ok" and cuts[1] == "rejected" and 2 not in cuts
    assert any(d["stage"] == "rollback" for d in result["deploys"])


_BLOCKER = (
    "import importlib, importlib.abc, sys\n"
    "class Block(importlib.abc.MetaPathFinder):\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        top = name.split('.')[0]\n"
    "        if top in ('jax', 'jaxlib', 'bigdl_tpu'):\n"
    "            raise ImportError('blocked: ' + name)\n"
    "        return None\n"
    "sys.meta_path.insert(0, Block())\n"
    "for m in sys.argv[1:]:\n"
    "    importlib.import_module(m)\n"
    "bad = sorted(k for k in sys.modules\n"
    "             if k.split('.')[0] in ('jax', 'jaxlib', 'bigdl_tpu'))\n"
    "assert not bad, bad\n"
    "print('clean', len(sys.argv) - 1)\n")


def test_fleet_modules_import_without_jax(tmp_path):
    mods = ["bigdl_tpu_torch.observability.profiling",
            "bigdl_tpu_torch.serving", "bigdl_tpu_torch.serving.transport",
            "bigdl_tpu_torch.serving.worker",
            "bigdl_tpu_torch.serving.deploy",
            "bigdl_tpu_torch.serving.fleet", "tools.torch_serve_live",
            "tools.torch_serve_fleet", "chip_smoke"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    with open(tmp_path / "imports.log", "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", _BLOCKER, *mods],
                                cwd=REPO, env=env, stdout=log,
                                stderr=subprocess.STDOUT)
    try:
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    text = (tmp_path / "imports.log").read_text()
    assert rc == 0 and f"clean {len(mods)}" in text, text[-3000:]
