"""Fleet-grade serving (the port's copy of ``bigdl_tpu/serving/
fleet.py``): a replicated engine pool with health-aware routing,
per-replica circuit breakers, deadline-budgeted retries, tail-latency
hedging, load shedding and graceful drains.

- ``ServingFleet`` -- the front end.  ``predict()`` routes by least load
  over the replicas whose lifecycle state is ``serving`` and whose
  ``CircuitBreaker`` admits traffic (closed -> open after
  ``breaker_failures`` consecutive failures, a half-open probe after
  ``breaker_reset_s``, closed again on a probe success).  A failed
  attempt retries on another replica under capped exponential backoff
  with jitter (``optim.recovery.capped_backoff``), all inside one request
  deadline.  Hedging re-issues a still-pending request to a second
  replica after a p99-derived delay (first result wins).  Past
  ``admission_limit`` requests in flight the fleet sheds with a fast
  ``FleetOverloadedError``.  ``generate()`` takes the same path without
  hedging.
- Replicas come in two kinds behind one verb set: ``InProcessReplica``
  (an engine in this process) and ``SubprocessReplica`` (a
  ``serving/worker.py`` process over the binary wire, so a crash is a
  process death).  Both take the rolling-deploy verbs ``drain`` /
  ``undrain`` / ``stage`` / ``gate`` / ``commit`` / ``release`` that
  ``serving/deploy.py``'s rollout drives replica by replica.
- ``FleetSupervisor`` -- restarts dead subprocess replicas under capped,
  jittered backoff and a restart budget; a restarted worker boots from
  the registry's committed version (``worker.boot_from_registry``).

Lifecycle and breaker edges are ``kind: "fleet"`` events on
``telemetry`` (any object with ``record(kind, **fields)``).  The metrics
registry and exporter (``metrics=``) and request tracing
(``trace_sample=``) wait for ROADMAP A8 and are refused.

No device work here: a supervisor-side router needs no card.
"""

import logging
import os
import threading
import time
from collections import deque

from bigdl_tpu_torch.observability.profiling import percentile
from bigdl_tpu_torch.optim.recovery import capped_backoff
from bigdl_tpu_torch.utils.errors import UnsupportedFeatureError

log = logging.getLogger("bigdl_tpu_torch.serving")

#: replica lifecycle states: starting -> serving <-> draining -> drained -> serving, any ->
#: dead -> (supervisor restart) -> serving, terminal: closed
REPLICA_STATES = ("starting", "serving", "draining", "drained", "dead",
                  "closed")

#: circuit breaker states
BREAKER_STATES = ("closed", "open", "half_open")


class FleetOverloadedError(RuntimeError):
    """Load shed: the fleet's bounded admission window is full.  The
    503 of this stack -- deliberately raised FAST (no queueing, no
    retries) so callers back off instead of stacking work the fleet
    can never drain."""


class FleetUnavailableError(RuntimeError):
    """The retry budget / request deadline ran out without any replica
    producing a result (all dead, draining, circuit-open, or every
    attempt failed)."""


class CircuitBreaker:
    """Per-replica failure gate: closed -> open after
    ``failure_threshold`` CONSECUTIVE failures, half-open probe after
    ``reset_timeout_s`` (at most ``half_open_max_probes`` concurrent
    probes), closed again on a probe success, straight back to open on
    a probe failure.  ``clock`` is injectable; ``on_transition(frm,
    to)`` fires OUTSIDE the breaker lock for every state edge (the
    fleet turns these into durable telemetry)."""

    def __init__(self, failure_threshold=3, reset_timeout_s=2.0,
                 half_open_max_probes=1, clock=time.monotonic,
                 on_transition=None):
        if int(failure_threshold) < 1:
            raise ValueError(f"failure_threshold must be >= 1, got "
                             f"{failure_threshold}")
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self.half_open_max_probes = int(half_open_max_probes)
        self.clock = clock
        self.on_transition = on_transition
        self._lock = threading.Lock()
        self.state = "closed"
        self._consecutive = 0
        self._opened_at = None
        self._probes = 0

    def _move(self, to, fired):
        if self.state != to:
            fired.append((self.state, to))
            self.state = to

    def _fire(self, fired):
        if self.on_transition is None:
            return
        for frm, to in fired:
            try:
                self.on_transition(frm, to)
            except Exception:
                log.exception("breaker transition callback failed")

    def acquire(self):
        """May a request be routed here right now?  A True answer in
        the half-open state RESERVES one probe slot -- every acquired
        attempt must end in exactly one ``record_success`` /
        ``record_failure`` / ``record_cancel``."""
        fired = []
        with self._lock:
            if self.state == "open":
                if self._opened_at is not None and \
                        self.clock() - self._opened_at \
                        >= self.reset_timeout_s:
                    self._move("half_open", fired)
                    self._probes = 0
                else:
                    self._fire(fired)
                    return False
            if self.state == "closed":
                ok = True
            else:                             # half_open: bounded probes
                ok = self._probes < self.half_open_max_probes
                if ok:
                    self._probes += 1
        self._fire(fired)
        return ok

    def record_success(self):
        fired = []
        with self._lock:
            self._consecutive = 0
            if self.state == "half_open":
                self._probes = max(0, self._probes - 1)
                self._move("closed", fired)
        self._fire(fired)

    def record_failure(self):
        fired = []
        with self._lock:
            self._consecutive += 1
            if self.state == "half_open":
                self._probes = max(0, self._probes - 1)
                self._move("open", fired)
                self._opened_at = self.clock()
            elif self.state == "closed" and \
                    self._consecutive >= self.failure_threshold:
                self._move("open", fired)
                self._opened_at = self.clock()
        self._fire(fired)

    def record_cancel(self):
        """An abandoned attempt (hedge loser, deadline): releases a
        half-open probe slot without judging the replica either way."""
        with self._lock:
            if self.state == "half_open":
                self._probes = max(0, self._probes - 1)

    def force_open(self):
        """The replica is KNOWN dead (supervisor observed the process
        exit): stop routing immediately, don't wait for three failed
        requests to find out."""
        fired = []
        with self._lock:
            self._move("open", fired)
            self._opened_at = self.clock()
        self._fire(fired)

    def reset(self):
        """A fresh process rejoined: back to closed with a clean
        failure count."""
        fired = []
        with self._lock:
            self._consecutive = 0
            self._probes = 0
            self._opened_at = None
            self._move("closed", fired)
        self._fire(fired)


# --------------------------------------------------------------------------- #
# Replicas: one verb set, two process models.
# --------------------------------------------------------------------------- #


class Replica:
    """Shared replica surface.  Routing: ``submit``/``abandon``/
    ``alive``.  Rolling-deploy verbs: ``drain``/``undrain``/``stage``/
    ``capture``/``gate``/``commit``/``release``/``set_version``.
    ``state``/``inflight``/``served``/``failed`` and the ``breaker``
    are owned by the fleet."""

    kind = "?"

    def __init__(self, rid=None):
        self.rid = rid
        self.state = "starting"
        self.inflight = 0
        self.served = 0
        self.failed = 0
        self.breaker = None            # attached at fleet registration

    def describe(self):
        return {"replica": self.rid, "kind": self.kind,
                "state": self.state, "inflight": self.inflight,
                "served": self.served, "failed": self.failed,
                "breaker": self.breaker.state if self.breaker else None}

    def memory_headroom(self):
        """This replica's ``ServingEngine.memory_headroom()`` capacity
        signal, or None where the replica kind cannot report one (a
        remote worker without the RPC)."""
        return None


class InProcessReplica(Replica):
    """A ``ServingEngine`` in this process -- the cheap replica kind
    (and the fleet's staged-exposure surface: shadow/canary run on the
    first in-process replica)."""

    kind = "in_process"

    def __init__(self, engine, rid=None):
        super().__init__(rid)
        self.engine = engine

    # -- routing -- #
    def submit(self, feature, timeout=None, admit_timeout=None):
        # admit_timeout bounds QUEUE ADMISSION only; the result wait is
        # the fleet's, bounded by the request deadline (timeout)
        t = admit_timeout if admit_timeout is not None else timeout
        return self.engine.submit(feature, timeout=t)

    def submit_generate(self, req, timeout=None, admit_timeout=None):
        # req: {"prompt", "max_new_tokens", "eos_id"} plus optional
        # sampling knobs; returns the engine's streaming GenerateFuture
        # (result() -> token list)
        t = admit_timeout if admit_timeout is not None else timeout
        return self.engine.generate(
            req["prompt"], max_new_tokens=req.get("max_new_tokens", 16),
            eos_id=req.get("eos_id"), timeout=t,
            temperature=req.get("temperature", 0.0),
            top_k=req.get("top_k", 0), top_p=req.get("top_p", 1.0),
            seed=req.get("seed"))

    def abandon(self, fut):
        if hasattr(fut, "_t_submit"):          # a ServeFuture: free its
            self.engine._abandon(fut)          # queue slot too
        else:
            fut.cancel()

    def alive(self):
        return self.engine._running

    def memory_headroom(self):
        return self.engine.memory_headroom()

    # -- deploy verbs -- #
    def drain(self, timeout=None):
        return self.engine.drain(timeout=timeout)

    def undrain(self):
        self.engine.undrain()

    def capture(self):
        return self.engine.capture_staged()

    def stage(self, params=None, mstate=None, src_layout=None, path=None,
              wire_tree=None):
        # wire_tree is what a worker is sent; params here is already the
        # tree as the wire delivers it (ServingFleet.stage_weights)
        if params is None:
            if path is None:
                raise ValueError("stage needs params= or a snapshot path=")
            # the snapshot under its own layout, staged with it (JAX
            # fleet.py:296-308)
            p = self.engine._resolve_snapshot(path)
            params, mstate, src_layout = self.engine._read_snapshot(p)
        return self.engine.stage_weights(params, mstate,
                                         src_layout=src_layout)

    def gate(self, handle, probe_features, probe_bucket=None):
        """Per-replica deploy gate: the staged candidate's outputs on
        the probe batch must be finite (the cheap invariant a damaged
        staging always breaks); no probe configured passes trivially.
        THE one implementation (``worker.gate_staged``) -- the worker's
        ``gate`` op runs the same code, so the two replica kinds can
        never disagree about a candidate."""
        from bigdl_tpu_torch.serving.worker import gate_staged

        return gate_staged(self.engine, handle, probe_features,
                           probe_bucket)

    def commit(self, handle, version=None, digest=None):
        self.engine.commit_staged(handle, version=version, digest=digest)

    def release(self, handle):
        pass                                   # GC owns in-process handles

    def set_version(self, version, digest=None):
        self.engine.set_serving_version(version, digest)

    def close(self):
        self.engine.close()


class SubprocessReplica(Replica):
    """A ``serving/worker.py`` process: requests travel the worker
    wire, so this replica's crash is a PROCESS death the
    ``FleetSupervisor`` observes and repairs.  Start it with
    ``subprocess.Popen`` of a fresh interpreter (never a fork of a
    process that holds a CUDA context).

    ``spawn(attempt) -> (Popen, port)`` must return a STARTED worker
    that is ready to serve (the CLI blocks on the worker's port file);
    it is called again -- with the attempt number -- on every
    supervisor restart.

    ``transport="binary"`` (default) keeps a capped
    ``transport.WirePool`` of persistent multiplexed connections to
    the worker (digest-auth handshake against ``token`` /
    ``BIGDL_RUN_TOKEN``; broken connections evicted and re-dialed
    under ``capped_backoff``); a respawned worker gets a fresh pool on
    its new port.  ``transport="pickle"`` is the connection-per-request
    pickle wire.  A ``stage`` given ``wire_tree=`` (the fleet's int8
    weight wire, ``ServingFleet(weight_wire="int8")``) ships that
    blockwise int8 payload and its fp32 scales (dequantized in the
    worker), in preference to a snapshot path."""

    kind = "subprocess"

    def __init__(self, spawn, rid=None, host="127.0.0.1",
                 request_timeout_s=30.0, executor=None,
                 transport="binary", token=None, pool_size=2):
        super().__init__(rid)
        if transport not in ("binary", "pickle"):
            raise ValueError(f"unknown transport {transport!r}; "
                             f"expected 'binary' or 'pickle'")
        self._spawn = spawn
        self.host = host
        self.request_timeout_s = float(request_timeout_s)
        self._executor = executor              # attached by the fleet
        self.transport = transport
        self.token = token
        self.pool_size = int(pool_size)
        self._wire_sink = None                 # attached by the fleet
        self._stage_wire = {}                  # token -> (bytes, wire)
        self._pool = None
        self.proc = None
        self.port = None

    def start(self, attempt=0):
        self.proc, self.port = self._spawn(attempt)
        self._reset_pool()
        return self

    def respawn(self, attempt):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
        self.proc, self.port = self._spawn(attempt)
        self._reset_pool()                     # new port, new pool
        return self

    def alive(self):
        return self.proc is not None and self.proc.poll() is None

    def _reset_pool(self):
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.close()

    def _ensure_pool(self):
        from bigdl_tpu_torch.serving.transport import WirePool

        pool = self._pool
        if pool is None or pool.port != int(self.port):
            self._reset_pool()
            pool = self._pool = WirePool(self.host, self.port,
                                         token=self.token,
                                         size=self.pool_size,
                                         on_wire=self._note_wire)
        return pool

    def _note_wire(self, op, rtt_s, bytes_out, bytes_in):
        sink = self._wire_sink
        if sink is not None:
            try:
                sink(self.rid, op, rtt_s, bytes_out, bytes_in)
            except Exception:
                log.exception("wire stats sink failed")

    def _call(self, op, rpc_timeout=None, **kw):
        rpc = rpc_timeout or self.request_timeout_s
        if self.transport == "binary":
            result, out, inn = self._ensure_pool().request_ex(
                op, rpc_timeout=rpc, **kw)
            return result
        from bigdl_tpu_torch.serving import worker

        t0 = time.perf_counter()
        result = worker.call(self.host, self.port, op, rpc_timeout=rpc,
                             transport="pickle", **kw)
        self._note_wire(op, time.perf_counter() - t0, 0, 0)
        return result

    # -- routing -- #
    def submit(self, feature, timeout=None, admit_timeout=None):
        # the worker-side predict gets the request's REMAINING deadline
        # (admission and result are one RPC over there -- the fleet's
        # queue-admission bound must NOT cap the whole predict); the
        # socket gets a small margin on top
        if self._executor is None:
            raise RuntimeError("SubprocessReplica needs the fleet's "
                               "executor (register it with a "
                               "ServingFleet first)")
        rpc = self.request_timeout_s if timeout is None \
            else float(timeout) + 5.0
        kw = {"feature": feature, "timeout": timeout}
        return self._executor.submit(
            self._call, "predict", rpc_timeout=rpc, **kw)

    def submit_generate(self, req, timeout=None, admit_timeout=None):
        # one RPC per whole generation: the worker's engine streams
        # internally, the socket answers with the finished token list
        if self._executor is None:
            raise RuntimeError("SubprocessReplica needs the fleet's "
                               "executor (register it with a "
                               "ServingFleet first)")
        rpc = self.request_timeout_s if timeout is None \
            else float(timeout) + 5.0
        kw = {"prompt": [int(t) for t in req["prompt"]],
              "max_new_tokens": int(req.get("max_new_tokens", 16)),
              "eos_id": req.get("eos_id"), "timeout": timeout}
        # sampling knobs ride the wire only when non-greedy, so greedy
        # traffic against an older worker stays protocol-compatible
        if req.get("temperature", 0.0) > 0.0 or req.get("top_k", 0) > 0 \
                or req.get("top_p", 1.0) < 1.0 or req.get("seed") is not None:
            kw["temperature"] = float(req.get("temperature", 0.0))
            kw["top_k"] = int(req.get("top_k", 0))
            kw["top_p"] = float(req.get("top_p", 1.0))
            kw["seed"] = req.get("seed")
        return self._executor.submit(
            self._call, "generate", rpc_timeout=rpc, **kw)

    def abandon(self, fut):
        fut.cancel()          # a running RPC finishes on the worker and
        #                       is dropped here; accounting rides the
        #                       done-callback either way

    # -- deploy verbs -- #
    def drain(self, timeout=None):
        # mirror engine.drain's contract: timeout=None waits the drain
        # out, so the SOCKET must not cap it at some arbitrary margin
        margin = None if timeout is None else float(timeout) + 5.0
        return self._call("drain", rpc_timeout=margin, timeout=timeout)

    def undrain(self):
        self._call("undrain")

    def capture(self):
        return self._call("capture")

    def stage(self, params=None, mstate=None, src_layout=None, path=None,
              wire_tree=None):
        # ``wire_tree``: ``(params, mstate)`` as
        # ``transport.quantize_tree_for_wire`` wrote them -- shipped even
        # when a snapshot path is given, so the worker serves the tree
        # the wire delivers; otherwise a path stages in the worker's own
        # process and an in-memory tree ships fp32
        ww = "fp32"
        if wire_tree is not None:
            (params, mstate), ww = wire_tree, "int8"
        elif path is not None:
            return self._call("stage", path=str(path), rpc_timeout=120.0)
        if params is None:
            raise ValueError("stage needs a snapshot path or an "
                             "in-memory params tree")
        if self.transport != "binary":
            raise ValueError(
                "in-memory params cross the socket only on the binary "
                "transport (transport.quantize_tree_for_wire + raw "
                "tensor frames); the pickle escape hatch stages from "
                "a snapshot PATH")
        if src_layout is not None:
            raise ValueError(
                "stage(params=...) ships weights already in the "
                "serving layout; resharding snapshots cross as a PATH")
        result, out, _ = self._ensure_pool().request_ex(
            "stage_tree", rpc_timeout=120.0, params=params, mstate=mstate,
            weight_wire=ww)
        # the commit will stamp what ACTUALLY crossed the wire onto
        # the worker's param_refresh audit event
        self._stage_wire[result] = (int(out), ww)
        if len(self._stage_wire) > 16:
            self._stage_wire.pop(next(iter(self._stage_wire)))
        return result

    def gate(self, handle, probe_features=None, probe_bucket=None):
        ok, reason = self._call("gate", token=handle)
        return bool(ok), reason

    def commit(self, handle, version=None, digest=None):
        kw = {}
        staged = self._stage_wire.pop(handle, None)
        if staged is not None:
            kw["wire_bytes"], kw["weight_wire"] = staged
        self._call("commit", token=handle, version=version,
                   digest=digest, **kw)

    def release(self, handle):
        try:
            self._call("release", token=handle, rpc_timeout=5.0)
        except Exception:
            pass                               # worker dead/restarted

    def set_version(self, version, digest=None):
        self._call("set_version", version=version, digest=digest)

    def health(self):
        return self._call("health", rpc_timeout=5.0)

    def probe(self, features=None, bucket=None):
        return self._call("probe", features=features, bucket=bucket)

    def close(self):
        try:
            if self.alive():
                self._call("stop", rpc_timeout=2.0)
        except Exception:
            pass
        self._reset_pool()
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(5)
            except Exception:
                self.proc.kill()


# --------------------------------------------------------------------------- #
# The fleet.
# --------------------------------------------------------------------------- #


class ServingFleet:
    """Health-aware front end over N replicas.

    >>> fleet = ServingFleet([InProcessReplica(e) for e in engines],
    ...                      telemetry=tel, hedge=True)
    >>> y = fleet.predict(feature)           # routed, retried, hedged
    >>> fleet.replica_states()               # who is serving what

    Routing: least-loaded over replicas in lifecycle state ``serving``
    whose breaker admits traffic.  A failed attempt (tick exception,
    dead worker socket, admission timeout) retries on another replica
    -- up to ``retry_limit`` retries under capped exponential backoff
    with ``retry_jitter`` (injectable ``rng``), all inside the one
    request deadline (``timeout=``/``default_timeout_s``).  With
    ``hedge=True`` a request still pending after the p99 of recent
    latencies (floored at ``hedge_min_delay_s``, armed once
    ``hedge_min_samples`` latencies are observed) is re-issued to a
    second replica; first result wins and the loser is abandoned.
    More than ``admission_limit`` concurrent requests shed immediately
    with ``FleetOverloadedError``.

    The fleet is also ``serving/deploy.py``'s rolling-deploy surface
    (``is_fleet``): staging fans out per replica, shadow/canary run on
    the first in-process replica, and the controller walks
    ``drain_replica`` -> ``commit_replica`` -> ``undrain_replica``
    one replica at a time so capacity never reaches zero.

    ``weight_wire`` is how ``stage_weights`` sends an in-memory tree to
    the workers: ``"fp32"``, or ``"int8"``, the blockwise payload of
    ``transport.quantize_tree_for_wire`` (a quarter of the bytes).  On
    the int8 wire every replica stages the tree as the wire delivers it
    (in-process replicas the dequantized tree), so the whole fleet
    serves one weight set; the rollout records the wire in the
    registry, so a restarted worker boots that same set.

    Lifecycle, breaker and wire-traffic edges are ``kind: "fleet"``
    events on ``telemetry``.  ``metrics=`` (the JAX package's
    ``MetricsRegistry``) and ``trace_sample=`` (head-sampled request
    tracing) are refused: ROADMAP A8.
    """

    is_fleet = True

    def __init__(self, replicas, telemetry=None, metrics=None,
                 admission_limit=128, retry_limit=3,
                 retry_backoff_s=0.02, retry_backoff_max_s=0.5,
                 retry_jitter=0.25, default_timeout_s=30.0,
                 submit_timeout_s=1.0, hedge=False,
                 hedge_min_delay_s=0.02, hedge_percentile=99.0,
                 hedge_min_samples=20, breaker_failures=3,
                 breaker_reset_s=2.0, probe_features=None,
                 probe_bucket=None, rng=None, clock=time.monotonic,
                 sleep=time.sleep, executor_workers=None,
                 trace_sample=None, wire_flush_every=200,
                 weight_wire="fp32"):
        if metrics is not None:
            raise UnsupportedFeatureError(
                "the fleet's metrics registry and exporter (metrics=) are "
                "observability/metrics.py, not ported (ROADMAP A8)")
        if trace_sample is not None:
            raise UnsupportedFeatureError(
                "head-sampled request tracing (trace_sample=) is "
                "observability/tracing.py, not ported (ROADMAP A8)")
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        if int(admission_limit) < 1:
            raise ValueError(f"admission_limit must be >= 1, got "
                             f"{admission_limit}")
        if weight_wire not in ("fp32", "int8"):
            raise ValueError(f"unknown weight_wire {weight_wire!r}; "
                             f"expected 'fp32' or 'int8'")
        self.weight_wire = weight_wire
        self.replicas = list(replicas)
        self.telemetry = telemetry
        self.admission_limit = int(admission_limit)
        self.retry_limit = int(retry_limit)
        self.retry_backoff_s = float(retry_backoff_s)
        self.retry_backoff_max_s = float(retry_backoff_max_s)
        self.retry_jitter = float(retry_jitter)
        self.default_timeout_s = float(default_timeout_s)
        self.submit_timeout_s = float(submit_timeout_s)
        self.hedge = bool(hedge)
        self.hedge_min_delay_s = float(hedge_min_delay_s)
        self.hedge_percentile = float(hedge_percentile)
        self.hedge_min_samples = int(hedge_min_samples)
        self.probe_features = probe_features
        self.probe_bucket = probe_bucket
        self.rng = rng
        self.clock = clock
        self.sleep = sleep
        self._lock = threading.Lock()
        self._inflight_total = 0
        self._closed = False
        self._latencies = deque(maxlen=512)
        self._counters = {"ok": 0, "failed": 0, "shed": 0, "retries": 0,
                          "hedges": 0, "hedge_wins": 0}
        # wire-traffic accounting (binary transport): per-verb deltas
        # accumulate here and flush as ``wire`` fleet events every
        # ``wire_flush_every`` RPCs (and at close)
        self.wire_flush_every = max(1, int(wire_flush_every))
        self._wire_lock = threading.Lock()
        self._wire_acc = {}
        self._wire_unflushed = 0
        n_sub = sum(1 for r in self.replicas if r.kind == "subprocess")
        self._executor = None
        if n_sub:
            from concurrent.futures import ThreadPoolExecutor

            workers = executor_workers or min(32, 4 * n_sub + 4)
            self._executor = ThreadPoolExecutor(
                max_workers=workers,
                thread_name_prefix="bigdl-torch-fleet-rpc")
        for i, rep in enumerate(self.replicas):
            if rep.rid is None:
                rep.rid = i
            rep.breaker = CircuitBreaker(
                failure_threshold=breaker_failures,
                reset_timeout_s=breaker_reset_s, clock=clock,
                on_transition=self._breaker_cb(rep))
            if rep.kind == "subprocess":
                rep._executor = self._executor
                rep._wire_sink = self._note_wire
            if len({r.rid for r in self.replicas[:i + 1]}) != i + 1:
                raise ValueError("duplicate replica ids")
        for rep in self.replicas:
            alive = True
            try:
                alive = rep.alive()
            except Exception:
                alive = False
            if alive:
                self._set_state(rep, "serving")
            else:
                self.mark_dead(rep, reason="not alive at registration")

    # ----- observability plumbing ------------------------------------------- #
    def _emit(self, event, replica=None, **fields):
        if self.telemetry is None:
            return
        try:
            f = {k: v for k, v in fields.items() if v is not None}
            if replica is not None:
                f["replica"] = replica
            self.telemetry.record("fleet", event=event, **f)
        except Exception:
            log.exception("fleet telemetry record failed (%s)", event)

    def _note_wire(self, rid, verb, rtt_s, bytes_out, bytes_in):
        """One worker RPC's wire cost, accumulated per verb.  RTT
        samples are kept only up to the flush cadence so the event's
        histogram contribution is complete, not sampled."""
        with self._wire_lock:
            d = self._wire_acc.setdefault(
                verb, {"calls": 0, "bytes_sent": 0, "bytes_recv": 0,
                       "rtt_s": []})
            d["calls"] += 1
            d["bytes_sent"] += int(bytes_out)
            d["bytes_recv"] += int(bytes_in)
            if len(d["rtt_s"]) < 2 * self.wire_flush_every:
                d["rtt_s"].append(round(float(rtt_s), 6))
            self._wire_unflushed += 1
            if self._wire_unflushed < self.wire_flush_every:
                return
            acc, self._wire_acc = self._wire_acc, {}
            self._wire_unflushed = 0
        self._flush_wire(acc)

    def _flush_wire(self, acc):
        for verb, d in acc.items():
            self._emit("wire", verb=verb, calls=d["calls"],
                       bytes_sent=d["bytes_sent"],
                       bytes_recv=d["bytes_recv"], rtt_s=d["rtt_s"])

    def wire_stats(self):
        """The UNFLUSHED per-verb wire aggregate (flushed deltas are
        in the ``wire`` events)."""
        with self._wire_lock:
            return {v: dict(d, rtt_s=list(d["rtt_s"]))
                    for v, d in self._wire_acc.items()}

    def _breaker_cb(self, rep):
        def cb(frm, to):
            self._emit("breaker", replica=rep.rid,
                       **{"from": frm, "to": to})
        return cb

    def _set_state(self, rep, state, reason=None):
        if state not in REPLICA_STATES:
            raise ValueError(f"unknown replica state {state!r}")
        prev = rep.state
        if prev == state:
            return
        rep.state = state
        self._emit("state", replica=rep.rid, state=state, prev=prev,
                   reason=None if reason is None else str(reason)[:300])

    # ----- request path ------------------------------------------------------ #
    def predict(self, feature, timeout=None):
        """One request through the fleet: admission -> route -> (retry/
        hedge) -> result.  Raises ``FleetOverloadedError`` on shed,
        ``FleetUnavailableError`` when the deadline/retry budget runs
        out without a result."""
        return self._request(feature, timeout, op="submit",
                             hedge_ok=True)

    def generate(self, prompt, max_new_tokens=16, eos_id=None,
                 timeout=None, temperature=0.0, top_k=0, top_p=1.0,
                 seed=None):
        """One generation request through the fleet: the same admission
        window, least-loaded routing, breakers and deadline-budgeted
        retries as ``predict`` (a failed replica's request re-runs from
        the prompt on a sibling), returning the generated token ids.

        When the caller samples without a seed, the fleet mints one here,
        before routing, so every retry replays the same stream on
        whichever replica it lands on.  Hedging is off for generation: a
        multi-token request holds a decode slot for its whole life, and a
        hedge would book two."""
        req = {"prompt": prompt, "max_new_tokens": int(max_new_tokens),
               "eos_id": eos_id}
        if temperature > 0.0 or top_k > 0 or top_p < 1.0 \
                or seed is not None:
            if seed is None and temperature > 0.0:
                seed = int.from_bytes(os.urandom(4), "little") & 0x7fffffff
            req.update(temperature=float(temperature), top_k=int(top_k),
                       top_p=float(top_p), seed=seed)
        return self._request(req, timeout, op="submit_generate",
                             hedge_ok=False)

    def _request(self, feature, timeout, op, hedge_ok):
        if self._closed:
            raise RuntimeError("ServingFleet is closed")
        budget = self.default_timeout_s if timeout is None \
            else float(timeout)
        deadline = self.clock() + budget
        with self._lock:
            if self._inflight_total >= self.admission_limit:
                self._counters["shed"] += 1
                shed = True
            else:
                self._inflight_total += 1
                shed = False
        if shed:
            raise FleetOverloadedError(
                f"fleet admission window full ({self.admission_limit} "
                f"requests in flight); shedding instead of queueing -- "
                f"retry with backoff")
        try:
            y = self._serve(feature, deadline, op=op, hedge_ok=hedge_ok)
        except Exception:
            with self._lock:
                self._counters["failed"] += 1
            raise
        else:
            with self._lock:
                self._counters["ok"] += 1
            return y
        finally:
            with self._lock:
                self._inflight_total -= 1

    def _count(self, name):
        with self._lock:
            self._counters[name] += 1

    def _pick(self, exclude=(), prefer_not=()):
        """Least-loaded routing over admittable replicas: lifecycle
        ``serving``, breaker admits (an ``acquire`` that returns True
        reserves the attempt -- every pick ends in exactly one breaker
        record call via ``_finish``)."""
        with self._lock:
            cands = [r for r in self.replicas
                     if r.state == "serving" and r.rid not in exclude]
            cands.sort(key=lambda r: (r.rid in prefer_not, r.inflight,
                                      r.rid))
        for r in cands:
            if r.breaker.acquire():
                return r
        return None

    @staticmethod
    def _drain_refusal(err):
        """An ``EngineDraining`` refusal is a mid-deploy 'pick another
        replica' signal, not a serving failure: it must not count toward
        the breaker's consecutive-failure streak.  The wire carries the
        exception's type name (``ReplicaCallError.error_type``)."""
        from bigdl_tpu_torch.serving.engine import EngineDraining

        return isinstance(err, EngineDraining) or \
            getattr(err, "error_type", None) == "EngineDraining"

    def _launch(self, rep, feature, remaining, op="submit"):
        with self._lock:
            rep.inflight += 1
        t0 = self.clock()
        try:
            fut = getattr(rep, op)(
                feature, timeout=remaining,
                admit_timeout=min(remaining, self.submit_timeout_s))
        except Exception as e:
            with self._lock:
                rep.inflight = max(0, rep.inflight - 1)
            if self._drain_refusal(e):
                rep.breaker.record_cancel()
            else:
                rep.failed += 1
                rep.breaker.record_failure()
            raise
        fut.add_done_callback(
            lambda f, _r=rep, _t=t0, _op=op: self._finish(_r, f, _t, _op))
        return fut

    def _finish(self, rep, fut, t0, op="submit"):
        with self._lock:
            rep.inflight = max(0, rep.inflight - 1)
        if fut.cancelled():
            rep.breaker.record_cancel()
            return
        err = fut.exception()
        if err is None:
            rep.served += 1
            rep.breaker.record_success()
            if op == "submit":
                # only predict latencies calibrate the hedge reservoir:
                # a generation is seconds where a predict is milliseconds
                self._note_latency(self.clock() - t0)
        elif self._drain_refusal(err):
            rep.breaker.record_cancel()
        else:
            rep.failed += 1
            rep.breaker.record_failure()

    def _note_latency(self, s):
        with self._lock:
            self._latencies.append(float(s))

    def _hedge_delay(self):
        """The p99-derived hedge trigger, or None while hedging is off
        / uncalibrated (fewer than ``hedge_min_samples`` latencies)."""
        if not self.hedge:
            return None
        with self._lock:
            if len(self._latencies) < self.hedge_min_samples:
                return None
            samples = sorted(self._latencies)
        return max(self.hedge_min_delay_s,
                   percentile(samples, self.hedge_percentile))

    def _backoff_sleep(self, attempt, deadline):
        b = capped_backoff(attempt - 1, self.retry_backoff_s,
                           self.retry_backoff_max_s,
                           jitter=self.retry_jitter, rng=self.rng)
        b = min(b, max(0.0, deadline - self.clock()))
        if b > 0:
            self.sleep(b)

    def _serve(self, feature, deadline, op="submit", hedge_ok=True):
        from concurrent.futures import FIRST_COMPLETED
        from concurrent.futures import wait as future_wait

        attempts = 0                  # failed rounds so far
        failed_rids = []
        last_err = None

        def give_up(msg):
            raise FleetUnavailableError(
                f"{msg} after {attempts} failed attempt(s)"
                + (f" (replicas tried: {sorted(set(failed_rids))})"
                   if failed_rids else "")
                + (f": {last_err}" if last_err is not None else "")) \
                from last_err

        while True:
            remaining = deadline - self.clock()
            if remaining <= 0:
                give_up("request deadline exhausted")
            rep = self._pick(prefer_not=failed_rids)
            if rep is None:
                last_err = last_err or FleetUnavailableError(
                    "no admittable replica (dead, draining, or "
                    "circuit-open)")
                attempts += 1
                if attempts > self.retry_limit:
                    give_up("no admittable replica")
                self._count("retries")
                self._backoff_sleep(attempts, deadline)
                continue
            futs = {}
            try:
                fut = self._launch(rep, feature, remaining, op=op)
                futs[fut] = rep
            except Exception as e:
                last_err = e
                failed_rids.append(rep.rid)
                attempts += 1
                if attempts > self.retry_limit:
                    give_up("request failed")
                self._count("retries")
                self._backoff_sleep(attempts, deadline)
                continue
            hedged = False
            primary = fut
            # one percentile derivation per attempt; hedge_ok=False
            # (generation) never arms the hedge timer
            delay = self._hedge_delay() if hedge_ok else None
            while futs:
                remaining = deadline - self.clock()
                if remaining <= 0:
                    for f, r in futs.items():
                        r.abandon(f)
                    give_up("request deadline exhausted mid-attempt")
                wait_s, hedge_due = remaining, False
                if not hedged and delay is not None and delay < wait_s:
                    wait_s, hedge_due = delay, True
                done, _ = future_wait(set(futs), timeout=wait_s,
                                      return_when=FIRST_COMPLETED)
                winner = None
                for f in done:
                    if not f.cancelled() and f.exception() is None:
                        winner = f
                        break
                if winner is not None:
                    for f, r in futs.items():
                        if f is not winner:
                            r.abandon(f)
                    # a hedge "win" means the second replica beat a
                    # primary that was still pending
                    if winner is not primary and primary in futs:
                        self._count("hedge_wins")
                    return winner.result()
                for f in done:             # failures/cancellations
                    r = futs.pop(f)
                    if not f.cancelled():
                        last_err = f.exception()
                    failed_rids.append(r.rid)
                if not futs:
                    break                  # whole round failed -> retry
                if not done and hedge_due:
                    hedged = True          # at most one hedge/request
                    second = self._pick(
                        exclude=[r.rid for r in futs.values()],
                        prefer_not=failed_rids)
                    if second is not None:
                        try:
                            f2 = self._launch(second, feature,
                                              remaining, op=op)
                            futs[f2] = second
                            self._count("hedges")
                        except Exception as e:
                            last_err = e
                            failed_rids.append(second.rid)
            attempts += 1
            if attempts > self.retry_limit:
                give_up("request failed")
            self._count("retries")
            self._backoff_sleep(attempts, deadline)

    # ----- status surface ---------------------------------------------------- #
    def replica_ids(self, live_only=False):
        return [r.rid for r in self.replicas
                if not live_only or r.state not in ("dead", "closed")]

    def _by_id(self, rid):
        for r in self.replicas:
            if r.rid == rid:
                return r
        raise KeyError(f"unknown replica {rid}")

    def replica_states(self):
        return {r.rid: r.describe() for r in self.replicas}

    def counters(self):
        with self._lock:
            return dict(self._counters)

    def memory_headroom(self):
        """The fleet-wide capacity signal (future autoscaler input):
        per-replica ``memory_headroom()`` plus aggregates -- the
        TIGHTEST device headroom across replicas (the replica that
        OOMs first bounds the fleet) and the SUMMED free KV blocks
        (shed-resistant admission capacity).  Replicas that cannot
        report (remote workers, dead processes) are skipped."""
        per = {}
        for r in self.replicas:
            if r.state in ("dead", "closed"):
                continue
            try:
                h = r.memory_headroom()
            except Exception:
                h = None
            if h is not None:
                per[r.rid] = h
        agg = {"replicas": per}
        headrooms = [h["headroom_bytes"] for h in per.values()
                     if h.get("headroom_bytes") is not None]
        if headrooms:
            agg["min_headroom_bytes"] = min(headrooms)
        fracs = [h["headroom_fraction"] for h in per.values()
                 if h.get("headroom_fraction") is not None]
        if fracs:
            agg["min_headroom_fraction"] = min(fracs)
        frees = [h["kv_blocks_free"] for h in per.values()
                 if h.get("kv_blocks_free") is not None]
        if frees:
            agg["kv_blocks_free"] = sum(frees)
            agg["kv_blocks_total"] = sum(
                h.get("kv_blocks_total", 0) for h in per.values())
        return agg

    # ----- lifecycle transitions (supervisor + deploys) ---------------------- #
    def mark_dead(self, rep, reason=None):
        """The replica's process is gone: stop routing NOW (breaker
        forced open, lifecycle ``dead``) -- in-flight attempts fail and
        retry elsewhere."""
        self._set_state(rep, "dead", reason=reason)
        rep.breaker.force_open()

    def mark_joined(self, rep):
        """A restarted replica is healthy again: breaker reset closed,
        lifecycle back to ``serving``."""
        rep.breaker.reset()
        self._set_state(rep, "serving", reason="rejoined")

    def drain_replica(self, rid, timeout=None):
        """Stop routing to one replica and wait for its accepted work
        to finish (the rolling deploy's first step).  Routing skips it
        the moment the state leaves ``serving``; a request that raced
        in anyway either completes (drain waits) or raises
        ``EngineDraining`` and retries on a sibling."""
        rep = self._by_id(rid)
        self._set_state(rep, "draining")
        try:
            ok = bool(rep.drain(timeout=timeout))
        except Exception:
            # a failed drain call must not strand the replica in
            # "draining" (unroutable forever); the caller sees the
            # error, routing sees a serving replica again
            self._set_state(rep, "serving",
                            reason="drain call failed")
            raise
        if ok:
            self._set_state(rep, "drained")
        return ok

    def undrain_replica(self, rid):
        rep = self._by_id(rid)
        rep.undrain()
        self._set_state(rep, "serving")

    def commit_replica(self, rid, handle, version=None, digest=None):
        self._by_id(rid).commit(handle, version=version, digest=digest)

    def gate_replica(self, rid, handle):
        """(ok, reason) of the per-replica deploy gate on an
        already-staged fleet handle."""
        rep = self._by_id(rid)
        h = (handle.get("per_replica") or {}).get(rid)
        if h is None:
            return False, "no staged candidate for this replica"
        try:
            return rep.gate(h, self.probe_features, self.probe_bucket)
        except Exception as e:
            return False, f"gate probe failed: {e}"

    # ----- deploy facade (serving/deploy.py drives these) -------------------- #
    def _exposure_rep(self):
        for rep in self.replicas:
            if rep.kind == "in_process":
                return rep
        raise RuntimeError(
            "this fleet has no in-process replica: shadow/canary "
            "staged exposure needs one (tools/torch_serve_fleet.py runs the "
            "driver's own engine as replica 0)")

    @property
    def exposure(self):
        """The staged-exposure engine (first in-process replica):
        shadow mirrors and canary routing run here."""
        return self._exposure_rep().engine

    @property
    def ladder(self):
        return self.exposure.ladder

    def predict_at(self, feature, bucket):
        return self.exposure.predict_at(feature, bucket)

    def _read_snapshot(self, p):
        return self.exposure._read_snapshot(p)

    def stage_weights(self, params=None, mstate=None, src_layout=None,
                      path=None):
        """Fan a candidate out: stage on every live replica (nothing
        committed anywhere).  In-process replicas stage the in-memory
        tree; subprocess replicas load+stage ``path`` in their own
        process, or -- on the binary transport -- take the in-memory
        tree over the wire.  On the fleet's int8 ``weight_wire`` the
        tree is quantized once: workers are sent the blockwise-int8
        payload+scales (dequantized worker-side), in-process replicas
        stage the same dequantized tree.  Returns the fleet handle
        ``{"per_replica": {rid: handle}}`` the rolling cutover walks."""
        kw = {}
        if self.weight_wire == "int8" and params is not None:
            from bigdl_tpu_torch.serving.transport import (
                dequantize_wire_tree, quantize_tree_for_wire)

            wire = (quantize_tree_for_wire(params),
                    None if mstate is None
                    else quantize_tree_for_wire(mstate))
            params = dequantize_wire_tree(wire[0])
            mstate = None if mstate is None else dequantize_wire_tree(wire[1])
            kw["wire_tree"] = wire
        per = {}
        model_bytes = quantized = None
        for rep in self.replicas:
            if rep.state in ("dead", "closed"):
                continue               # it will boot from the registry
            try:
                h = rep.stage(params=params, mstate=mstate,
                              src_layout=src_layout, path=path, **kw)
            except Exception as e:
                # a replica that DIED under the stage is skipped like
                # everywhere else in the roll -- one crash must not
                # reject a healthy candidate fleet-wide (and put it on
                # the reject cooldown); a replica that is alive and
                # refused is judging the CANDIDATE, and that propagates
                alive = True
                try:
                    alive = rep.alive()
                except Exception:
                    alive = False
                if not alive:
                    self.mark_dead(rep, reason=f"died mid-stage: {e}")
                    continue
                raise
            per[rep.rid] = h
            if isinstance(h, dict):
                model_bytes = h.get("model_bytes", model_bytes)
                quantized = h.get("quantized", quantized)
        if not per:
            raise RuntimeError("no live replica to stage on")
        return {"fleet": True, "per_replica": per,
                "model_bytes": model_bytes, "quantized": quantized}

    def capture_staged(self):
        """Every live replica's CURRENT weights as a fleet handle (the
        rolling rollback target).  A replica that dies under the
        capture is marked dead and skipped -- one crash must not abort
        the rollout that would have skipped it anyway."""
        per = {}
        for rep in self.replicas:
            if rep.state in ("dead", "closed"):
                continue
            try:
                per[rep.rid] = rep.capture()
            except Exception as e:
                alive = True
                try:
                    alive = rep.alive()
                except Exception:
                    alive = False
                if not alive:
                    self.mark_dead(rep, reason=f"died mid-capture: {e}")
                else:
                    log.exception("capture on replica %s failed",
                                  rep.rid)
        return {"fleet": True, "per_replica": per}

    def commit_staged(self, handle, version=None, digest=None):
        """Commit an already-staged fleet handle on every live replica
        -- the NON-rolling spelling (boot-time resume, whole-fleet
        rollback): each per-replica commit is the atomic pointer swap,
        no drain needed.  A replica whose commit fails (worker
        restarted since staging, token evicted) is logged and SKIPPED
        so one bad replica cannot leave the rest of the fleet on the
        wrong version mid-rollback; the call only raises when NO
        replica committed."""
        per = handle.get("per_replica") or {}
        committed, first_err = [], None
        for rid in sorted(per):
            rep = self._by_id(rid)
            if rep.state in ("dead", "closed"):
                continue
            try:
                rep.commit(per[rid], version=version, digest=digest)
                committed.append(rid)
            except Exception as e:
                first_err = first_err or e
                log.exception("commit_staged failed on replica %s "
                              "(the supervisor / next deploy must "
                              "reconcile it)", rid)
        if first_err is not None and not committed:
            raise RuntimeError(
                f"commit_staged failed on every replica: {first_err}") \
                from first_err
        return self

    def release_staged(self, handle):
        """Release a rejected candidate's staged buffers fleet-wide
        (subprocess workers drop their tokens; in-process handles are
        garbage)."""
        per = (handle or {}).get("per_replica") or {}
        for rid, h in per.items():
            try:
                self._by_id(rid).release(h)
            except Exception:
                pass

    def eval_staged(self, handle, x, tick=0):
        rep = self._exposure_rep()
        return rep.engine.eval_staged(handle["per_replica"][rep.rid], x,
                                      tick=tick)

    def set_canary(self, handle, fraction=0.1, version=None):
        rep = self._exposure_rep()
        h = None if handle is None else handle["per_replica"][rep.rid]
        return rep.engine.set_canary(h, fraction, version=version)

    def canary_stats(self):
        return self.exposure.canary_stats()

    def set_shadow(self, fn, fraction=1.0):
        return self.exposure.set_shadow(fn, fraction)

    def set_serving_version(self, version, digest=None):
        for rep in self.replicas:
            if rep.state in ("dead", "closed"):
                continue
            try:
                rep.set_version(version, digest)
            except Exception:
                log.exception("set_serving_version failed on replica "
                              "%s", rep.rid)
        return self

    # ----- lifecycle --------------------------------------------------------- #
    def close(self, timeout=10.0):
        """Stop the fleet: emit the final durable stats event, close
        every replica (subprocess workers get a polite stop, then
        terminate), shut the RPC executor down.  Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            counters = dict(self._counters)
        with self._wire_lock:
            acc, self._wire_acc = self._wire_acc, {}
            self._wire_unflushed = 0
        self._flush_wire(acc)                  # the remainder delta
        self._emit("stats", **counters)
        for rep in self.replicas:
            try:
                rep.close()
            except Exception:
                log.exception("closing replica %s failed", rep.rid)
            self._set_state(rep, "closed")
        if self._executor is not None:
            self._executor.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# --------------------------------------------------------------------------- #
# The supervisor: dead subprocess replicas come back.
# --------------------------------------------------------------------------- #


class FleetSupervisor:
    """Watch subprocess replicas; restart the dead under capped,
    jittered backoff (the ``optim/recovery.RunSupervisor`` pattern,
    per-replica).  A restarted worker boots from the registry's
    COMMITTED version (its ``--registry`` flag ->
    ``worker.boot_from_registry``), so it rejoins serving exactly what
    the fleet serves -- never a half-promoted candidate.

    ``check()`` is one supervision cycle (tests drive it with an
    injected clock); ``start()`` runs it on a poll thread.  Per-replica
    budget: after ``max_restarts`` failed resurrections the replica is
    marked ``closed`` and the fleet keeps serving on the survivors --
    a permanently crashing worker must not consume the supervisor
    forever."""

    def __init__(self, fleet, max_restarts=5, backoff_base_s=0.5,
                 backoff_max_s=30.0, jitter=0.25, rng=None,
                 poll_interval_s=0.2, clock=time.monotonic):
        self.fleet = fleet
        self.max_restarts = int(max_restarts)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.jitter = float(jitter)
        self.rng = rng
        self.poll_interval_s = float(poll_interval_s)
        self.clock = clock
        self.restarts = {}             # rid -> attempts so far
        self.events = []
        self._due = {}                 # rid -> next-restart clock time
        self._backoff = {}             # rid -> last scheduled backoff
        self._stop = threading.Event()
        self._thread = None

    def backoff_s(self, restarts):
        return capped_backoff(restarts, self.backoff_base_s,
                              self.backoff_max_s, jitter=self.jitter,
                              rng=self.rng)

    def check(self):
        """One cycle: detect deaths, schedule + perform due restarts.
        Returns the list of replica ids restarted this cycle."""
        restarted = []
        for rep in self.fleet.replicas:
            if rep.kind != "subprocess" or rep.state == "closed":
                continue
            if rep.state != "dead" and not rep.alive():
                rc = rep.proc.poll() if rep.proc is not None else None
                n = self.restarts.get(rep.rid, 0)
                backoff = self.backoff_s(n)
                self.fleet.mark_dead(
                    rep, reason=f"process died (rc={rc})")
                self._due[rep.rid] = self.clock() + backoff
                self._backoff[rep.rid] = backoff
            if rep.state != "dead":
                continue
            due = self._due.get(rep.rid)
            if due is None:            # died before we ever saw it
                self._due[rep.rid] = self.clock()
                self._backoff[rep.rid] = 0.0
                continue
            if self.clock() < due:
                continue
            n = self.restarts.get(rep.rid, 0)
            if n >= self.max_restarts:
                self.fleet._set_state(
                    rep, "closed",
                    reason=f"restart budget ({self.max_restarts}) "
                           f"exhausted")
                continue
            self.restarts[rep.rid] = n + 1
            try:
                rep.respawn(n + 1)
            except Exception as e:
                log.exception("restart of replica %s failed", rep.rid)
                backoff = self.backoff_s(n + 1)
                self._due[rep.rid] = self.clock() + backoff
                self._backoff[rep.rid] = backoff
                self.fleet._emit("restart_failed", replica=rep.rid,
                                 restart=n + 1, error=str(e)[:300])
                continue
            self.fleet.mark_joined(rep)
            event = {"replica": rep.rid, "restart": n + 1,
                     "backoff_s": self._backoff.get(rep.rid, 0.0),
                     "cause": "process_death"}
            self.events.append(event)
            self.fleet._emit("restart", **event)
            restarted.append(rep.rid)
        return restarted

    def start(self):
        self._thread = threading.Thread(
            target=self._loop, name="bigdl-fleet-supervisor",
            daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.check()
            except Exception:
                log.exception("fleet supervision cycle failed")
            self._stop.wait(self.poll_interval_s)

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5)
