"""Versioned hot-swap deployment (the port's copy of
``bigdl_tpu/serving/deploy.py``): the train -> serve loop, closed.

- ``ModelRegistry`` -- monotonic version ids, each carrying its snapshot
  path, manifest digest and layout.  The previous version's staged
  weights are retained, so a rollback is a commit of the retained handle,
  never a re-quantization or a re-stage.  The state persists durably in
  ``registry.json`` (temp-write and atomic rename) in the JAX package's
  format: each package reads the other's registry, as both read each
  other's checkpoints.
- ``RolloutController`` -- watches a checkpoint directory through the
  verified-intact resolution that training resume uses, and walks each
  new snapshot through staged exposure: **shadow** (a fraction of live
  ticks mirrored to the candidate off the request path, compared by
  ``AccuracyDeltaGate.compare``), **canary** (a fraction of ticks served
  by the candidate, with health checks and the accuracy gate), then the
  **cutover** (``ServingEngine.commit_staged``).  On a ``ServingFleet``
  the cutover is a rolling deploy, replica by replica.  A burning health
  source, a gate refusal or a crashing canary tick rejects the
  candidate, or, inside the post-cutover watch window, rolls back to the
  retained previous version.

Every stage lands as a ``kind: "deploy"`` event on ``telemetry``, any
object with ``record(kind, **fields)``; the durable telemetry writer and
the metrics bridge wait for ROADMAP A8.  A snapshot of another layout
(tp, pp, pp+tp ...) is staged with its ``src_layout`` and redistributed
by the engine.

The registry half needs no device: a supervisor parses
``registry.json`` without a card.
"""

import hashlib
import json
import logging
import os
import queue
import threading
import time

log = logging.getLogger("bigdl_tpu_torch.serving")

#: lifecycle stages a ModelVersion moves through (terminal:
#: rejected / rolled_back / retired)
VERSION_STAGES = ("registered", "shadow", "canary", "live", "previous",
                  "rejected", "rolled_back", "retired")

#: stages a ``kind: "deploy"`` event may carry (the schema pin in
#: tests/test_deploy.py holds this closed set)
DEPLOY_STAGES = ("registered", "shadow", "canary", "cutover", "live",
                 "rollback", "resume")

#: keys every deploy event carries
DEPLOY_EVENT_KEYS = ("version", "stage", "verdict", "reason")


def parse_deploy_chaos(spec):
    """``--chaos kill:cutover:<n>`` -> ``("kill", "cutover", n)``; None
    passes through.  The serving-side analogue of
    ``optim/recovery.parse_chaos``: SIGKILL the serving process at the
    MIDPOINT of its ``n``-th cutover (device buffers swapped, registry
    not yet committed).  A typo'd spec is a configuration error, not a
    silently-skipped drill."""
    if spec in (None, ""):
        return None
    from bigdl_tpu_torch.utils.errors import ConfigurationError

    parts = str(spec).split(":")
    if len(parts) == 3 and parts[0] == "kill" and parts[1] == "cutover" \
            and parts[2].isdigit() and int(parts[2]) >= 1:
        return ("kill", "cutover", int(parts[2]))
    raise ConfigurationError(
        f"unknown deploy chaos spec {spec!r}; expected kill:cutover:<n> "
        "(SIGKILL the serving process mid-way through its n-th cutover)")


def parse_fleet_chaos(spec):
    """``--chaos kill:replica:<i>@<tick>`` -> ``("kill", i, tick)``;
    None passes through.  The fleet drill's fault injection
    (``tools/torch_serve_fleet.py``): SIGKILL replica ``i``'s worker process
    once the closed-loop clients have completed ``tick`` requests --
    the retries must absorb it, the breaker must open, and the
    supervisor must bring the replica back on the committed version.
    A typo'd spec is a configuration error, not a silently-skipped
    drill."""
    if spec in (None, ""):
        return None
    from bigdl_tpu_torch.utils.errors import ConfigurationError

    parts = str(spec).split(":")
    if len(parts) == 3 and parts[0] == "kill" and parts[1] == "replica":
        tail = parts[2].split("@")
        if len(tail) == 2 and tail[0].isdigit() and tail[1].isdigit() \
                and int(tail[1]) >= 1:
            return ("kill", int(tail[0]), int(tail[1]))
    raise ConfigurationError(
        f"unknown fleet chaos spec {spec!r}; expected "
        "kill:replica:<i>@<tick> (SIGKILL replica i's worker once the "
        "clients have completed <tick> requests)")


def snapshot_digest(path):
    """A short stable digest of a snapshot's sidecar manifest (the
    per-file sha256 map), or None for a manifest-less legacy snapshot.
    This is the identity a ``ModelVersion`` carries: two snapshots with
    the same digest hold bit-identical files, so the registry can tell
    "the trainer wrote something new" from "the same snapshot again"
    without hashing gigabytes twice (the manifest already did)."""
    from bigdl_tpu_torch.utils import file_io

    manifest = file_io.read_manifest(path)
    if not manifest:
        return None
    files = manifest.get("files") or {}
    blob = json.dumps(sorted((k, v.get("sha256"))
                             for k, v in files.items()))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _host_rows(tree, n):
    """The first ``n`` rows of every leaf of an output tree, numpy."""
    if isinstance(tree, dict):
        return {k: _host_rows(v, n) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_rows(v, n) for v in tree)
    import numpy as np

    return np.asarray(tree)[:n]


class ModelVersion:
    """One registered model version: identity (id + snapshot path +
    manifest digest + layout), lifecycle ``stage``, and -- while
    retained -- the engine's staged device-buffer ``handle``.

    ``weight_wire="int8"`` records that the version was staged over the
    fleet's int8 weight wire, so the replicas serve the snapshot as
    ``transport.quantize_tree_for_wire`` then ``dequantize_wire_tree``
    leave it (``worker.boot_from_registry`` boots the same); the key is
    written to ``registry.json`` only then, and the JAX package's
    reader ignores it."""

    def __init__(self, version, path=None, digest=None, layout=None,
                 stage="registered", handle=None, created=None,
                 weight_wire=None):
        self.version = int(version)
        self.path = None if path is None else str(path)
        self.digest = digest
        self.layout = layout
        self.stage = stage
        self.handle = handle
        self.created = time.time() if created is None else created
        self.weight_wire = None if weight_wire == "fp32" else weight_wire
        self.stats = {}

    def to_manifest(self):
        d = {"version": self.version, "path": self.path,
             "digest": self.digest, "layout": self.layout,
             "stage": self.stage, "created": self.created}
        if self.weight_wire is not None:
            d["weight_wire"] = self.weight_wire
        return d

    @classmethod
    def from_manifest(cls, d):
        return cls(d["version"], d.get("path"), d.get("digest"),
                   d.get("layout"), d.get("stage", "registered"),
                   created=d.get("created"),
                   weight_wire=d.get("weight_wire"))

    def describe(self):
        return (f"v{self.version}[{self.stage}]"
                + (f" {self.digest}" if self.digest else ""))


class ModelRegistry:
    """The versioned answer to "which checkpoint is serving?".

    >>> reg = ModelRegistry(os.path.join(out, "registry.json"))
    >>> v = reg.register(handle, path=snap, digest=digest)
    >>> reg.promote(v.version)        # v serves; the old live version's
    ...                               # staged buffers stay retained
    >>> reg.rollback()                # pointer swap back to it

    ``promote`` retains exactly live + previous staged handles (older
    versions drop their device buffers -- memory stays bounded no
    matter how many versions a long-lived fleet walks through); a
    version's IDENTITY (path/digest/layout/stage) is kept for every
    version and -- when a ``path`` was given at construction --
    persisted durably on every mutation (temp-write + atomic rename,
    the checkpoint discipline), so a SIGKILLed serving process restarts
    knowing exactly which version was live and re-stages it from its
    verified snapshot.
    """

    def __init__(self, path=None):
        self.path = None if path is None else str(path)
        self._lock = threading.RLock()
        self.versions = []
        self._live = None          # version id
        self._previous = None
        if self.path is not None and os.path.exists(self.path):
            self._load()

    # ----- lookups ----------------------------------------------------------- #
    def get(self, version):
        with self._lock:
            for v in self.versions:
                if v.version == int(version):
                    return v
        return None

    @property
    def live(self):
        return None if self._live is None else self.get(self._live)

    @property
    def previous(self):
        return None if self._previous is None else self.get(self._previous)

    def retained_bytes(self, include_live=False):
        """Device bytes of staged-version buffers the registry still
        retains, summed from each handle's ``model_bytes`` stamp.  The
        live version's buffers ARE the engine's serving params -- the
        ledger's ``params`` subsystem already owns them -- so they are
        excluded by default; what remains is the deploy tier's real
        extra footprint (the previous version kept for rollback plus
        any not-yet-promoted candidates).  This is the ``staged``
        source ``ServingEngine.memory_ledger(registry=...)`` wires in
        (observability/memory.py)."""
        with self._lock:
            total = 0
            for v in self.versions:
                if v.handle is None:
                    continue
                if not include_live and v.version == self._live:
                    continue
                b = v.handle.get("model_bytes") \
                    if isinstance(v.handle, dict) else None
                if b:
                    total += int(b)
            return total

    def known_digests(self):
        """Digests (and paths, for digest-less legacy snapshots) of
        every version ever registered -- the rollout watcher's
        already-seen set, so a restart does not re-deploy the snapshot
        that is already live."""
        with self._lock:
            out = set()
            for v in self.versions:
                if v.digest:
                    out.add(v.digest)
                elif v.path:
                    out.add(v.path)
            return out

    # ----- mutations ---------------------------------------------------------- #
    def register(self, handle, path=None, digest=None, layout=None,
                 weight_wire=None):
        """A new version (monotonic id) holding a staged handle; stays
        ``registered`` until promoted/rejected."""
        with self._lock:
            vid = 1 + max((v.version for v in self.versions), default=0)
            v = ModelVersion(vid, path, digest, layout, handle=handle,
                             weight_wire=weight_wire)
            self.versions.append(v)
            self._persist()
            return v

    def mark(self, version, stage):
        if stage not in VERSION_STAGES:
            raise ValueError(f"unknown version stage {stage!r}; expected "
                             f"one of {VERSION_STAGES}")
        with self._lock:
            v = self.get(version)
            if v is None:
                raise KeyError(f"unknown version {version}")
            v.stage = stage
            if stage in ("rejected", "rolled_back", "retired"):
                v.handle = None          # staged buffers released
            self._persist()
            return v

    def promote(self, version):
        """Make ``version`` live.  The old live version becomes
        ``previous`` WITH its staged buffers retained (the rollback
        target); anything older drops its handle."""
        with self._lock:
            v = self.get(version)
            if v is None:
                raise KeyError(f"unknown version {version}")
            if self._live is not None and self._live != v.version:
                old = self.get(self._live)
                old.stage = "previous"
                prev = self.get(self._previous) \
                    if self._previous is not None else None
                if prev is not None and prev.version != v.version:
                    prev.stage = "retired"
                    prev.handle = None
                self._previous = old.version
            v.stage = "live"
            self._live = v.version
            self._persist()
            return v

    def rollback(self):
        """Pointer swap back to the retained previous version: the
        rolled-back live version releases its buffers, ``previous``
        becomes live again (and there is no previous anymore -- a
        second rollback needs a new cutover first).  Returns
        ``(now_live, rolled_back)``."""
        with self._lock:
            prev = self.previous
            if prev is None:
                raise RuntimeError(
                    "rollback without a retained previous version "
                    "(nothing was ever cut over, or it was already "
                    "rolled back)")
            bad = self.live
            if bad is not None:
                bad.stage = "rolled_back"
                bad.handle = None
            prev.stage = "live"
            self._live = prev.version
            self._previous = None
            self._persist()
            return prev, bad

    def describe(self):
        with self._lock:
            return {"live": self._live, "previous": self._previous,
                    "versions": [v.to_manifest() for v in self.versions]}

    # ----- durability ---------------------------------------------------------- #
    def _persist(self):
        """Temp-write + atomic rename (the snapshot discipline): a
        writer SIGKILLed mid-persist leaves the previous registry
        state, never a truncated one -- which is exactly what the
        mid-cutover chaos drill leans on."""
        if self.path is None:
            return
        state = {"schema_version": 1, **self.describe()}
        tmp = self.path + f".tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(state, f, indent=1)
            f.flush()
            try:
                os.fsync(f.fileno())
            except OSError:      # pragma: no cover - exotic filesystems
                pass
        os.replace(tmp, self.path)

    def _load(self):
        with open(self.path) as f:
            state = json.load(f)
        self.versions = [ModelVersion.from_manifest(d)
                         for d in state.get("versions", [])]
        self._live = state.get("live")
        self._previous = state.get("previous")


class _ShadowStats:
    """Accumulated live-vs-candidate divergence over mirrored ticks,
    using ``AccuracyDeltaGate.compare`` per batch (THE one divergence
    definition) and aggregating row-weighted."""

    def __init__(self):
        self.rows = 0
        self.ticks = 0
        self.agree_rows = 0.0
        self.sq_sum = 0.0          # sum of squared logit deltas
        self.elements = 0

    def add(self, live_logits, cand_logits):
        import numpy as np

        from bigdl_tpu_torch.optim.validation import AccuracyDeltaGate

        detail = AccuracyDeltaGate.compare(live_logits, cand_logits)
        n = detail["batch"]
        self.ticks += 1
        self.rows += n
        self.agree_rows += detail["top1_agreement"] * n
        size = int(np.asarray(live_logits).size)
        self.sq_sum += detail["logit_rmse"] ** 2 * size
        self.elements += size
        return detail

    @property
    def top1_agreement(self):
        return None if not self.rows else self.agree_rows / self.rows

    @property
    def logit_rmse(self):
        return None if not self.elements \
            else (self.sq_sum / self.elements) ** 0.5

    def summary(self):
        return {"shadow_ticks": self.ticks, "shadow_rows": self.rows,
                "top1_agreement": self.top1_agreement,
                "logit_rmse": self.logit_rmse}


class RolloutController:
    """Shadow -> canary -> atomic cutover -> (maybe) rollback.

    >>> ctl = RolloutController(engine, registry, ckpt_dir,
    ...                         telemetry=tel, health_sources=[slo.health_status])
    >>> ctl.baseline()              # the engine's boot weights = v1, live
    >>> ctl.serve_loop(stop_event)  # poll, stage, expose, promote

    Stage semantics (each emits a durable ``kind: "deploy"`` event):

    - ``registered``: the candidate snapshot passed verified-intact
      resolution and the structure check, and its weights are STAGED
      beside the serving ones.  A
      candidate that fails here is rejected before anything staged.
    - ``shadow``: ``shadow_fraction`` of live ticks is mirrored (batch
      + live outputs) to the controller, which evaluates the candidate
      OFF the request path and accumulates top-1 agreement + logit
      RMSE until ``shadow_min_rows`` real rows compared (or
      ``stage_timeout_s``).  Below ``min_top1_agreement`` / above
      ``max_logit_rmse`` -> rejected; a timeout with too little
      traffic -> rejected (an unverified candidate never advances).
    - ``canary``: ``canary_fraction`` of ticks SERVES on the candidate
      (tick events carry ``canary_version`` -- the per-version SLO
      cut).  Rejection triggers: a crashing candidate tick, a
      non-``ok`` health source (SLO burn / watchdog anomaly), or a
      failing ``accuracy_gate`` (live-vs-candidate on the held-out
      batch).
    - ``cutover`` / ``live``: ``ServingEngine.commit_staged`` -- the
      weights copied in place under the steps' locks, so a tick sees
      old or new, never a mix -- then the registry promotes durably.  The
      previous version's staged buffers stay retained.
    - ``rollback``: within ``post_cutover_watch_s`` after a cutover, a
      non-``ok`` health source rolls back to the retained previous
      version (pointer swap, no re-quantize/re-stage).  ``rollback()``
      may also be called directly (the operator's big red button).

    ``health_sources``: callables returning ``{"status": ...}``
    (the JAX package's ``SloTracker.health_status``; the port's metrics
    wait for ROADMAP A8), consulted at canary and in the
    post-cutover watch.  ``clock``/``sleep`` are injectable so tests
    drive stage windows without real waiting.  ``chaos`` is the fault
    hook of the drill: called as ``chaos(stage, version)`` mid-cutover
    (device buffers swapped, registry NOT yet committed -- the
    sharpest point to die at).
    """

    def __init__(self, engine, registry, checkpoint_dir=None,
                 telemetry=None, shadow_fraction=0.5, shadow_min_rows=32,
                 min_top1_agreement=0.98, max_logit_rmse=None,
                 canary_fraction=0.25, canary_min_ticks=4,
                 accuracy_gate=None, health_sources=(),
                 stage_timeout_s=60.0, post_cutover_watch_s=0.0,
                 reject_cooldown_s=300.0, drain_timeout_s=10.0,
                 replica_gate=None,
                 clock=time.monotonic, sleep=time.sleep, chaos=None):
        from bigdl_tpu_torch.optim.validation import AccuracyDeltaGate

        self.engine = engine
        # fleet mode (serving/fleet.py): shadow/canary run on the
        # fleet's exposure replica, and the cutover becomes a ROLLING
        # deploy -- drain one replica, per-replica gate, commit,
        # undrain, proceed -- so the fleet never has zero serving
        # capacity and a failing gate rolls back only the replicas
        # already touched.  ``replica_gate(rid, fleet, handle) ->
        # (ok, reason)`` overrides the fleet's default probe gate.
        self._fleet = bool(getattr(engine, "is_fleet", False))
        self.drain_timeout_s = float(drain_timeout_s)
        self.replica_gate = replica_gate
        self.registry = registry
        self.checkpoint_dir = checkpoint_dir
        self.telemetry = telemetry
        self.shadow_fraction = float(shadow_fraction)
        self.shadow_min_rows = int(shadow_min_rows)
        self.min_top1_agreement = min_top1_agreement
        self.max_logit_rmse = max_logit_rmse
        self.canary_fraction = float(canary_fraction)
        self.canary_min_ticks = int(canary_min_ticks)
        if isinstance(accuracy_gate, dict):
            accuracy_gate = AccuracyDeltaGate(**accuracy_gate)
        self.accuracy_gate = accuracy_gate
        self.health_sources = list(health_sources)
        self.stage_timeout_s = float(stage_timeout_s)
        self.post_cutover_watch_s = float(post_cutover_watch_s)
        self.reject_cooldown_s = float(reject_cooldown_s)
        self.clock = clock
        self.sleep = sleep
        self.chaos = chaos
        self.events = []           # deploy events emitted this run
        # snapshots we never re-walk (served or still in flight); a
        # REJECTED snapshot instead gets a retry cooldown -- a
        # transient rejection (a momentary SLO burn, a traffic-quiet
        # shadow window) must not permanently discard the trainer's
        # newest checkpoint (in this process or after a restart)
        self._seen = set()
        self._rejected_until = {}
        for v in registry.versions:
            key = v.digest if v.digest else v.path
            if key is None:
                continue
            if v.stage == "rejected":
                self._rejected_until[key] = \
                    self.clock() + self.reject_cooldown_s
            else:
                self._seen.add(key)
        self._digest_cache = {}    # path -> (manifest stat, digest)
        self._watch_until = None   # post-cutover rollback window end

    # ----- deploy events ------------------------------------------------------ #
    def _emit(self, version, stage, verdict, reason=None, **stats):
        event = {"version": version.version, "stage": stage,
                 "verdict": verdict, "digest": version.digest,
                 "path": version.path}
        if reason is not None:
            event["reason"] = str(reason)[:300]
        for k, v in stats.items():
            if v is not None:
                event[k] = v
        self.events.append(event)
        if self.telemetry is not None:
            try:
                self.telemetry.record("deploy", **event)
            except Exception:
                log.exception("deploy telemetry record failed")
        log.info("deploy v%d %s: %s%s", version.version, stage, verdict,
                 f" ({reason})" if reason else "")
        return event

    # ----- bootstrap / resume -------------------------------------------------- #
    def baseline(self, path=None, digest=None):
        """Register the engine's CURRENT weights as the first live
        version (the boot state a first rollback would return to)."""
        handle = self.engine.capture_staged()
        v = self.registry.register(handle, path=path, digest=digest)
        self.registry.promote(v.version)
        self.engine.set_serving_version(v.version, v.digest)
        self._emit(v, "live", "ok", reason="baseline")
        return v

    def resume(self):
        """The restart path: re-serve the persisted registry's live
        version bit-for-bit from its verified snapshot.  An interrupted
        cutover (SIGKILL between the device swap and the registry
        commit) leaves the registry pointing at the PREVIOUS version --
        so that is what comes back, exactly as the chaos drill demands.
        Returns the live ModelVersion, or None (empty registry)."""
        live = self.registry.live
        if live is None:
            return None
        if live.path is None:
            # the baseline version (boot weights, no snapshot): the
            # restarted process rebuilt the same deterministic init --
            # re-capture it so a later cutover retains a rollback target
            live.handle = self.engine.capture_staged()
            self.engine.set_serving_version(live.version, live.digest)
            self._emit(live, "resume", "ok",
                       reason="baseline weights (no snapshot recorded)")
            return live
        params, mstate, src = self._load(live.path)
        digest = snapshot_digest(live.path)
        if live.digest is not None and digest != live.digest:
            raise RuntimeError(
                f"snapshot {live.path} no longer matches registry live "
                f"version v{live.version} (digest {digest} != "
                f"{live.digest}); refusing to serve an imposter")
        live.handle = self.engine.stage_weights(
            params, mstate, src_layout=src,
            **({"path": live.path} if self._fleet else {}))
        self.engine.commit_staged(live.handle, version=live.version,
                                  digest=live.digest)
        self._emit(live, "resume", "ok")
        return live

    # ----- the watcher ---------------------------------------------------------- #
    def poll_once(self):
        """One watch cycle: resolve the newest intact snapshot under
        ``checkpoint_dir`` (corrupt ones quarantined, exactly like
        training resume) and, when it is one we have not seen, walk it
        through the staged rollout.  Returns the resulting
        ModelVersion, or None when there is nothing new."""
        if self.checkpoint_dir is None \
                or not os.path.isdir(str(self.checkpoint_dir)):
            return None              # the trainer has not started yet
        from bigdl_tpu_torch.serving.engine import ServingEngine

        try:
            path = ServingEngine._resolve_snapshot(self.checkpoint_dir)
        except ValueError:
            return None              # nothing intact (yet)
        digest = self._digest_of(path)
        key = digest if digest is not None else str(path)
        if key in self._seen:
            return None
        until = self._rejected_until.get(key)
        if until is not None:
            if self.clock() < until:
                return None          # rejected; cooling down to retry
            del self._rejected_until[key]
        self._seen.add(key)
        v = self.run_candidate(path, digest=digest)
        if v is not None and v.stage == "rejected":
            # eligible again after the cooldown -- the audit trail
            # records every retry as a fresh version id
            self._seen.discard(key)
            self._rejected_until[key] = \
                self.clock() + self.reject_cooldown_s
        return v

    def _digest_of(self, path):
        """``snapshot_digest`` cached on the sidecar manifest's stat
        (size + mtime): the idle poll cycle must not re-read and
        re-hash the manifest every interval -- but a snapshot
        re-written at the same path (a from-scratch retrain) is
        noticed."""
        mpath = str(path).rstrip("/") + ".manifest.json"
        try:
            st = os.stat(mpath)
            stamp = (st.st_size, st.st_mtime_ns)
        except OSError:
            return snapshot_digest(path)     # manifest-less legacy
        cached = self._digest_cache.get(str(path))
        if cached is not None and cached[0] == stamp:
            return cached[1]
        digest = snapshot_digest(path)
        self._digest_cache[str(path)] = (stamp, digest)
        return digest

    def serve_loop(self, stop=None, poll_interval_s=0.25):
        """Poll -> rollout -> post-cutover watch, until ``stop`` (a
        ``threading.Event``) is set.  The loop that
        ``tools/torch_serve_live.py`` runs."""
        stop = stop or threading.Event()
        while not stop.is_set():
            self.poll_once()
            self.check_watch()
            self.sleep(poll_interval_s)
        return self

    # ----- the staged rollout --------------------------------------------------- #
    def _load(self, path):
        """``(params, mstate, src_layout)`` of a snapshot: its tree under
        the layout its manifest names and that layout (None: the tree is
        in the serving layout already, a data-parallel flat plane
        unravelled), for ``stage_weights(src_layout=)`` (JAX
        :635-641)."""
        from bigdl_tpu_torch.serving.engine import ServingEngine

        p = ServingEngine._resolve_snapshot(path)
        return self.engine._read_snapshot(p)

    def run_candidate(self, path, digest=None):
        """Walk one candidate snapshot through the full staged
        exposure; returns its (terminal-or-live) ModelVersion."""
        if digest is None:
            digest = snapshot_digest(path)
        try:
            params, mstate, src = self._load(path)
            handle = self.engine.stage_weights(
                params, mstate, src_layout=src,
                **({"path": path} if self._fleet else {}))
        except Exception as e:
            v = self.registry.register(
                None, path=path, digest=digest)
            self.registry.mark(v.version, "rejected")
            self._emit(v, "registered", "rejected", reason=e)
            return v
        v = self.registry.register(
            handle, path=path, digest=digest,
            layout=None if src is None else src.to_manifest(),
            weight_wire=getattr(self.engine, "weight_wire", None))
        self._emit(v, "registered", "ok",
                   model_bytes=handle.get("model_bytes"))

        ok, stats, reason = self._run_shadow(v, handle)
        self._emit(v, "shadow", "ok" if ok else "rejected",
                   reason=reason, **stats)
        if not ok:
            self._reject(v, handle)
            return v

        ok, stats, reason = self._run_canary(v, handle)
        self._emit(v, "canary", "ok" if ok else "rejected",
                   reason=reason, **stats)
        if not ok:
            self._reject(v, handle)
            return v

        return self._cutover(v, handle)

    def _reject(self, v, handle):
        if self._fleet:
            # drop the candidate's staged buffers fleet-wide (the
            # subprocess workers' token stores are bounded, not infinite)
            self.engine.release_staged(handle)
        self.registry.mark(v.version, "rejected")

    def _run_shadow(self, v, handle):
        """Mirror live traffic to the candidate off the request path;
        -> (ok, stats, reason)."""
        self.registry.mark(v.version, "shadow")
        stats = _ShadowStats()
        mirror = queue.Queue(maxsize=8)

        def observer(x, y, bucket, n, tick):
            try:                      # best-effort: drop when backed up
                mirror.put_nowait((x, y, n))
            except queue.Full:
                pass

        from bigdl_tpu_torch.optim.validation import AccuracyDeltaGate

        self.engine.set_shadow(observer, self.shadow_fraction)
        deadline = self.clock() + self.stage_timeout_s
        try:
            while stats.rows < self.shadow_min_rows:
                remaining = deadline - self.clock()
                if remaining <= 0:
                    return False, stats.summary(), (
                        f"shadow window timed out with {stats.rows}/"
                        f"{self.shadow_min_rows} rows compared -- an "
                        f"unverified candidate never advances")
                try:
                    x, y, n = mirror.get(timeout=min(remaining, 0.25))
                except queue.Empty:
                    continue
                cand = self.engine.eval_staged(handle, x)
                live_l = AccuracyDeltaGate._logits(y)[:n]
                cand_l = AccuracyDeltaGate._logits(cand)[:n]
                stats.add(live_l, cand_l)
        finally:
            self.engine.set_shadow(None)
        agree = stats.top1_agreement
        if self.min_top1_agreement is not None \
                and agree is not None and agree < self.min_top1_agreement:
            return False, stats.summary(), (
                f"shadow top-1 agreement {agree:.4f} < required "
                f"{self.min_top1_agreement} over {stats.rows} mirrored "
                f"rows")
        rmse = stats.logit_rmse
        if self.max_logit_rmse is not None \
                and rmse is not None and rmse > self.max_logit_rmse:
            return False, stats.summary(), (
                f"shadow logit RMSE {rmse:.6g} > allowed "
                f"{self.max_logit_rmse}")
        return True, stats.summary(), None

    def _health(self):
        """Worst status across the health sources -> (status, reason)."""
        worst, why = "ok", None
        order = ("ok", "degraded", "halted")
        for src in self.health_sources:
            try:
                h = src()
            except Exception:
                log.exception("deploy health source %r failed", src)
                continue
            s = h.get("status", "ok")
            if s in order and order.index(s) > order.index(worst):
                worst = s
                reasons = h.get("reasons")
                why = reasons[0].get("reason") if reasons else s
        return worst, why

    def _run_canary(self, v, handle):
        """Serve a traffic fraction on the candidate; -> (ok, stats,
        reason)."""
        self.registry.mark(v.version, "canary")
        self.engine.set_canary(handle, self.canary_fraction,
                               version=v.version)
        deadline = self.clock() + self.stage_timeout_s
        try:
            while True:
                cs = self.engine.canary_stats()
                if cs["failures"]:
                    return False, cs, (
                        f"candidate tick(s) raised during canary "
                        f"({cs['failures']} failure(s))")
                status, why = self._health()
                if status != "ok":
                    return False, cs, (
                        f"health went {status} during canary ({why})")
                if cs["ticks"] >= self.canary_min_ticks:
                    break
                if self.clock() >= deadline:
                    return False, cs, (
                        f"canary window timed out with {cs['ticks']}/"
                        f"{self.canary_min_ticks} candidate ticks -- an "
                        f"unverified candidate never advances")
                self.sleep(0.02)
        finally:
            stats = self.engine.canary_stats()
            self.engine.set_canary(None)
        if self.accuracy_gate is not None:
            live = self.registry.live
            if live is not None and live.handle is not None:
                ok, detail = self.accuracy_gate.check(
                    self._bound_eval(live.handle),
                    self._bound_eval(handle))
                stats = {**stats, "accuracy_gate": detail}
                if not ok:
                    return False, stats, (
                        "accuracy gate: " + detail.get("reason", "failed"))
        return True, stats, None

    def _bound_eval(self, handle):
        """``x -> logits`` over a staged handle, bucket-padded so the
        gate eval reuses precompiled executables (never compiles on
        the request path)."""
        from bigdl_tpu_torch.serving.buckets import pad_batch_axis
        from bigdl_tpu_torch.serving.worker import _host, tree_leaves

        def run(x):
            x = _host(x)
            n = tree_leaves(x)[0].shape[0]
            bucket = self.engine.ladder.bucket_for(n)
            xb = x if bucket is None or bucket == n \
                else pad_batch_axis(x, bucket)
            y = self.engine.eval_staged(handle, xb)
            return _host_rows(y, n)
        return run

    def _cutover(self, v, handle):
        """The atomic promotion: deploy event -> ONE pointer swap on
        the engine -> chaos hook (the drill dies HERE: buffers swapped,
        registry not yet committed -- a restart must still resolve the
        previous version) -> durable registry commit -> live event.
        On a fleet this becomes the ROLLING deploy instead."""
        if self._fleet:
            return self._rolling_cutover(v, handle)
        self._emit(v, "cutover", "ok")
        self.engine.commit_staged(handle, version=v.version,
                                  digest=v.digest)
        if self.chaos is not None:
            self.chaos("cutover", v)
        self.registry.promote(v.version)
        self._emit(v, "live", "ok")
        if self.post_cutover_watch_s > 0:
            self._watch_until = self.clock() + self.post_cutover_watch_s
        return v

    def _replica_gate(self, rid, handle):
        if self.replica_gate is not None:
            return self.replica_gate(rid, self.engine, handle)
        return self.engine.gate_replica(rid, handle)

    def _rolling_cutover(self, v, handle):
        """Fleet mode's cutover: replica-by-replica drain -> gate ->
        commit -> undrain, so the fleet never has zero serving capacity
        and the UNTOUCHED replicas keep serving the old version
        mid-roll.  A failing per-replica gate rolls back ONLY the
        replicas already cut over (pointer swaps to the pre-roll
        capture) and rejects the candidate; a replica that died
        mid-roll is skipped (the supervisor restarts it from the
        registry, which will then name the promoted version).

        The chaos hook fires after each per-replica commit with the
        registry still uncommitted -- the fleet drill's sharpest
        point."""
        fleet = self.engine
        live = self.registry.live
        prev = fleet.capture_staged()
        prev_per = prev.get("per_replica") or {}
        per = handle.get("per_replica") or {}
        touched = []

        def roll_back(reason):
            for rid in reversed(touched):
                try:
                    prev_h = prev_per.get(rid)
                    if prev_h is not None:
                        fleet.commit_replica(
                            rid, prev_h,
                            version=live.version if live else None,
                            digest=live.digest if live else None)
                    elif live is not None and live.path is not None:
                        # no pre-roll capture (the replica restarted
                        # mid-roll and was caught up onto the now-
                        # rejected candidate): restore from the live
                        # version's snapshot instead of stranding it
                        rep = fleet._by_id(rid)
                        fresh = rep.stage(path=live.path)
                        rep.commit(fresh, version=live.version,
                                   digest=live.digest)
                    else:
                        log.warning(
                            "rollback: no pre-roll capture for replica "
                            "%s and the live version has no snapshot; "
                            "its next restart reconciles it", rid)
                except Exception:
                    log.exception("rolling rollback of replica %s "
                                  "failed", rid)
            fleet.release_staged(handle)
            self.registry.mark(v.version, "rejected")
            self._emit(v, "rollback", "rolled_back", reason=reason,
                       rolled_back_to=live.version if live else None,
                       replicas=list(touched))

        for rid in sorted(per):
            rep = fleet._by_id(rid)
            if rep.state in ("dead", "closed"):
                # it missed the roll; boot-from-registry catches it up
                self._emit(v, "cutover", "ok", replica=rid,
                           reason="replica dead mid-roll; will boot "
                                  "from the registry's committed "
                                  "version")
                continue
            try:
                drained = fleet.drain_replica(
                    rid, timeout=self.drain_timeout_s)
                ok, reason = self._replica_gate(rid, handle)
            except Exception as e:
                ok, drained, reason = False, False, f"replica gate " \
                    f"raised: {e}"
            if not ok:
                # a replica that DIED here (vs. one whose gate judged
                # the candidate bad) is not the candidate's fault --
                # skip it like the commit path does, don't reject the
                # rollout fleet-wide
                alive = True
                try:
                    alive = rep.alive()
                except Exception:
                    alive = False
                if not alive:
                    fleet.mark_dead(rep,
                                    reason=f"died mid-drain/gate: "
                                           f"{reason}")
                    self._emit(v, "cutover", "ok", replica=rid,
                               reason="replica died mid-drain/gate; "
                                      "will boot from the registry")
                    continue
                try:
                    fleet.undrain_replica(rid)
                except Exception:
                    log.exception("undrain of replica %s failed", rid)
                self._emit(v, "cutover", "rejected", replica=rid,
                           reason=f"per-replica gate: {reason}")
                roll_back(f"per-replica gate failed on replica {rid} "
                          f"({reason}); {len(touched)} touched "
                          f"replica(s) rolled back, the rest never "
                          f"left the old version")
                return v
            try:
                fleet.commit_replica(rid, per[rid], version=v.version,
                                     digest=v.digest)
            except Exception as e:
                if not rep.alive():
                    # the process died under us: not the candidate's
                    # fault -- skip it, keep rolling
                    fleet.mark_dead(rep, reason=f"died mid-cutover: {e}")
                    self._emit(v, "cutover", "ok", replica=rid,
                               reason="replica died mid-commit; will "
                                      "boot from the registry")
                    continue
                # a worker RESTARTED between staging and this commit
                # lost its staged token: catch it up from the snapshot
                # path (one extra stage, off the request path) before
                # giving up on the whole candidate
                caught_up = False
                if v.path is not None:
                    try:
                        fresh = rep.stage(path=v.path)
                        fleet.commit_replica(rid, fresh,
                                             version=v.version,
                                             digest=v.digest)
                        per[rid] = fresh
                        caught_up = True
                    except Exception:
                        log.exception("catch-up re-stage of replica %s "
                                      "failed", rid)
                if not caught_up:
                    try:
                        fleet.undrain_replica(rid)
                    except Exception:
                        pass
                    self._emit(v, "cutover", "rejected", replica=rid,
                               reason=f"commit failed: {e}")
                    roll_back(f"commit failed on replica {rid} ({e})")
                    return v
            if self.chaos is not None:
                self.chaos("cutover", v)
            try:
                fleet.undrain_replica(rid)
            except Exception as e:
                # died between commit and undrain: the commit landed --
                # mark dead and keep rolling (a restart boots from the
                # registry, the post-promote reconcile catches an early
                # rebirth)
                log.exception("undrain of replica %s failed", rid)
                if not rep.alive():
                    fleet.mark_dead(rep,
                                    reason=f"died mid-undrain: {e}")
            self._emit(v, "cutover", "ok", replica=rid,
                       drained=drained)
            touched.append(rid)
        if not touched:
            self.registry.mark(v.version, "rejected")
            self._emit(v, "cutover", "rejected",
                       reason="no live replica accepted the candidate")
            return v
        self.registry.promote(v.version)
        # reconcile replicas that missed the roll: one that died
        # mid-roll and was RESTARTED by the supervisor before this
        # promote landed booted the registry's OLD version and would
        # silently serve it forever -- catch any such stragglers up
        # from the promoted snapshot (idempotent on a replica that
        # already booted the new version)
        if v.path is not None:
            for rid in fleet.replica_ids():
                rep = fleet._by_id(rid)
                if rid in touched or rep.state != "serving":
                    continue
                try:
                    fresh = rep.stage(path=v.path)
                    rep.commit(fresh, version=v.version,
                               digest=v.digest)
                    self._emit(v, "cutover", "ok", replica=rid,
                               reason="post-promote catch-up (replica "
                                      "missed the roll)")
                    touched.append(rid)
                except Exception:
                    log.exception("post-promote catch-up of replica %s "
                                  "failed (its next restart boots the "
                                  "promoted version)", rid)
        self._emit(v, "live", "ok", replicas=touched)
        if self.post_cutover_watch_s > 0:
            self._watch_until = self.clock() + self.post_cutover_watch_s
        return v

    # ----- rollback -------------------------------------------------------------- #
    def check_watch(self):
        """Inside the post-cutover watch window, a non-``ok`` health
        source (burning SLO, watchdog anomaly) triggers automatic
        rollback to the retained previous version.  No-op outside the
        window.  Returns the rolled-back-to version, or None."""
        if self._watch_until is None:
            return None
        if self.clock() >= self._watch_until:
            self._watch_until = None
            return None
        status, why = self._health()
        if status == "ok":
            return None
        self._watch_until = None
        return self.rollback(f"health went {status} inside the "
                             f"post-cutover watch window ({why})")

    def rollback(self, reason=None):
        """Pointer-swap back to the retained previous version: commit
        its STAGED handle (no re-quantize, no re-stage), swap the
        registry pointers durably, emit the durable rollback event.
        Returns the now-live (previous) version."""
        prev = self.registry.previous
        if prev is None or prev.handle is None:
            raise RuntimeError(
                "rollback without a retained previous version"
                + ("" if prev is None else
                   f" (v{prev.version} kept no staged buffers -- "
                   f"was this process restarted since the cutover?)"))
        self.engine.commit_staged(prev.handle, version=prev.version,
                                  digest=prev.digest)
        now_live, rolled = self.registry.rollback()
        self._emit(rolled if rolled is not None else now_live,
                   "rollback", "rolled_back", reason=reason,
                   rolled_back_to=now_live.version)
        return now_live
