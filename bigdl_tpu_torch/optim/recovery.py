"""The auto-restart loop: supervised training that survives a killed
process (the port's copy of ``bigdl_tpu/optim/recovery.py``).

``RunSupervisor`` launches a training run, and on an in-process
exception, a watchdog halt or the death of a child process (SIGKILL
included) restarts it from the newest intact snapshot (verified:
corrupt ones are quarantined on the way), under capped exponential
backoff and a restart budget.  Every restart is recorded as a recovery
event (cause, snapshot, steps replayed, backoff) in ``events`` and, with
a ``telemetry`` object, through its ``record``.  ``ChaosKillTrigger``
SIGKILLs the process at a chosen step, the harshest preemption, at a
reproducible point.

Whole-model checkpoints only (``set_checkpoint``, ``utils/file_io.py``):
the sharded snapshots of the distributed layouts are refused, naming
ROADMAP A4.  No device work here: a supervising process needs no card.
"""

import logging
import os
import signal
import time

from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.utils import file_io
from bigdl_tpu_torch.utils.errors import (CheckpointCorruptionError,
                                          ConfigurationError,
                                          TrainingHaltedError,
                                          UnsupportedFeatureError)

log = logging.getLogger("bigdl_tpu_torch.optim")

_SHARDED = ("sharded (orbax) snapshots belong to the distributed layouts, "
            "not ported yet (ROADMAP A4)")

#: restart causes a recovery event may carry
RECOVERY_CAUSES = ("exception", "watchdog_halt", "process_death")

#: keys every ``kind: "recovery"`` telemetry event carries
RECOVERY_EVENT_KEYS = ("restart", "cause", "error", "at_step", "snapshot",
                       "snapshot_step", "steps_replayed", "backoff_s")


def snapshot_step_of(path):
    """The driver-state step a snapshot file/dir resumes at:
    ``checkpoint.<tag>.pkl`` and ``snap_<tag>`` both tag with ``neval``
    at write time (= the next step to run).  None when unparseable."""
    if path is None:
        return None
    name = os.path.basename(str(path).rstrip("/"))
    for sep in (".", "_"):
        parts = name.split(sep)
        for p in parts[1:]:
            if p.isdigit():
                return int(p)
    return None


def parse_chaos(spec):
    """``--chaos kill:<step>`` -> ``("kill", step)``; None passes
    through.  Anything else is a configuration error (a typo'd chaos
    spec silently doing nothing would void the drill)."""
    if spec in (None, ""):
        return None
    parts = str(spec).split(":")
    if len(parts) == 2 and parts[0] == "kill" and parts[1].isdigit() \
            and int(parts[1]) >= 1:
        return ("kill", int(parts[1]))
    raise ConfigurationError(
        f"unknown chaos spec {spec!r}; expected kill:<step> (SIGKILL the "
        "training process the moment step <step> completes)")


def parse_restart_strategy(spec):
    """``--restartStrategy tp:<degree>`` -> ``("tp", degree)``; None
    passes through (the JAX CLI's flag: restarted attempts come up at
    another tensor-parallel degree; the port parses it, and its
    ``Optimizer(strategy="tp")`` resumes a checkpoint of another degree
    by redistributing it, ``parallel/reshard``).  A typo'd spec is a
    configuration error, not a silent same-layout restart."""
    if spec in (None, ""):
        return None
    parts = str(spec).split(":")
    if len(parts) == 2 and parts[0] == "tp" and parts[1].isdigit() \
            and int(parts[1]) >= 1:
        return ("tp", int(parts[1]))
    raise ConfigurationError(
        f"unknown restart strategy {spec!r}; expected tp:<degree> "
        "(restart the tp workload on that tensor-parallel degree; for "
        "dp device-count changes use --restartDevices)")


def capped_backoff(restarts, base_s, max_s, jitter=0.0, rng=None):
    """``min(max_s, base_s * 2**restarts)``, optionally jittered by a
    uniform factor in ``[1 - jitter, 1 + jitter]``.

    The jitter is applied AFTER the cap on purpose: N replicas killed
    by one event (a host reboot, a preemption sweep) otherwise restart
    in lockstep at exactly the capped backoff -- a thundering herd
    hitting the same checkpoint dir / registry file on every retry
    round.  ``rng`` is injectable (``random.Random(seed)``) so drills
    and tests are deterministic; None uses the module-level
    ``random``."""
    if not 0.0 <= float(jitter) <= 1.0:
        raise ConfigurationError(
            f"backoff jitter must be a fraction in [0, 1], got {jitter}")
    b = min(float(max_s), float(base_s) * (2 ** max(0, int(restarts))))
    if jitter:
        import random as _random
        r = (rng or _random).random()
        b *= 1.0 + float(jitter) * (2.0 * r - 1.0)
    return b


class ChaosKillTrigger(Trigger):
    """Deterministic fault injection: SIGKILL this process the moment
    step ``kill_after_step`` COMPLETES (counters updated, the step's
    checkpoint/validation triggers already evaluated) -- the harshest
    preemption the supervisor must survive, at a reproducible point.

    Compose with the real end trigger::

        opt.set_end_when(Trigger.or_(ChaosKillTrigger(9),
                                     Trigger.max_iteration(24)))

    ``stateful = True`` keeps the driver loop's batch-staging guard from
    probing this with a PREDICTED driver state, which would kill one
    step early, mid-staging (see ``_stage_next_batch``).
    """

    stateful = True

    def __init__(self, kill_after_step, sig=signal.SIGKILL):
        self.kill_after = int(kill_after_step)
        self.sig = sig

    def __call__(self, state):
        if int(state.get("neval", 1)) > self.kill_after:
            log.warning("chaos: SIGKILL after step %d", self.kill_after)
            logging.shutdown()
            os.kill(os.getpid(), self.sig)
        return False


class RunSupervisor:
    """Launch -> watch -> restart-from-last-healthy-snapshot loop.

    Two modes share the budget/backoff/telemetry machinery:

    - ``run(factory)``: in-process.  ``factory(attempt)`` returns a
      fully configured optimizer; the supervisor resumes it from its
      checkpoint path (verified resolution: corrupt snapshots are
      quarantined on the way) and calls ``optimize()``.  A
      ``TrainingHaltedError`` (the health watchdogs' ``halt`` policy)
      restarts with cause ``watchdog_halt``; any other exception with
      cause ``exception``.  Deterministic configuration errors are
      re-raised immediately -- restarting replays them.
    - ``run_process(spawn)``: subprocess.  ``spawn(attempt)`` returns a
      started ``subprocess.Popen``; a nonzero exit (SIGKILL's -9
      included) restarts.  This is the mode that survives preemption.

    Each restart emits a durable ``kind: "recovery"`` telemetry event
    (cause, snapshot used, steps replayed, backoff) and sleeps
    ``min(backoff_max_s, backoff_base_s * 2**restarts)``, optionally
    de-synchronized by ``jitter`` (a uniform ``[1-j, 1+j]`` factor,
    ``rng`` injectable -- see ``capped_backoff`` for why a fleet needs
    this).  The budget is
    ``max_restarts``; additionally, two CONSECUTIVE failures with the
    identical (cause, step) signature stop the loop early -- that is a
    deterministic replay (e.g. a numerics blow-up the watchdogs halted),
    and burning the rest of the budget on it would also destroy the
    incident evidence window (``stop_on_repeat=False`` opts out, for
    genuinely flaky steps).
    """

    def __init__(self, max_restarts=3, backoff_base_s=0.5,
                 backoff_max_s=30.0, telemetry=None, stop_on_repeat=True,
                 sleep=time.sleep, jitter=0.0, rng=None):
        if int(max_restarts) < 0:
            raise ConfigurationError(
                f"max_restarts must be >= 0, got {max_restarts}")
        if not 0.0 <= float(jitter) <= 1.0:
            raise ConfigurationError(
                f"jitter must be a fraction in [0, 1], got {jitter}")
        self.max_restarts = int(max_restarts)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.jitter = float(jitter)
        self.rng = rng                # injectable (random.Random(seed))
        self.telemetry = telemetry
        self.stop_on_repeat = bool(stop_on_repeat)
        self._sleep = sleep
        self.restarts = 0
        self.events = []              # recovery events emitted this run

    def backoff_s(self, restarts):
        """Capped exponential backoff, de-synchronized by ``jitter``
        (``capped_backoff``): a fleet of supervisors restarted by one
        event must not hammer the shared checkpoint dir in lockstep."""
        return capped_backoff(restarts, self.backoff_base_s,
                              self.backoff_max_s, jitter=self.jitter,
                              rng=self.rng)

    # ----- event plumbing --------------------------------------------------- #
    def _emit(self, cause, error, at_step, snapshot, backoff_s):
        snap_step = snapshot_step_of(snapshot)
        event = {
            "restart": self.restarts,
            "cause": cause,
            "error": None if error is None else str(error)[:500],
            "at_step": at_step,
            "snapshot": None if snapshot is None else str(snapshot),
            "snapshot_step": snap_step,
            "steps_replayed": (max(0, int(at_step) - int(snap_step))
                               if at_step is not None
                               and snap_step is not None else None),
            "backoff_s": backoff_s,
        }
        self.events.append(event)
        if self.telemetry is not None:
            try:
                self.telemetry.record("recovery", **event)
            except Exception:   # the restart matters more than its log
                log.exception("recovery telemetry record failed")
        log.warning(
            "restart %d/%d (cause %s at step %s): resuming from %s "
            "after %.2fs backoff", self.restarts, self.max_restarts,
            cause, at_step, snapshot or "scratch", backoff_s)
        return event

    def _next_attempt(self, cause, error, at_step, snapshot):
        """Budget + repeated-failure bookkeeping shared by both modes;
        raises when the loop must stop, else sleeps the backoff."""
        sig = (cause, at_step)
        repeated = self.stop_on_repeat and \
            getattr(self, "_last_sig", None) == sig
        self._last_sig = sig
        if self.restarts >= self.max_restarts or repeated:
            why = ("identical failure twice in a row -- a deterministic "
                   "replay, not a transient" if repeated
                   else f"restart budget ({self.max_restarts}) exhausted")
            if isinstance(error, BaseException):
                raise RuntimeError(
                    f"supervised run gave up: {why} (cause {cause} at "
                    f"step {at_step})") from error
            raise RuntimeError(
                f"supervised run gave up: {why} (cause {cause} at step "
                f"{at_step}, exit {error})")
        backoff = self.backoff_s(self.restarts)
        self.restarts += 1
        self._emit(cause, error, at_step, snapshot, backoff)
        self._sleep(backoff)

    # ----- in-process mode -------------------------------------------------- #
    @staticmethod
    def _resume(opt):
        """Resume an optimizer from its checkpoint path (verified
        resolution)."""
        if getattr(opt, "sharded_checkpoint_path", None):
            raise UnsupportedFeatureError(_SHARDED)
        if getattr(opt, "checkpoint_path", None):
            opt.resume_from_checkpoint()

    @staticmethod
    def _latest_snapshot(opt):
        """The snapshot the NEXT attempt will resume from (verified;
        quarantines any corrupt tail the dead run left), or None."""
        if getattr(opt, "checkpoint_path", None):
            intact, _ = file_io.scan_checkpoints(opt.checkpoint_path)
            return intact[0] if intact else None
        return None

    def run(self, factory):
        """Supervise ``factory(attempt) -> optimizer`` until a run
        completes; returns the completing optimizer."""
        while True:
            opt = factory(self.restarts)
            self._resume(opt)
            try:
                opt.optimize()
                return opt
            except KeyboardInterrupt:
                raise
            except (ConfigurationError, UnsupportedFeatureError,
                    CheckpointCorruptionError):
                # deterministic config/corruption outcomes: a restart
                # replays the identical failure
                raise
            except TrainingHaltedError as e:
                cause, error = "watchdog_halt", e
            except Exception as e:
                cause, error = "exception", e
            at_step = int(opt.driver_state.get("neval", 0))
            self._next_attempt(cause, error, at_step,
                               self._latest_snapshot(opt))

    # ----- subprocess mode -------------------------------------------------- #
    def run_process(self, spawn, checkpoint_path=None, probe_step=None,
                    sharded=False):
        """Supervise ``spawn(attempt) -> subprocess.Popen`` until a
        child exits 0; returns the restart count.  ``checkpoint_path``
        (the children's snapshot dir) resolves the last healthy
        snapshot for the recovery event -- and quarantines any corrupt
        tail the dead writer left; ``probe_step()`` optionally reports
        the child's last completed step (e.g. from its telemetry
        JSONL)."""
        if sharded:
            raise UnsupportedFeatureError(_SHARDED)
        while True:
            proc = spawn(self.restarts)
            rc = proc.wait()
            if rc == 0:
                return self.restarts
            snapshot = None
            if checkpoint_path is not None:
                intact, _ = file_io.scan_checkpoints(checkpoint_path)
                snapshot = intact[0] if intact else None
            at_step = None
            if probe_step is not None:
                try:
                    at_step = probe_step()
                except Exception:
                    log.exception("probe_step failed; recovery event "
                                  "will lack at_step/steps_replayed")
            self._next_attempt("process_death", f"rc={rc}", at_step,
                               snapshot)


def last_step_in_telemetry(jsonl_path):
    """Last ``kind: "step"`` event's step in a telemetry JSONL, +1 (=
    the ``neval`` the run died at), or None.  Crash-tolerant: truncated
    tail lines are skipped -- this reads files of processes that were
    SIGKILLed mid-write."""
    import json

    last = None
    try:
        with open(jsonl_path, errors="replace") as f:
            for ln in f:
                try:
                    ev = json.loads(ln)
                except ValueError:
                    continue
                if ev.get("kind") == "step" and "step" in ev:
                    last = int(ev["step"])
    except OSError:
        return None
    return None if last is None else last + 1
