"""Device-memory ledger: who owns the bytes, and how many are left (the
port's copy of ``bigdl_tpu/observability/memory.py``).

- ``MemoryLedger``: registered subsystems (``register(name, source)``)
  each report their live bytes; ``snapshot()`` reconciles the attributed
  total with the allocator's own numbers (``device_memory_stats``), so a
  leak shows as a growing ``residual_bytes`` instead of an eventual
  out-of-memory error.  Without allocator statistics (the CPU) the
  live / residual side is None and the attribution still works.
- ``record()``: one ``kind: "memory"`` event on the attached telemetry.
- ``dump(reason, ...)``: exactly one ``kind: "memory_dump"`` event with
  the full ledger, the subsystems' detail and the last serving ticks,
  the record a post-mortem reads after an allocation failure
  (``ServingEngine`` wires ``BlockPoolExhausted`` into it).

A source is a callable returning an int byte count or a dict with a
``"bytes"`` key plus free-form detail (the KV pool reports its
active / prefix-cached / free block split that way).  A source that
raises gives an ``{"error": ...}`` row instead of failing the snapshot.
The telemetry is duck-typed: ``record(kind, **fields)``, and
``add_observer(fn)`` where it has one (the tick ring).
"""

import logging
import math
import threading
import time
from collections import deque

import torch

log = logging.getLogger("bigdl_tpu_torch.observability")

#: event kinds kept in the forensic tick ring (``attach``)
_TICK_KINDS = frozenset({"step", "inference"})

#: substrings that mark an exception as an allocation failure (JAX's
#: RESOURCE_EXHAUSTED, the CUDA caching allocator's "out of memory", the
#: KV pool's exhaustion)
_OOM_MARKERS = ("resource_exhausted", "out of memory", "out_of_memory",
                "oom", "allocation failure", "failed to allocate",
                "blockpoolexhausted", "block pool exhausted")

#: per-device allocator rows kept in a snapshot's header
_HEADER_DEVICES = 8


def tree_bytes(tree):
    """Bytes of every tensor or array leaf of a nested dict / tuple /
    list (shape x item size; other leaves count 0)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    shape = getattr(tree, "shape", None)
    dtype = getattr(tree, "dtype", None)
    if shape is None or dtype is None:
        return 0
    return int(math.prod(shape)) * getattr(dtype, "itemsize", 0)


def is_oom_error(exc):
    """Whether an exception is an allocation failure: a
    ``torch.cuda.OutOfMemoryError``, or a message JAX's heuristic
    matches."""
    if exc is None:
        return False
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    text = f"{type(exc).__name__}: {exc}".lower()
    return any(m in text for m in _OOM_MARKERS)


def device_memory_stats():
    """``{"cuda:<i>": {"bytes_in_use", "peak_bytes_in_use",
    "bytes_limit"}}`` of every card this process allocated on (the
    caching allocator's allocated bytes, its peak, the card's total
    memory), or None without one (the CPU), as JAX gives None on backends
    without allocator statistics."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    out = {}
    for i in range(torch.cuda.device_count()):
        if not torch.cuda.memory_reserved(i):
            continue
        stats = torch.cuda.memory_stats(i)
        _free, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(total)}
    return out or None


class MemoryLedger:
    """Attributes live device bytes to named subsystems and reconciles
    the total with the allocator's numbers.

    >>> led = MemoryLedger()
    >>> led.register("params", lambda: tree_bytes(params))
    >>> led.register("kv_cache", scheduler_cache_source)
    >>> led.attach(telemetry)        # tick ring + event sink
    >>> led.record()                 # kind:"memory" event
    >>> led.dump("oom", error=exc)   # once: kind:"memory_dump"

    ``stats_fn`` defaults to ``device_memory_stats`` (None on the CPU);
    tests pass a fake to pin the reconciliation."""

    def __init__(self, stats_fn=None, telemetry=None, last_ticks=32):
        self._stats_fn = device_memory_stats if stats_fn is None \
            else stats_fn
        self._sources = {}
        self._lock = threading.RLock()
        self._ticks = deque(maxlen=int(last_ticks))
        self._dumped = False
        self.telemetry = None
        if telemetry is not None:
            self.attach(telemetry)

    # ----- subsystem registry ------------------------------------------- #
    def register(self, subsystem, source):
        """Register (or replace) a subsystem's byte source: a callable
        returning int bytes or a ``{"bytes": int, ...detail}`` dict, or a
        constant."""
        if not callable(source):
            value = source
            source = lambda: value  # noqa: E731 - constant source
        with self._lock:
            self._sources[str(subsystem)] = source
        return self

    def unregister(self, subsystem):
        with self._lock:
            self._sources.pop(str(subsystem), None)
        return self

    @property
    def subsystems(self):
        with self._lock:
            return tuple(self._sources)

    # ----- telemetry wiring --------------------------------------------- #
    def attach(self, telemetry):
        """Record memory events on ``telemetry``; its step and inference
        events feed the forensic tick ring where it takes observers."""
        self.telemetry = telemetry
        add = getattr(telemetry, "add_observer", None)
        if add is not None:
            add(self._observe)
        return self

    def _observe(self, event):
        if event.get("kind") in _TICK_KINDS:
            self.note_tick(event)

    def note_tick(self, event):
        """Keep the scalar fields of one serving tick or train step for
        the forensic ring."""
        self._ticks.append({k: v for k, v in event.items()
                            if isinstance(v, (int, float, str, bool))
                            or v is None})

    def last_ticks(self):
        return list(self._ticks)

    # ----- snapshots ----------------------------------------------------- #
    def subsystem_snapshot(self):
        """``{name: {"bytes": int | None, ...detail}}`` from every
        registered source; a failing source gives an error row."""
        with self._lock:
            sources = dict(self._sources)
        out = {}
        for name, source in sources.items():
            try:
                rec = source()
            except Exception as e:
                out[name] = {"bytes": None,
                             "error": f"{type(e).__name__}: {e}"}
                continue
            if isinstance(rec, dict):
                rec = dict(rec)
                if rec.get("bytes") is not None:
                    rec["bytes"] = int(rec["bytes"])
            else:
                rec = {"bytes": int(rec) if rec is not None else None}
            out[name] = rec
        return out

    def device_snapshot(self):
        """``(per-device allocator stats, device count)`` from
        ``stats_fn`` (at most ``_HEADER_DEVICES`` entries), or ``(None, 0)``
        where there are none."""
        try:
            stats = self._stats_fn()
        except Exception:
            return None, 0
        if not stats:
            return None, 0
        labels = sorted(stats)
        return {d: stats[d] for d in labels[:_HEADER_DEVICES]}, len(labels)

    def snapshot(self):
        """Subsystem attribution, the allocator's per-device numbers and
        the residual between them: ``attributed_bytes + residual_bytes
        == live_bytes`` wherever the allocator reports live bytes."""
        subsystems = self.subsystem_snapshot()
        attributed = sum(rec["bytes"] for rec in subsystems.values()
                         if rec.get("bytes"))
        devices, n_devices = self.device_snapshot()
        live = peak = limit = None
        if devices:
            live = sum(r.get("bytes_in_use", 0) for r in devices.values())
            peaks = [r["peak_bytes_in_use"] for r in devices.values()
                     if "peak_bytes_in_use" in r]
            peak = sum(peaks) if peaks else None
            limits = [r["bytes_limit"] for r in devices.values()
                      if "bytes_limit" in r]
            limit = sum(limits) if limits else None
        snap = {
            "subsystems": subsystems,
            "attributed_bytes": int(attributed),
            "devices": devices,
            "device_count": n_devices,
            "live_bytes": live,
            "peak_bytes": peak,
            "limit_bytes": limit,
            "residual_bytes": None if live is None else live - attributed,
            "headroom_bytes": limit - live
            if limit is not None and live is not None else None,
        }
        snap["headroom_fraction"] = round(
            snap["headroom_bytes"] / float(limit), 6) \
            if snap["headroom_bytes"] is not None and limit else None
        return snap

    # ----- event emission ------------------------------------------------ #
    def record(self, step=None, **extra):
        """One ``kind: "memory"`` event on the telemetry; returns it, or
        the bare snapshot without telemetry."""
        snap = self.snapshot()
        if step is not None:
            snap["step"] = step
        snap.update(extra)
        if self.telemetry is None:
            return snap
        return self.telemetry.record("memory", **snap)

    @property
    def dumped(self):
        """Whether the one-shot forensic dump fired."""
        return self._dumped

    def dump(self, reason, error=None, detail=None, force=False):
        """The forensic ``kind: "memory_dump"`` event: the ledger, the
        subsystems' detail and the last ticks.  Once, unless ``force``:
        every shed request re-raising the same exhaustion must not bury
        the first dump."""
        with self._lock:
            if self._dumped and not force:
                return None
            self._dumped = True
        event = {"reason": str(reason), "ledger": self.snapshot(),
                 "last_ticks": self.last_ticks()}
        if error is not None:
            event["error"] = f"{type(error).__name__}: {error}" \
                if isinstance(error, BaseException) else str(error)
        if detail:
            event["detail"] = detail
        log.error("memory_dump (%s): attributed=%s live=%s residual=%s",
                  reason, event["ledger"]["attributed_bytes"],
                  event["ledger"]["live_bytes"],
                  event["ledger"]["residual_bytes"])
        if self.telemetry is None:
            event["kind"] = "memory_dump"
            event["ts"] = time.time()
            return event
        return self.telemetry.record("memory_dump", **event)

    def handle_allocation_failure(self, exc, detail=None, reason=None):
        """The crash path's hook: dump once for the caught allocation
        error and return the dump (None on repeats)."""
        return self.dump(reason or type(exc).__name__, error=exc,
                         detail=detail)
