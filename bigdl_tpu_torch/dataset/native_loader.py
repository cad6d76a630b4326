"""Native batch assembly and a bounded prefetch queue (the port's copy of
``bigdl_tpu/dataset/native_loader.py``; host code, no device work).

Reference: MTLabeledBGRImgToBatch, the reference's multi-threaded batch
assembly.  Two pieces:

- ``NativeBatcher``: gathers and channel-normalises minibatches through
  the C++ assembler ``native/batch_assembler.cpp`` (the source the JAX
  package builds too, compiled here from its place in the repository),
  bound with ctypes.  The call releases the GIL, so assembly overlaps the
  training step.  Where no compiler is found it falls back to numpy, as
  the JAX package does, and logs that; ``NativeBatcher.lib`` is None
  then.
- ``Prefetcher``: a bounded background queue over any iterator.

``build_native_lib(name)`` compiles ``native/<name>.cpp`` with ``g++``
at first use into ``build/bigdl_tpu_torch_native/`` beside the package,
the library's name carrying a hash of the source and the flags; it
never loads the JAX package's build.
"""

import ctypes
import hashlib
import logging
import os
import queue
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

log = logging.getLogger("bigdl_tpu_torch.dataset")

_ROOT = Path(__file__).resolve().parent.parent.parent
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_LIB = None
_TRIED = False
_lock = threading.Lock()


def native_dir() -> Path:
    return _ROOT / "build" / "bigdl_tpu_torch_native"


def build_native_lib(name: str):
    """Compile (unless the library for this source exists) and load
    ``native/<name>.cpp``.  Raises when the compiler is missing or
    fails."""
    src = _ROOT / "native" / f"{name}.cpp"
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() +
                            src.read_bytes()).hexdigest()[:16]
    out = native_dir() / f"lib{name}_{digest}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        # compile to a private name, then rename: a concurrent build
        # never loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        try:
            subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(src),
                            "-lpthread"], check=True, capture_output=True)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(str(out))


def _build_and_load():
    global _LIB, _TRIED
    with _lock:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            lib = build_native_lib("batch_assembler")
            f32 = ctypes.POINTER(ctypes.c_float)
            i64 = ctypes.POINTER(ctypes.c_int64)
            i32 = ctypes.POINTER(ctypes.c_int32)
            lib.bigdl_gather_normalize.argtypes = [
                f32, i64, ctypes.c_int64, ctypes.c_int64, f32, f32,
                ctypes.c_int, f32, ctypes.c_int]
            lib.bigdl_gather_normalize.restype = None
            lib.bigdl_gather_labels.argtypes = [
                i32, i64, ctypes.c_int64, ctypes.c_int64, i32]
            lib.bigdl_gather_labels.restype = None
            _LIB = lib
        except Exception as e:       # no toolchain: the numpy fallback
            log.warning("native batch assembler unavailable (%s); numpy "
                        "fallback", e)
            _LIB = None
        return _LIB


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


class NativeBatcher:
    """Index-gather and normalise minibatches from a contiguous pool.

    ``features``: ``(N, ...)`` float32; ``labels``: ``(N, ...)`` int32 or
    None; ``mean`` / ``std``: per channel (the last axis), or None for a
    plain gather."""

    def __init__(self, features: np.ndarray, labels: Optional[np.ndarray],
                 mean=None, std=None, n_threads: int = 0):
        self.features = np.ascontiguousarray(features, np.float32)
        self.pool = self.features.reshape(len(features), -1)
        self.sample_shape = features.shape[1:]
        self.labels = (None if labels is None
                       else np.ascontiguousarray(labels, np.int32).reshape(
                           len(labels), -1))
        self.label_shape = () if labels is None else np.shape(labels)[1:]
        self.channels = 0
        self.mean = np.zeros(1, np.float32)
        self.std = np.ones(1, np.float32)
        if mean is not None:
            self.mean = np.ascontiguousarray(mean, np.float32)
            self.std = np.ascontiguousarray(std, np.float32)
            self.channels = self.mean.size
        self.n_threads = n_threads or min(8, os.cpu_count() or 1)
        self.lib = _build_and_load()

    def batch(self, indices: np.ndarray):
        """``(x, labels)`` of the samples at ``indices``."""
        indices = np.ascontiguousarray(indices, np.int64)
        b = len(indices)
        out = np.empty((b, self.pool.shape[1]), np.float32)
        if self.lib is not None:
            self.lib.bigdl_gather_normalize(
                _fptr(self.pool), _i64ptr(indices), b, self.pool.shape[1],
                _fptr(self.mean), _fptr(self.std), self.channels, _fptr(out),
                self.n_threads)
        else:
            out[:] = self.pool[indices]
            if self.channels:
                shaped = out.reshape((b,) + self.sample_shape)
                shaped -= self.mean
                shaped /= self.std
        x = out.reshape((b,) + self.sample_shape)
        if self.labels is None:
            return x, None
        lab = np.empty((b, self.labels.shape[1]), np.int32)
        if self.lib is not None:
            self.lib.bigdl_gather_labels(
                self.labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                _i64ptr(indices), b, self.labels.shape[1],
                lab.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        else:
            lab[:] = self.labels[indices]
        return x, lab.reshape((b,) + self.label_shape)


class Prefetcher:
    """A bounded background queue over any iterator (the double-buffered
    feed; reference: MTLabeledBGRImgToBatch's producer threads)."""

    _DONE = object()

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._run, args=(it,),
                                        daemon=True)
        self._thread.start()

    def _run(self, it):
        try:
            for item in it:
                self.q.put(item)
        finally:
            self.q.put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is self._DONE:
            raise StopIteration
        return item


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    return Prefetcher(iterator, depth)
