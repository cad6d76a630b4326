"""The port's native batch assembler and prefetcher
(``bigdl_tpu_torch/dataset/native_loader.py``) against numpy and against
the JAX package's ``bigdl_tpu/dataset/native_loader.py`` on the same
inputs (JAX's ``tests/test_native_loader.py``), on the CPU.

The assembler is ``native/batch_assembler.cpp``, compiled by the port
with ``g++`` into its own build directory: gathers and labels are held
exactly against numpy and against JAX's batcher; the normalisation to
1e-6 relative against numpy (the C++ loop divides in float32, numpy
broadcasts the same operations) and exactly against JAX's build of the
same source.
"""

import time

import numpy as np
import pytest

from bigdl_tpu.dataset import native_loader as jnl
from bigdl_tpu_torch.dataset import native_loader as tnl


def test_the_port_builds_its_own_library():
    lib = tnl._build_and_load()
    assert lib is not None, "g++ build failed"
    path = getattr(lib, "_name", "")
    assert str(tnl.native_dir()) in path and "bigdl_tpu_torch_native" in path
    assert tnl.build_native_lib("batch_assembler")._name == path


def test_gather_matches_numpy_and_jax():
    rng = np.random.default_rng(0)
    feats = rng.random((50, 12, 12, 3), dtype=np.float32)
    labels = rng.integers(0, 10, 50).astype(np.int32)
    mean = np.array([0.4, 0.5, 0.6], np.float32)
    std = np.array([0.2, 0.3, 0.4], np.float32)
    idx = np.array([3, 17, 42, 0, 7, 7], np.int64)
    b = tnl.NativeBatcher(feats, labels, mean, std, n_threads=4)
    assert b.lib is not None
    x, y = b.batch(idx)
    np.testing.assert_allclose(x, (feats[idx] - mean) / std, rtol=1e-6)
    np.testing.assert_array_equal(y, labels[idx])
    jx, jy = jnl.NativeBatcher(feats, labels, mean, std,
                               n_threads=4).batch(idx)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)


def test_no_normalize_plain_copy():
    feats = np.random.default_rng(1).random((10, 5), dtype=np.float32)
    x, y = tnl.NativeBatcher(feats, None).batch(np.array([1, 2], np.int64))
    np.testing.assert_array_equal(x, feats[[1, 2]])
    assert y is None


def test_large_parallel():
    rng = np.random.default_rng(2)
    feats = rng.random((512, 28, 28), dtype=np.float32)
    labels = np.arange(512).astype(np.int32)
    idx = rng.permutation(512)[:256].astype(np.int64)
    x, y = tnl.NativeBatcher(feats, labels, n_threads=8).batch(idx)
    np.testing.assert_array_equal(x, feats[idx])
    np.testing.assert_array_equal(y, labels[idx])


def test_numpy_fallback_when_no_compiler(monkeypatch, caplog):
    """No toolchain: the batcher logs and falls back to numpy, as JAX's
    does, with the same results."""
    monkeypatch.setattr(tnl, "_LIB", None)
    monkeypatch.setattr(tnl, "_TRIED", False)

    def no_gxx(name):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(tnl, "build_native_lib", no_gxx)
    rng = np.random.default_rng(3)
    feats = rng.random((20, 4, 4, 2), dtype=np.float32)
    labels = np.arange(20).astype(np.int32)
    with caplog.at_level("WARNING", logger="bigdl_tpu_torch.dataset"):
        b = tnl.NativeBatcher(feats, labels, [0.5, 0.25], [2.0, 4.0])
    assert b.lib is None and "numpy fallback" in caplog.text
    idx = np.array([4, 1, 19], np.int64)
    x, y = b.batch(idx)
    np.testing.assert_allclose(
        x, (feats[idx] - np.float32([0.5, 0.25])) / np.float32([2.0, 4.0]),
        rtol=1e-6)
    np.testing.assert_array_equal(y, labels[idx])


def test_prefetcher_keeps_order():
    assert list(tnl.prefetch(iter(range(20)), depth=3)) == list(range(20))


def test_prefetcher_overlaps_a_slow_consumer():
    def producer():
        for i in range(5):
            time.sleep(0.01)
            yield i

    t0 = time.perf_counter()
    out = []
    for item in tnl.prefetch(producer(), depth=4):
        time.sleep(0.01)              # consumer work overlaps the producer's
        out.append(item)
    assert out == list(range(5))
    assert time.perf_counter() - t0 < 0.15
