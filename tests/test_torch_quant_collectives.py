"""The data-parallel wire formats of the port
(``bigdl_tpu_torch/ops/quantization.py``: ``CompressionSpec``, stochastic
rounding, ``quantized_reduce_chunks``) and its collectives
(``parallel/collectives.py``) against the JAX package's, on the CPU.

- ``CompressionSpec``: every spelling of
  ``tests/test_quant_collectives.py:154-213`` (and torch's dtypes) parses
  to JAX's spec, the bad ones raise, and the wire summaries are JAX's.
- Nearest ``quantize_blockwise`` on flat-plane blocks is bitwise JAX's
  (payload and scales, a non-finite block included).
- Stochastic rounding: the same generator state gives the same payload,
  another gives another; the error stays within one stored scale and
  the mean over draws is closer to the input than nearest rounding
  (as :81-113).
- In spawned gloo worlds of 2 and 4 ranks (``tests/_torch_dist_worker.
  py``): every collective against numpy, ``PMean``'s gradient, and
  ``quantized_reduce_chunks`` against JAX's under ``shard_map`` on a
  mesh of the same size, within 1e-6 (an Inf element drops its block in
  both).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_dist_worker import spawn_world

from bigdl_tpu.ops import quantization as jq
from bigdl_tpu_torch.ops import quantization as tq

EF = dict(wire="int8", block_size=64, error_feedback=True)


def _fields(spec):
    return None if spec is None else (
        spec.wire, spec.block_size, spec.stochastic, spec.error_feedback,
        spec.scale_dtype, spec.compress_weight_gather)


@pytest.mark.parametrize("spelling", [
    None, jnp.bfloat16, jnp.float16, np.float16, np.dtype(np.float16),
    jnp.float32, "bf16", "bfloat16", "fp16", "float16", "int8", "INT8",
    "fp32", "half", "q8", "none",
    {"wire": "int8", "block_size": 128, "error_feedback": True},
    {"wire": "int8", "stochastic": True, "scale_dtype": "fp32",
     "compress_weight_gather": True}])
def test_spec_parses_as_jax(spelling):
    assert _fields(tq.CompressionSpec.parse(spelling)) == \
        _fields(jq.CompressionSpec.parse(spelling))


def test_spec_torch_dtypes_and_refusals():
    parse = tq.CompressionSpec.parse
    assert parse(torch.bfloat16).wire == "bf16"
    assert parse(torch.float16).wire == "fp16"
    assert parse(torch.float32) is None
    assert parse(tq.CompressionSpec(wire="fp32")) is None
    spec = tq.CompressionSpec(**EF)
    assert parse(spec) is spec
    assert spec.with_options(block_size=32).block_size == 32
    assert spec.quantized and spec.wire_dtype is None
    assert parse("bf16").wire_dtype is torch.bfloat16
    for bad, match in [
            (lambda: parse("int4"), "grad_compression"),
            (lambda: tq.CompressionSpec(wire="int4"), "wire"),
            (lambda: tq.CompressionSpec(wire="int8", block_size=0),
             "block_size"),
            (lambda: tq.CompressionSpec(wire="fp32", error_feedback=True),
             "error_feedback"),
            (lambda: tq.CompressionSpec(wire="bf16", error_feedback=True),
             "error_feedback"),
            (lambda: tq.CompressionSpec(wire="bf16",
                                        compress_weight_gather=True),
             "compress_weight_gather"),
            (lambda: tq.CompressionSpec(wire="int8", scale_dtype="fp16"),
             "scale_dtype")]:
        with pytest.raises(ValueError, match=match):
            bad()


@pytest.mark.parametrize("kw", [
    dict(wire="int8"), dict(wire="bf16"), dict(wire="fp16"),
    dict(wire="int8", scale_dtype="fp32", compress_weight_gather=True),
    dict(wire="int8", block_size=64)])
def test_wire_summary_as_jax(kw):
    n = 256 * 64
    t, j = tq.CompressionSpec(**kw), jq.CompressionSpec(**kw)
    assert t.wire_summary(n) == j.wire_summary(n)
    assert (t.scale_bytes, t.n_blocks(n)) == (j.scale_bytes, j.n_blocks(n))
    assert tq.uncompressed_wire_summary(n) == jq.uncompressed_wire_summary(n)


@pytest.mark.parametrize("scale_dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("block", [64, 256])
def test_nearest_quantize_bitwise_jax(scale_dtype, block):
    rng = np.random.default_rng(block)
    x = (rng.standard_normal(4 * block) * 3).astype(np.float32)
    x[7] = np.inf
    x[2 * block + 3] = np.nan
    jqv, jsv = jq.quantize_blockwise(jnp.asarray(x), block,
                                     scale_dtype=scale_dtype)
    tqv, tsv = tq.quantize_blockwise(torch.from_numpy(x), block,
                                     scale_dtype)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(tsv.float().numpy(),
                                  np.asarray(jsv, np.float32))
    np.testing.assert_array_equal(
        tq.dequantize_blockwise(tqv, tsv, block).numpy(),
        np.asarray(jq.dequantize_blockwise(jqv, jsv, block)))


def test_stochastic_rounding_deterministic_unbiased_bounded():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(512) * 3).astype(np.float32))
    gen = lambda s: torch.Generator().manual_seed(s)       # noqa: E731
    q1, s1 = tq.quantize_blockwise(x, 64, stochastic=True, rng=gen(7))
    q2, s2 = tq.quantize_blockwise(x, 64, stochastic=True, rng=gen(7))
    assert torch.equal(q1, q2) and torch.equal(s1, s2)
    q3, _ = tq.quantize_blockwise(x, 64, stochastic=True, rng=gen(8))
    assert not torch.equal(q1, q3)
    # a key tensor draws as the generator's key does
    key = torch.tensor(int(torch.randint(0, 2 ** 31, (), generator=gen(7))))
    assert torch.equal(tq.quantize_blockwise(x, 64, stochastic=True,
                                             rng=key)[0], q1)
    xs = x[:256]
    absmax = xs.abs().reshape(-1, 64).amax(1, keepdim=True)
    backs = []
    for i in range(40):
        q, s = tq.quantize_blockwise(xs, 64, stochastic=True, rng=gen(i))
        backs.append(tq.dequantize_blockwise(q, s, 64))
        err = (xs - backs[-1]).abs().reshape(-1, 64)
        assert bool((err <= absmax / 127.0 * 1.02 + 1e-9).all())
    mean_err = (torch.stack(backs).mean(0) - xs).abs().mean()
    q, s = tq.quantize_blockwise(xs, 64)
    nearest_err = (tq.dequantize_blockwise(q, s, 64) - xs).abs().mean()
    assert mean_err < nearest_err
    with pytest.raises(ValueError, match="rng"):
        tq.quantize_blockwise(xs, 64, stochastic=True)


def _jax_reduce(g, n):
    from jax.sharding import PartitionSpec as P

    from bigdl_tpu.utils.compat import shard_map

    spec = jq.CompressionSpec(**EF)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n]).reshape(n),
                             ("data",))

    def body(gl):
        chunk, err = jq.quantized_reduce_chunks(gl[0], n, "data", spec,
                                                jax.random.key(0))
        return chunk, err[None, :]

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"),),
                          out_specs=(P("data"), P("data")),
                          check_vma=False))
    chunk, err = f(jnp.asarray(g))
    return np.asarray(chunk), np.asarray(err)


def _jax_cast_reduce(g, n, wire):
    from jax.sharding import PartitionSpec as P

    from bigdl_tpu.utils.compat import shard_map

    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n]).reshape(n),
                             ("data",))
    dtype = jq.CompressionSpec.parse(wire).wire_dtype

    def body(gl):
        # the JAX step's cast wire (bigdl_tpu/optim/distri_optimizer.py)
        return jax.lax.psum_scatter(gl[0].astype(dtype), "data",
                                    tiled=True).astype(jnp.float32)

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"),),
                          out_specs=P("data"), check_vma=False))
    return np.asarray(f(jnp.asarray(g)))


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_and_quantized_reduce_in_gloo_worlds(tmp_path, n):
    rng = np.random.default_rng(n)
    g = rng.standard_normal((n, 64 * 4 * n)).astype(np.float32)
    # the cast wire's case: magnitudes over many binades
    gc = (rng.standard_normal((n, 64 * 4 * n))
          * np.exp2(rng.integers(-12, 12, (n, 64 * 4 * n)))
          ).astype(np.float32)
    g[1, 5] = np.inf                 # a non-finite element drops its block
    got = spawn_world(tmp_path, n, [
        dict(kind="collectives", name="coll"),
        dict(kind="reduce", name="reduce", grads=g, spec=EF),
        dict(kind="reduce", name="cast_bf16", grads=gc, spec="bf16"),
        dict(kind="reduce", name="cast_fp16", grads=gc / 64, spec="fp16")])
    xs = np.stack([np.arange(4 * n, dtype=np.float32) * (r + 1)
                   for r in range(n)])
    total = xs.sum(0)
    gathered = np.concatenate([np.arange(4) + 10 * r for r in range(n)])
    q = np.stack([(np.arange(2 * n) + 16 * r).reshape(n, 2)
                  for r in range(n)]).astype(np.int8)
    for r, res in enumerate(got["coll"]):
        assert res["backend"] == "gloo"
        np.testing.assert_array_equal(res["psum"], total)
        np.testing.assert_array_equal(res["psum_scatter"],
                                      total[4 * r:4 * (r + 1)])
        np.testing.assert_allclose(res["pmean"], total / n, rtol=1e-7)
        np.testing.assert_array_equal(res["all_gather"], gathered)
        np.testing.assert_array_equal(res["all_to_all"], q[:, r])
        mean = np.mean(np.arange(1, n + 1))
        np.testing.assert_allclose(res["pmean_fwd"], mean, rtol=1e-7)
        # d/dv_r of sum_s (s + 1) * pmean(v): the pmean of the ranks'
        # upstream gradients
        np.testing.assert_allclose(res["pmean_grad"], mean, rtol=1e-7)
    chunk, err = _jax_reduce(g, n)
    c = chunk.size // n
    for r, res in enumerate(got["reduce"]):
        assert np.isfinite(res["chunk"]).all()
        np.testing.assert_allclose(res["chunk"], chunk[r * c:(r + 1) * c],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(res["err"], err[r], rtol=1e-6, atol=1e-6)
    # the cast wire: bitwise JAX's psum_scatter of the cast gradient
    for wire, scale in (("bf16", 1), ("fp16", 64)):
        want = _jax_cast_reduce(gc / scale, n, wire)
        c = want.size // n
        for r, res in enumerate(got[f"cast_{wire}"]):
            np.testing.assert_array_equal(res["chunk"],
                                          want[r * c:(r + 1) * c])
