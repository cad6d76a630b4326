"""The port's int8 paged KV pool against the JAX package's, on the CPU
(``bigdl_tpu_torch/nn/attention.py`` int8 layout, ``_apply_paged`` and
K3q's plain version; ``serving/paging.py`` and the engine's int8 KV).

The TPU paged kernel does not trace on the installed JAX (``pl.load``),
so K3q's plain version is held against the JAX package's gather path:
``MultiHeadAttention._apply_paged`` off-TPU gathers the row's context,
dequantizes it (``_paged_dequant``) and runs ``dot_product_attention``.

Tolerances: on the same int8 pool and query, attention agrees to 1e-5
(fp32, sums in another order).  Through a whole module the K/V vectors
come from a projection that XLA and torch sum in another order, so a
value near a .5 rounding boundary can land one int8 code apart: pool
payloads are held to |delta| <= 1 on at most 1% of the codes, scales to
1e-5 relative, and logits to 1e-4 (a code is 1/127 of a head_dim
vector's absmax).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu.nn.attention import TransformerLM as JaxLM
from bigdl_tpu.nn.attention import dot_product_attention as jax_dpa
from bigdl_tpu.ops.quantization import quantize_blockwise as jax_quant
from bigdl_tpu.serving import BlockAllocator as JaxAllocator
from bigdl_tpu.serving import ServingEngine as JaxEngine
from bigdl_tpu.serving.paging import chain_hash as jax_chain_hash
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.nn import TransformerLM
from bigdl_tpu_torch.ops import flash_attention as fa
from bigdl_tpu_torch.serving import BlockAllocator, ServingEngine
from bigdl_tpu_torch.serving.paging import chain_hash

VOCAB, HIDDEN, HEADS, LAYERS, MAX_LEN = 50, 32, 4, 2, 48
HEAD_DIM = HIDDEN // HEADS


@pytest.fixture(scope="module")
def models():
    jm = JaxLM(VOCAB, HIDDEN, HEADS, LAYERS, max_len=MAX_LEN)
    jm.build(jax.ShapeDtypeStruct((2, 16), jnp.int32),
             rng=jax.random.PRNGKey(0))
    tm = TransformerLM(VOCAB, HIDDEN, HEADS, LAYERS, max_len=MAX_LEN,
                       device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.parameters()[0]))
    return jm, tm


def _bytes(pool):
    return sum(t.numel() * t.element_size()
               for layer in pool.values() for t in layer.values())


def test_pool_layout_matches_jax(models):
    jm, tm = models
    nb, bs = 6, 4
    got = tm.init_paged_cache(nb, bs, torch.int8)
    want = jm.init_paged_cache(nb, bs, dtype=jnp.int8)
    assert sorted(got) == sorted(want)
    for name, layer in want.items():
        assert sorted(got[name]) == sorted(layer) == \
            ["k", "k_scale", "v", "v_scale"]
        for key, leaf in layer.items():
            t = got[name][key]
            assert tuple(t.shape) == leaf.shape
            assert str(t.dtype).replace("torch.", "") == leaf.dtype.name
    layer = got["block0"]
    assert layer["k"].shape == (nb + 1, bs, HEADS, HEAD_DIM)
    assert layer["k_scale"].shape == (nb + 1, bs, HEADS, 1)
    # head_dim 8: fp32 32 B a vector against int8 8 B + a 4 B scale
    fp = tm.init_paged_cache(nb, bs)
    assert _bytes(fp) / _bytes(got) == pytest.approx(32 / 12, abs=1e-12)
    assert _bytes(got) == sum(leaf.size * leaf.dtype.itemsize
                              for lay in want.values()
                              for leaf in lay.values())


def _int8_pool(rng, nb, bs):
    """A random int8 pool quantized by the JAX package's quantizer, as
    numpy (k8, ks, v8, vs)."""
    out = []
    for _ in range(2):
        x = rng.normal(size=(nb, bs, HEADS, HEAD_DIM)).astype(np.float32)
        q8, sc = jax_quant(jnp.asarray(x.reshape(-1)), HEAD_DIM,
                           scale_dtype=jnp.float32)
        out += [np.array(q8).reshape(x.shape),
                np.array(sc).reshape(nb, bs, HEADS, 1)]
    return out


@pytest.mark.parametrize("bs", [4, 16])
def test_k3q_plain_matches_the_jax_gather_path(models, bs):
    """K3q's plain version (through the wrapper, on CPU tensors) against
    the JAX package's off-TPU decode read of an int8 pool: gather the
    tables, ``_paged_dequant``, masked ``dot_product_attention``."""
    jm, _tm = models
    jattn = jm.blocks[0].attn
    rng = np.random.default_rng(bs)
    b, max_len = 5, 40
    mb = -(-max_len // bs)
    nb = b * mb + 1
    trash = nb - 1
    k8, ks, v8, vs = _int8_pool(rng, nb, bs)
    k8[trash], ks[trash] = 127, 1e4
    pos = rng.integers(0, max_len, b).astype(np.int32)
    pos[:3] = [0, bs - 1, bs]
    used = pos // bs + 1
    tables = rng.permutation(nb - 1)[:b * mb].reshape(b, mb).astype(np.int32)
    tables = np.where(np.arange(mb)[None] < used[:, None], tables, trash)
    vs[tables[3, 0], 0] = 0.0                   # a zero-scale vector
    q = rng.normal(size=(b, 1, HEADS, HEAD_DIM)).astype(np.float32)

    ctx = mb * bs
    shape = (b, ctx, HEADS)
    jt = jnp.asarray(tables)
    ctx_k = jattn._paged_dequant(
        jnp.take(jnp.asarray(k8), jt, axis=0).reshape(*shape, HEAD_DIM),
        jnp.take(jnp.asarray(ks), jt, axis=0).reshape(*shape, 1),
        jnp.float32)
    ctx_v = jattn._paged_dequant(
        jnp.take(jnp.asarray(v8), jt, axis=0).reshape(*shape, HEAD_DIM),
        jnp.take(jnp.asarray(vs), jt, axis=0).reshape(*shape, 1),
        jnp.float32)
    mask = (jnp.arange(ctx)[None, :] <= jnp.asarray(pos)[:, None])[
        :, None, None, :]
    want = np.asarray(jax_dpa(jnp.asarray(q), ctx_k, ctx_v, mask=mask))

    t = torch.from_numpy
    before = dict(fa.LAUNCHES)
    got = fa.flash_paged_decode_attention(t(q), t(k8), t(v8), t(tables),
                                          t(pos), k_scale=t(ks),
                                          v_scale=t(vs))
    assert fa.LAUNCHES == before          # the CPU takes the plain version
    assert got.dtype == torch.float32 and got.shape == (b, 1, HEADS,
                                                         HEAD_DIM)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # bf16 queries give fp32 out of the same fp32 arithmetic
    got16 = fa.flash_paged_decode_attention(
        t(q).bfloat16(), t(k8), t(v8), t(tables), t(pos), k_scale=t(ks),
        v_scale=t(vs))
    want16 = fa.flash_paged_decode_attention_reference(
        t(q).bfloat16().float(), t(k8), t(v8), t(tables), t(pos), t(ks),
        t(vs))
    assert got16.dtype == torch.float32
    torch.testing.assert_close(got16, want16, atol=0, rtol=0)
    with pytest.raises(ValueError, match="both"):
        fa.flash_paged_decode_attention(t(q), t(k8), t(v8), t(tables),
                                        t(pos), k_scale=t(ks))


def _close_pools(got, want):
    """Payloads within one code on at most 1% of the codes; scales 1e-5."""
    for name, layer in want.items():
        for key, leaf in layer.items():
            g = got[name][key].numpy()
            w = np.asarray(leaf)
            if key in ("k", "v"):
                d = np.abs(g.astype(np.int32) - w.astype(np.int32))
                assert d.max() <= 1, (name, key)
                assert (d != 0).mean() <= 0.01, (name, key, (d != 0).mean())
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-9,
                                           err_msg=f"{name}.{key}")


def test_module_decode_reads_the_int8_pool_like_jax(models):
    """One MultiHeadAttention decode step on the same int8 pool: the port
    (scatter, then K3q's plain version) against JAX's ``_apply_paged``
    (scatter, then its gather path)."""
    jm, tm = models
    rng = np.random.default_rng(7)
    nb, bs, b = 9, 4, 3
    k8, ks, v8, vs = _int8_pool(rng, nb, bs)
    pool = {"k": k8, "k_scale": ks, "v": v8, "v_scale": vs}
    tables = np.array([[0, 1, 2], [3, 4, 8], [5, 8, 8]], np.int32)
    pos = np.array([9, 6, 2], np.int32)
    x = rng.normal(size=(b, 1, HIDDEN)).astype(np.float32)
    want_y, want_pool = jm.blocks[0].attn._apply_paged(
        jm.parameters()[0]["block0"]["attn"], jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in pool.items()}, jnp.asarray(tables),
        jnp.asarray(pos), None)
    tpool = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    with torch.no_grad():
        got_y, got_pool = tm.block0.attn._apply_paged(
            torch.from_numpy(x), tpool, torch.from_numpy(tables),
            torch.from_numpy(pos), None)
    _close_pools({"l": got_pool}, {"l": want_pool})
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("use_flash", ["auto", "never"])
def test_chunk_prefill_and_decode_through_the_int8_pool(models, use_flash):
    """Prefill 5 positions as one chunk, decode 7 more: logits at every
    position and both pools after every step, port against JAX."""
    jm, tm = models
    params = jm.parameters()[0]
    for blk in tm.blocks:
        blk.attn.use_flash = use_flash
    nb, bs = 8, 4
    tables = np.array([[0, 1, 2, nb]], np.int32)
    toks = np.random.default_rng(5).integers(0, VOCAB, (1, 12)).astype(
        np.int32)
    jpool = jm.init_paged_cache(nb, bs, dtype=jnp.int8)
    tpool = tm.init_paged_cache(nb, bs, torch.int8)
    try:
        steps = [(toks[:, :5], 0, 5)] + [(toks[:, t:t + 1], t, None)
                                         for t in range(5, 12)]
        for tok, start, length in steps:
            kw = {} if length is None else {
                "lengths": np.array([length], np.int32)}
            want, jpool = jm.apply_paged(
                params, jnp.asarray(tok), jpool, jnp.asarray(tables),
                pos=jnp.asarray([start], jnp.int32),
                **{k: jnp.asarray(v) for k, v in kw.items()})
            with torch.no_grad():
                got, tpool = tm.apply_paged(
                    torch.from_numpy(tok), tpool, torch.from_numpy(tables),
                    pos=torch.tensor([start], dtype=torch.int32),
                    **{k: torch.from_numpy(v) for k, v in kw.items()})
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-4, rtol=1e-4)
            _close_pools(tpool, jpool)
    finally:
        for blk in tm.blocks:
            blk.attn.use_flash = "auto"


def test_poisoned_int8_cache_beyond_the_frontier_changes_nothing(models):
    _jm, tm = models
    nb, bs = 8, 4
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, VOCAB, (1, 6)).astype(np.int32))
    tables = torch.tensor([[0, 1, 2, nb]], dtype=torch.int32)
    pool = tm.init_paged_cache(nb, bs, torch.int8)
    tok, pos = torch.tensor([[3]]), torch.tensor([6], dtype=torch.int32)
    with torch.no_grad():
        tm.apply_paged(toks, pool, tables, pos=torch.tensor(
            [0], dtype=torch.int32), lengths=torch.tensor([6],
                                                          dtype=torch.int32))
        poisoned = {n: {k: t.clone() for k, t in layer.items()}
                    for n, layer in pool.items()}
        for layer in poisoned.values():
            for key, t in layer.items():
                bad = 127 if t.dtype == torch.int8 else 1e4
                t[1, 3:] = bad               # past position 6 in block 1
                t[2] = bad
                t[nb] = bad                  # the trash block
        lg, _ = tm.apply_paged(tok, pool, tables, pos=pos)
        lg2, _ = tm.apply_paged(tok, poisoned, tables, pos=pos)
    assert torch.equal(lg, lg2)


def test_allocator_dtype_refusal_and_hash_namespacing():
    a = BlockAllocator(num_blocks=8, block_size=4, kv_dtype="int8")
    with pytest.raises(ValueError, match="KV-dtype mismatch"):
        a.begin_sequence("s1", list(range(9)), 9, kv_dtype="fp32")
    assert a.begin_sequence("s1", list(range(9)), 9, kv_dtype="int8") == 0
    fp = BlockAllocator(num_blocks=8, block_size=4)
    assert fp._hash_root == "" and a._hash_root == "kv:int8"
    block = list(range(4))
    assert chain_hash(fp._hash_root, block) != chain_hash(a._hash_root,
                                                          block)
    # the same hashes as the JAX package's allocator
    for kv in ("fp32", "int8"):
        root = JaxAllocator(num_blocks=8, block_size=4, kv_dtype=kv)._hash_root
        assert root == BlockAllocator(8, 4, kv_dtype=kv)._hash_root
        assert chain_hash(root, block) == jax_chain_hash(root, block)


PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11], [4] * 9 + [5] * 6]


def test_int8_kv_engine_stream_and_bytes_match_jax(models):
    jm, tm = models
    kw = dict(decode_slots=3, decode_max_len=48, kv_block_size=4)
    streams, stats = {}, {}
    for dt in ("fp32", "int8"):
        with JaxEngine(jm, kv_cache_dtype=dt, **kw) as eng:
            want = [eng.generate(p, max_new_tokens=6).result(120)
                    for p in PROMPTS]
            want_kv = eng._gen._alloc.stats()
        with ServingEngine(tm, kv_cache_dtype=dt, device="cpu",
                           **kw) as eng:
            got = [f.result(60) for f in [eng.generate(p, max_new_tokens=6)
                                          for p in PROMPTS]]
            gen = eng._gen
            assert gen.kv_dtype() == dt
            st = gen.stats()
        assert got == want, dt
        for key in ("kv_dtype", "bytes_per_block", "pool_bytes",
                    "blocks_total"):
            assert st["kv"][key] == want_kv[key], key
        assert st["served"] == len(PROMPTS) and st["tokens"] == 18
        streams[dt], stats[dt] = got, st
    ratio = stats["fp32"]["kv"]["pool_bytes"] / stats["int8"]["kv"][
        "pool_bytes"]
    assert ratio == pytest.approx(32 / 12)


def test_engine_refuses_int8_kv_without_the_paged_layout(models):
    _jm, tm = models
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(tm, decode_slots=1, decode_max_len=40,
                      kv_cache="contiguous", kv_cache_dtype="int8",
                      device="cpu")
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        ServingEngine(tm, decode_slots=1, decode_max_len=40,
                      kv_cache_dtype="int4", device="cpu")
