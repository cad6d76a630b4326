"""The generation steps built once per shape (``bigdl_tpu_torch/serving/
graphs.py``, the schedulers of ``serving/generation.py``) against the JAX
package's jitted steps, on the CPU, and as CUDA graphs on the card.

CPU (the tiny model: 2 layers, hidden 32, vocab 64, JAX weights loaded
through ``interop``):

- each built step through its static inputs, on a random pool, against
  the JAX step on the same pool and inputs (``paged_generate_steps``,
  ``generate_steps``, ``speculative_verify_step``): logits and fp32
  pools within 1e-5 (fp32, sums in another order), int8 pools as
  ``test_torch_paged_int8.py`` holds them (one code on at most 1% of
  the codes, scales 1e-5), greedy tokens exact; a sampled row's token
  is the port's own sampler on JAX's logits (JAX draws threefry noise);
- ``precompile()`` closes the step set in every scheduler (JAX
  ``tests/test_decode.py:239``, ``tests/test_paged.py:357``): a
  closed-loop workload of mixed lengths, staggered budgets and sampled
  requests builds nothing, and a batch count outside the ladder builds
  exactly one step;
- ``_reset_pool`` zeroes every pool leaf in place;
- ``ServingEngine.stats()`` has the JAX engine's keys.

Card (``cuda`` marker, skipped without one): replayed steps against the
same steps run eagerly on pool copies (1e-4), launch counts per replay,
a capture that fails failing its tick's requests, and ``predict``
running while the generation dispatcher captures.  The JAX package is
imported by the fixtures of the CPU tests only, so the card tests run on
a machine without JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda \
        tests/test_torch_graphs.py
"""

import threading
import types

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.nn import TransformerLM
from bigdl_tpu_torch.ops import flash_attention as fa
from bigdl_tpu_torch.serving import BucketLadder, ServingEngine, graphs
from bigdl_tpu_torch.serving.sampling import sample_tokens

VOCAB, HIDDEN, HEADS, LAYERS, MAX_LEN = 64, 32, 4, 2, 48
SLOTS, BS, DECODE_MAX_LEN, CHUNK = 3, 4, 40, 8
KW = dict(decode_slots=SLOTS, decode_max_len=DECODE_MAX_LEN,
          kv_block_size=BS, prefill_chunk=CHUNK)
#: the four schedulers: engine arguments
KINDS = {"paged": {}, "int8": dict(kv_cache_dtype="int8"),
         "contiguous": dict(kv_cache="contiguous"),
         "speculative": dict(speculative=2)}


@pytest.fixture(scope="module")
def jx():
    """JAX and the JAX package's serving steps (the CPU tests' oracle)."""
    jax = pytest.importorskip("jax")
    from bigdl_tpu.nn.attention import TransformerLM
    from bigdl_tpu.serving import ServingEngine
    from bigdl_tpu.serving import generation

    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, LM=TransformerLM, Engine=ServingEngine,
        generate_steps=generation.generate_steps,
        paged_steps=generation.paged_generate_steps,
        verify_step=generation.speculative_verify_step)


@pytest.fixture(scope="module")
def models(jx):
    jax, jnp = jx.jax, jx.jnp
    jm = jx.LM(VOCAB, HIDDEN, HEADS, LAYERS, max_len=MAX_LEN)
    jm.build(jax.ShapeDtypeStruct((2, 16), jnp.int32),
             rng=jax.random.PRNGKey(4))
    tm = TransformerLM(VOCAB, HIDDEN, HEADS, LAYERS, max_len=MAX_LEN,
                       device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.parameters()[0]))
    return jm, tm


def _random_pool(rng, pool):
    """Random values for every leaf of a port pool (int8 codes, positive
    scales, or normal fp32), as numpy, written into ``pool`` in place."""
    out = {}
    for name, layer in pool.items():
        out[name] = {}
        for key, t in layer.items():
            if t.dtype == torch.int8:
                a = rng.integers(-127, 128, t.shape).astype(np.int8)
            elif key.endswith("_scale"):
                a = rng.uniform(0.001, 0.02, t.shape).astype(np.float32)
            else:
                a = rng.normal(size=t.shape).astype(np.float32)
            t.copy_(torch.from_numpy(a))
            out[name][key] = a
    return out


def _jax_tree(jx, arrays):
    return jx.jax.tree.map(jx.jnp.asarray, arrays)


def _close_pools(got, want):
    """fp32 leaves and scales 1e-5; int8 payloads within one code on at
    most 1% of the codes (a K/V value near a .5 boundary)."""
    for name, layer in want.items():
        for key, leaf in layer.items():
            g, w = got[name][key].numpy(), np.asarray(leaf)
            if g.dtype == np.int8:
                d = np.abs(g.astype(np.int32) - w.astype(np.int32))
                assert d.max() <= 1 and (d != 0).mean() <= 0.01, (name, key)
            else:
                np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5,
                                           err_msg=f"{name}.{key}")


def _knobs(rng, n, sample):
    """Greedy knobs, or every other row sampled with its own seed."""
    k = dict(temperature=np.zeros(n, np.float32), top_k=np.zeros(n, np.int32),
             top_p=np.ones(n, np.float32), seed=np.zeros(n, np.int32))
    if sample:
        k["temperature"][::2] = 0.8
        k["top_k"][::2] = 7
        k["top_p"][::2] = 0.9
        k["seed"][::2] = rng.integers(0, 2 ** 31, (n + 1) // 2)
    return k


def _tables(rng, n, mb, nb, used):
    """Rows of distinct shuffled blocks; entries past ``used[r]`` and
    every entry of a row with ``used[r] == 0`` name the trash block."""
    tables = np.full((n, mb), nb, np.int32)
    blocks = iter(rng.permutation(nb))
    for r, u in enumerate(used):
        tables[r, :u] = [next(blocks) for _ in range(u)]
    return tables


def _check_tokens(got, jax_tokens, jax_rows, knobs, position):
    """Greedy rows equal JAX's tokens; sampled rows equal the port's
    sampler on JAX's logits at ``position``."""
    want = sample_tokens(torch.from_numpy(np.asarray(jax_rows)),
                         *(torch.from_numpy(knobs[n]) for n in
                           ("temperature", "top_k", "top_p", "seed")),
                         torch.from_numpy(np.asarray(position)))
    greedy = knobs["temperature"] <= 0
    np.testing.assert_array_equal(got[greedy], np.asarray(jax_tokens)[greedy])
    np.testing.assert_array_equal(got, want.numpy())


def _run(sched, key, inp, **values):
    inp.set(**values)
    inp.upload()
    tok, logits = sched._graphs.run(key)
    return tok.numpy(), logits.numpy()


@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_paged_steps_match_jax(jx, models, kv, sample):
    """The built decode and chunk-prefill steps of the paged scheduler
    against JAX's ``paged_generate_steps`` on one random pool."""
    jnp = jx.jnp
    jm, tm = models
    params = jm.parameters()[0]
    rng = np.random.default_rng(11)
    jchunk, jdecode, _ = jx.paged_steps(
        jm, {"fp32": jnp.float32, "int8": jnp.int8}[kv])
    with ServingEngine(tm, kv_cache_dtype=kv, device="cpu", **KW) as eng:
        sched = eng._generation()
        nb, mb = sched.num_blocks, sched.max_blocks_per_seq
        with sched._step_lock:
            # decode: two live rows and an idle one
            arrays = _random_pool(rng, sched._cache)
            pos = np.array([13, 30, 0], np.int32)
            tables = _tables(rng, SLOTS, mb, nb, [4, 8, 0])
            tokens = rng.integers(0, VOCAB, SLOTS).astype(np.int32)
            knobs = _knobs(rng, SLOTS, sample)
            key, inp = sched._decode_step(sample)
            got, logits = _run(sched, key, inp, tokens=tokens, pos=pos,
                               tables=tables, **knobs)
            jtok, jpool = jdecode(params, _jax_tree(jx, arrays), tokens, pos,
                                  tables, *knobs.values())
            jlog, _ = jm.apply_paged(params, jnp.asarray(tokens)[:, None],
                                     _jax_tree(jx, arrays),
                                     jnp.asarray(tables),
                                     pos=jnp.asarray(pos))
            live = tables[:, 0] != nb
            np.testing.assert_allclose(logits[live],
                                       np.asarray(jlog)[live, 0],
                                       atol=1e-5, rtol=1e-5)
            _check_tokens(got[live], np.asarray(jtok)[live],
                          np.asarray(jlog)[live, 0],
                          {n: v[live] for n, v in knobs.items()},
                          pos[live] + 1)
            _close_pools(sched._cache, jpool)

            # chunk prefill: a middle chunk, a last partial one, padding
            b = 4
            arrays = _random_pool(rng, sched._cache)
            start = np.array([8, 16, 0, 0], np.int32)
            lens = np.array([8, 5, 0, 0], np.int32)
            tables = _tables(rng, b, mb, nb, [4, 6, 0, 0])
            tokens = rng.integers(0, VOCAB, (b, CHUNK)).astype(np.int32)
            knobs = _knobs(rng, b, sample)
            key, inp = sched._chunk_step(b, sample)
            got, logits = _run(sched, key, inp, tokens=tokens, start=start,
                               lengths=lens, tables=tables, **knobs)
            jtok, jpool = jchunk(params, _jax_tree(jx, arrays), tokens, start,
                                 lens, tables, *knobs.values())
            jlog, _ = jm.apply_paged(params, jnp.asarray(tokens),
                                     _jax_tree(jx, arrays),
                                     jnp.asarray(tables),
                                     pos=jnp.asarray(start),
                                     lengths=jnp.asarray(lens))
            live = lens > 0
            jrow = np.asarray(jlog)[np.arange(b), np.maximum(lens - 1, 0)]
            np.testing.assert_allclose(logits[live], jrow[live], atol=1e-5,
                                       rtol=1e-5)
            _check_tokens(got[live], np.asarray(jtok)[live], jrow[live],
                          {n: v[live] for n, v in knobs.items()},
                          (start + lens)[live])
            _close_pools(sched._cache, jpool)


def test_contiguous_steps_match_jax(jx, models):
    """The built prefill and decode of the contiguous scheduler against
    JAX's ``generate_steps`` on one random cache."""
    jnp = jx.jnp
    jm, tm = models
    params = jm.parameters()[0]
    rng = np.random.default_rng(12)
    jprefill, jdecode = jx.generate_steps(jm)
    with ServingEngine(tm, kv_cache="contiguous", device="cpu",
                       **KW) as eng:
        sched = eng._generation()
        trash = sched._trash
        with sched._step_lock:
            arrays = _random_pool(rng, sched._cache)
            b, t = 2, 16
            tokens = rng.integers(0, VOCAB, (b, t)).astype(np.int32)
            lengths = np.array([16, 11], np.int32)
            slot_ids = np.array([1, 2], np.int32)
            key, inp = sched._prefill_step(b, t)
            got, logits = _run(sched, key, inp, tokens=tokens,
                               lengths=lengths, slot_ids=slot_ids)
            jtok, jcache = jprefill(params, _jax_tree(jx, arrays), tokens,
                                    lengths, slot_ids)
            jlog, _ = jm.apply(params, (), jnp.asarray(tokens),
                               cache=jm.init_cache(b, t))
            jrow = np.asarray(jlog)[np.arange(b), lengths - 1]
            np.testing.assert_allclose(logits, jrow, atol=1e-5, rtol=1e-5)
            np.testing.assert_array_equal(got, np.asarray(jtok))
            _close_pools(sched._cache, jcache)

            arrays = _random_pool(rng, sched._cache)
            s = SLOTS + 1
            tokens = rng.integers(0, VOCAB, s).astype(np.int32)
            pos = np.array([5, 17, 38, 0], np.int32)
            key, inp = sched._decode_step()
            got, logits = _run(sched, key, inp, tokens=tokens, pos=pos)
            jtok, jcache = jdecode(params, _jax_tree(jx, arrays), tokens, pos)
            jlog, _ = jm.apply(params, (), jnp.asarray(tokens)[:, None],
                               cache=_jax_tree(jx, arrays),
                               pos=jnp.asarray(pos))
            real = np.arange(s) != trash
            np.testing.assert_allclose(logits[real], np.asarray(jlog)[real, 0],
                                       atol=1e-5, rtol=1e-5)
            np.testing.assert_array_equal(got[real], np.asarray(jtok)[real])
            _close_pools(sched._cache, jcache)


@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_speculative_verify_step_matches_jax(jx, models, kv, sample):
    """The built verify step of a speculative round (drafts taken from
    its static draft buffer) against JAX's ``speculative_verify_step``."""
    jnp = jx.jnp
    jm, tm = models
    params = jm.parameters()[0]
    rng = np.random.default_rng(13)
    k = 2
    jverify = jx.verify_step(jm, {"fp32": jnp.float32,
                                  "int8": jnp.int8}[kv], k)
    with ServingEngine(tm, kv_cache_dtype=kv, speculative=k, device="cpu",
                       **KW) as eng:
        sched = eng._generation()
        nb, mb = sched.num_blocks, sched.max_blocks_per_seq
        with sched._step_lock:
            arrays = _random_pool(rng, sched._cache)
            last = rng.integers(0, VOCAB, SLOTS).astype(np.int32)
            drafts = rng.integers(0, VOCAB, (k, SLOTS)).astype(np.int32)
            pos = np.array([6, 21, 0], np.int32)
            tables = _tables(rng, SLOTS, mb, nb, [3, 7, 0])
            knobs = _knobs(rng, SLOTS, sample)
            keys, inp = sched._decode_step(sample)
            sched._drafts[:k] = torch.from_numpy(drafts)
            out, logits = _run(sched, keys[-1], inp, last=last, pos=pos,
                               tables=tables, **knobs)
            jtok, jpool = jverify(params, _jax_tree(jx, arrays), last,
                                  tuple(drafts), pos, tables,
                                  *knobs.values())
            fed = np.concatenate([last[:, None], drafts.T], axis=1)
            jlog, _ = jm.apply_paged(params, jnp.asarray(fed),
                                     _jax_tree(jx, arrays),
                                     jnp.asarray(tables),
                                     pos=jnp.asarray(pos),
                                     lengths=jnp.full((SLOTS,), k + 1,
                                                      jnp.int32))
            live = tables[:, 0] != nb
            np.testing.assert_allclose(logits[live], np.asarray(jlog)[live],
                                       atol=1e-5, rtol=1e-5)
            np.testing.assert_array_equal(out[:, :k], drafts.T)
            flat = {n: np.repeat(v[live], k + 1) for n, v in knobs.items()}
            positions = (pos[live, None] + 1 + np.arange(k + 1)).reshape(-1)
            _check_tokens(out[live, k:].reshape(-1),
                          np.asarray(jtok)[live].reshape(-1),
                          np.asarray(jlog)[live].reshape(-1, VOCAB), flat,
                          positions)
            _close_pools(sched._cache, jpool)


def _prompt(rng, n):
    return rng.integers(0, VOCAB, n).astype(np.int32)


@pytest.mark.parametrize("kind", list(KINDS))
def test_precompile_closes_the_step_set(models, kind):
    """After ``precompile()`` a closed-loop workload builds nothing, and a
    batch count outside the admission ladder builds exactly one step."""
    _jm, tm = models
    rng = np.random.default_rng(14)
    before = graphs.capture_count()
    with ServingEngine(tm, device="cpu", **KW, **KINDS[kind]) as eng:
        gen = eng._generation()
        # rungs 1 and 2: three rows in one tick lie outside the ladder
        gen.batch_ladder = BucketLadder(2)
        built = eng.precompile()
        st = eng.stats()["generate"]["graphs"]
        assert built == st["captured"] > 0
        assert st["captured_after_precompile"] == 0
        sampled = dict(temperature=0.9, top_p=0.8, seed=5) \
            if gen.supports_sampling else {}
        # at most two requests at a time; sequences join and leave slots
        # mid-flight, with mixed lengths and staggered budgets
        a = eng.generate(_prompt(rng, 5), max_new_tokens=3)
        b = eng.generate(_prompt(rng, 12), max_new_tokens=7, **sampled)
        assert len(a.result(60)) == 3
        c = eng.generate(_prompt(rng, 9), max_new_tokens=2)
        assert len(b.result(60)) == 7 and len(c.result(60)) == 2
        d = eng.generate(_prompt(rng, 15), max_new_tokens=4, **sampled)
        e = eng.generate(_prompt(rng, 3), max_new_tokens=6)
        assert [len(d.result(60)), len(e.result(60))] == [4, 6]
        st = eng.stats()["generate"]["graphs"]
        assert st["captured_after_precompile"] == 0
        replays = st["replays"]
        assert replays > 0
        # three prompts admitted in one tick (the dispatcher waits on the
        # step lock while they queue)
        with gen._step_lock:
            futs = [eng.generate(_prompt(rng, n), max_new_tokens=3)
                    for n in (4, 10, 13)]
        assert [len(f.result(60)) for f in futs] == [3, 3, 3]
        st = eng.stats()["generate"]["graphs"]
        assert st["captured_after_precompile"] == 1
        assert st["captured"] == built + 1 and st["replays"] > replays
    assert graphs.capture_count() - before == built + 1


@pytest.mark.parametrize("kind", list(KINDS))
def test_reset_pool_zeroes_every_leaf_in_place(models, kind):
    """The built steps hold the pool's addresses: a reset (after a failed
    tick) zeroes the tensors and keeps them; the allocator starts anew."""
    _jm, tm = models
    with ServingEngine(tm, device="cpu", **KW, **KINDS[kind]) as eng:
        gen = eng._generation()
        eng.generate([1, 2, 3], max_new_tokens=2).result(60)
        pools = [gen._cache] + ([gen._dcache] if kind == "speculative"
                                else [])
        leaves = [t for pool in pools for layer in pool.values()
                  for t in layer.values()]
        for t in leaves:
            t.fill_(1)
        ptrs = [t.data_ptr() for t in leaves]
        kv = gen.stats().get("kv")
        with gen._step_lock:
            gen._reset_pool()
        assert [t.data_ptr() for t in leaves] == ptrs
        assert all(not t.any() for t in leaves)
        if kv is not None:
            after = gen.stats()["kv"]
            assert after["blocks_cached"] == 0
            assert after["bytes_per_block"] == kv["bytes_per_block"]
        assert eng.generate([1, 2, 3], max_new_tokens=2).result(60)


def test_engine_stats_have_the_jax_keys(jx, models):
    jm, tm = models
    kw = dict(decode_slots=2, decode_max_len=32, kv_block_size=4)
    with jx.Engine(jm, **kw) as eng:
        eng.generate([1, 2, 3], max_new_tokens=2).result(120)
        want = eng.stats()
    with ServingEngine(tm, device="cpu", **kw) as eng:
        eng.generate([1, 2, 3], max_new_tokens=2).result(60)
        eng.predict(np.arange(5, dtype=np.int32))
        got = eng.stats()
    assert set(got) == set(want)
    assert set(got["generate"]) - set(want["generate"]) == {"graphs"}
    assert set(got["generate"]["graphs"]) == {
        "captured", "captured_after_precompile", "replays"}
    assert got["ticks"] == 1 and got["served"] == 1 and not got["draining"]


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_model(cuda):
    """Head dim 16, the kernels' smallest instantiation."""
    return TransformerLM(VOCAB, 64, HEADS, LAYERS, max_len=MAX_LEN,
                         device=cuda, seed=3)


def _clone(pool):
    return {n: {k: t.clone() for k, t in layer.items()}
            for n, layer in pool.items()}


def _card_pool(pool, seed):
    g = torch.Generator(device=pool[next(iter(pool))]["k"].device)
    g.manual_seed(seed)
    for layer in pool.values():
        for key, t in layer.items():
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=g,
                                      device=t.device, dtype=torch.int8))
            elif key.endswith("_scale"):
                t.copy_(torch.rand(t.shape, generator=g, device=t.device)
                        * 0.02 + 0.001)
            else:
                t.copy_(torch.randn(t.shape, generator=g, device=t.device))


def _random_inputs(rng, inp, gen):
    """Random values for a step's static inputs.  Each row maps distinct
    real blocks as far as every position it writes or reads (the rest of
    its table names the trash block, which padding writes reach in no set
    order and which no real position reads)."""
    rows = next(iter(inp.dev.values())).shape[0]
    paged = hasattr(gen, "block_size")
    if paged:
        mb, trash = gen.max_blocks_per_seq, gen._alloc.trash
        used = min(mb, trash // rows)
        limit = used * gen.block_size - CHUNK - 3
    else:
        limit = DECODE_MAX_LEN - CHUNK
    for name, view in inp.dev.items():
        host = inp.host[name]
        if name == "tables":
            host[...] = trash
            host[:, :used] = rng.permutation(trash)[:rows * used].reshape(
                rows, used)
        elif name in ("temperature", "top_p"):
            host[...] = rng.uniform(0.5, 1.0, view.shape)
        elif name == "slot_ids":
            host[...] = rng.permutation(SLOTS + 1)[:rows]
        elif name in ("pos", "start"):
            host[...] = rng.integers(0, limit, view.shape)
        elif name == "lengths":
            host[...] = rng.integers(1, inp.dev["tokens"].shape[1] + 1,
                                     view.shape)
        else:
            host[...] = rng.integers(0, VOCAB, view.shape)


@pytest.mark.cuda
def test_replayed_steps_equal_eager_steps_on_pool_copies(cuda):
    """Every built step of the four schedulers, replayed on the live pool,
    against the same step run eagerly (kernels and all) on a copy of the
    pool taken before it: logits, tokens and pools (1e-4)."""
    model = _card_model(cuda)
    rng = np.random.default_rng(15)
    for kind, extra in KINDS.items():
        with ServingEngine(model, device=cuda, **KW, **extra) as eng:
            gen = eng._generation()
            eng.precompile()
            with gen._step_lock:
                pools = {"_cache": gen._cache}
                if kind == "speculative":
                    pools["_dcache"] = gen._dcache
                for key, step in list(gen._graphs._steps.items()):
                    for i, pool in enumerate(pools.values()):
                        _card_pool(pool, seed=len(key) + i)
                    inp = step.inputs
                    _random_inputs(rng, inp, gen)
                    inp.upload()
                    copies = {n: _clone(p) for n, p in pools.items()}
                    live = {n: getattr(gen, n) for n in pools}
                    tok, logits = gen._graphs.run(key)
                    tok, logits = tok.clone(), logits.clone()
                    after = {n: _clone(p) for n, p in pools.items()}
                    try:
                        for n, c in copies.items():
                            setattr(gen, n, c)
                        etok, elog = step.fn()
                    finally:
                        for n, p in live.items():
                            setattr(gen, n, p)
                    torch.cuda.synchronize()
                    torch.testing.assert_close(logits, elog, atol=1e-4,
                                               rtol=1e-4, msg=str(key))
                    assert torch.equal(tok, etok), key
                    # padding writes land in the paged trash block in no
                    # set order
                    keep = slice(None, -1) if kind != "contiguous" \
                        else slice(None)
                    for n in pools:
                        for name, layer in after[n].items():
                            for leaf, t in layer.items():
                                torch.testing.assert_close(
                                    t[keep].float(),
                                    copies[n][name][leaf][keep].float(),
                                    atol=1e-4, rtol=1e-4,
                                    msg=f"{key} {n} {name}.{leaf}")


@pytest.mark.cuda
def test_a_replay_counts_the_launches_its_capture_recorded(cuda):
    model = _card_model(cuda)
    for kind, extra in KINDS.items():
        with ServingEngine(model, device=cuda, **KW, **extra) as eng:
            eng.precompile()
            gen = eng._generation()
            with gen._step_lock:
                for key, step in gen._graphs._steps.items():
                    before = dict(fa.LAUNCHES)
                    step.inputs.upload()
                    gen._graphs.run(key)
                    delta = {n: fa.LAUNCHES[n] - before[n]
                             for n in before if fa.LAUNCHES[n] != before[n]}
                    assert delta == step.launches.get("flash_attention", {}), \
                        key
                    if key[0] in ("decode", "draft"):
                        name = {"contiguous": "flash_decode_attention",
                                "int8": "flash_paged_decode_attention_int8"
                                }.get(kind, "flash_paged_decode_attention")
                        assert delta == {name: LAYERS}, (kind, key)
                    if key[0] == "prefill":
                        assert delta == {"flash_attention": LAYERS}, key


@pytest.mark.cuda
def test_a_failed_capture_fails_its_tick_and_serves_nothing_eagerly(cuda):
    model = _card_model(cuda)
    with ServingEngine(model, device=cuda, **KW) as eng:
        gen = eng._generation()
        decode = gen._decode_fn

        def syncing(*a, **kw):
            torch.cuda.synchronize()     # not allowed while capturing
            return decode(*a, **kw)

        gen._decode_fn = syncing
        fut = eng.generate([1, 2, 3], max_new_tokens=4)
        with pytest.raises(RuntimeError):
            fut.result(120)
        assert not any(k[0] == "decode" for k in gen._graphs._steps)
        gen._decode_fn = decode
        assert len(eng.generate([1, 2, 3], max_new_tokens=4).result(120)) == 4
        assert any(k[0] == "decode" for k in gen._graphs._steps)


@pytest.mark.cuda
def test_predict_runs_while_the_dispatcher_captures(cuda):
    """``predict`` on the engine's dispatcher thread, in a loop, while a
    burst makes the generation dispatcher capture its steps: the streams
    equal an undisturbed engine's and predict equals the model."""
    model = _card_model(cuda)
    prompts = [[1, 2, 3], list(range(4, 17)), [9] * 21]
    with ServingEngine(model, device=cuda, **KW) as eng:
        want = [f.result(120) for f in
                [eng.generate(p, max_new_tokens=6) for p in prompts]]
    x = np.arange(20, dtype=np.int32) % VOCAB
    with torch.no_grad():
        want_logits = model(torch.as_tensor(x, device=cuda)[None])[0].cpu()
    stop = threading.Event()
    seen = []

    def hammer(eng):
        while not stop.is_set():
            seen.append(eng.predict(x, timeout=120))

    with ServingEngine(model, device=cuda, **KW) as eng:
        t = threading.Thread(target=hammer, args=(eng,))
        t.start()
        try:
            got = [f.result(120) for f in
                   [eng.generate(p, max_new_tokens=6) for p in prompts]]
        finally:
            stop.set()
            t.join(120)
        assert eng.stats()["generate"]["graphs"]["captured"] > 0
    assert got == want and seen
    for y in seen:
        torch.testing.assert_close(torch.as_tensor(y), want_logits,
                                   atol=1e-4, rtol=1e-4)
