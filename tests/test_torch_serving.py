"""The port's serving stack against the JAX package's, on the CPU
(``bigdl_tpu_torch/serving`` vs ``bigdl_tpu/serving``).

- ``ServingEngine.generate`` greedy streams equal JAX's on the same
  weights, paged and contiguous, and paged equals contiguous;
- ``predict`` logits match JAX's within 1e-4 (fp32, sums in another
  order);
- sampling: JAX draws threefry noise, so sampled tokens cannot match bit
  for bit; the port is held to exact greedy degenerations, replay per
  ``(seed, prompt)`` whatever the chunking or slot, and the top-k /
  top-p supports;
- ``BlockAllocator`` and ``BucketLadder``: the JAX package's cases
  (tests/test_paged.py) on the port's copies.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu.nn.attention import TransformerLM as JaxLM
from bigdl_tpu.serving import ServingEngine as JaxEngine
from bigdl_tpu.serving.buckets import BucketLadder as JaxLadder
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.nn import TransformerLM
from bigdl_tpu_torch.serving import (BlockAllocator, BlockPoolExhausted,
                                     BucketLadder, SamplingParams,
                                     ServingEngine)
from bigdl_tpu_torch.serving.sampling import sample_tokens

VOCAB, HIDDEN, HEADS, LAYERS, MAX_LEN = 512, 64, 4, 2, 128
PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11, 12, 13], [4] * 9 + [5] * 9]


@pytest.fixture(scope="module")
def models():
    jm = JaxLM(VOCAB, HIDDEN, HEADS, LAYERS, max_len=MAX_LEN)
    jm.build(jax.ShapeDtypeStruct((2, 16), jnp.int32),
             rng=jax.random.PRNGKey(3))
    tm = TransformerLM(VOCAB, HIDDEN, HEADS, LAYERS, max_len=MAX_LEN,
                       device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.parameters()[0]))
    return jm, tm


def _engine(tm, kv, **kw):
    return ServingEngine(tm, decode_slots=3, decode_max_len=48,
                         kv_cache=kv, kv_block_size=4, device="cpu", **kw)


def test_generate_greedy_matches_jax(models):
    jm, tm = models
    with JaxEngine(jm, decode_slots=3, decode_max_len=48,
                   kv_block_size=4) as eng:
        want = [f.result(120) for f in
                [eng.generate(p, max_new_tokens=6) for p in PROMPTS]]
    for kv in ("paged", "contiguous"):
        with _engine(tm, kv) as eng:
            got = [f.result(60) for f in
                   [eng.generate(p, max_new_tokens=6) for p in PROMPTS]]
        assert got == want, kv


def test_paged_equals_contiguous_with_chunked_prefill(models):
    _jm, tm = models
    prompt = list(range(1, 41))                 # five chunks of 8
    streams = {}
    for kv in ("paged", "contiguous"):
        with _engine(tm, kv, prefill_chunk=8) as eng:
            futs = [eng.generate(p, max_new_tokens=5)
                    for p in PROMPTS + [prompt]]
            streams[kv] = [f.result(60) for f in futs]
            assert all(f.first_token_s > 0 for f in futs)
    assert streams["paged"] == streams["contiguous"]


def test_predict_matches_jax(models):
    jm, tm = models
    x = np.random.default_rng(0).integers(0, VOCAB, 23).astype(np.int32)
    with JaxEngine(jm, decode_slots=0) as eng:
        want = np.asarray(eng.predict(x))
    with ServingEngine(tm, decode_slots=0, device="cpu") as eng:
        futs = [eng.submit(x), eng.submit(x)]     # coalesced in one tick
        got = eng.predict(x)
        many = [f.result(60) for f in futs]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert got.shape == (23, VOCAB)
    np.testing.assert_array_equal(many[0], many[1])


def test_sampling_replays_whatever_the_chunking_or_slot(models):
    _jm, tm = models
    prompt = list(range(3, 30))
    kw = dict(max_new_tokens=6, temperature=0.9, top_k=20, seed=7)
    runs = []
    for chunk in (4, 16):
        with _engine(tm, "paged", prefill_chunk=chunk) as eng:
            # a neighbour first, so the request lands in another slot
            other = eng.generate([9, 9, 9], max_new_tokens=8)
            runs.append(eng.generate(prompt, **kw).result(60))
            other.result(60)
            runs.append(eng.generate(prompt, **kw).result(60))
    assert runs[0] == runs[1] == runs[2] == runs[3]
    with _engine(tm, "contiguous") as eng:
        with pytest.raises(ValueError, match="paged"):
            eng.generate(prompt, **kw)


def _logits(rows=3, vocab=16, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(rows, vocab)).astype(np.float32))


def test_sample_tokens_greedy_degenerations():
    logits = _logits()
    ref = torch.argmax(logits, dim=-1).to(torch.int32)
    seeds = torch.tensor([1, 2, 3])
    pos = torch.tensor([0, 5, 9])
    z = torch.zeros(3)
    zi = torch.zeros(3, dtype=torch.int64)
    # temperature <= 0 is greedy whatever the other knobs
    assert torch.equal(sample_tokens(logits, z, zi + 7, z + 0.3, seeds, pos),
                       ref)
    # top_k=1 and top_p=0 collapse the support to rank 0
    for t, k, p in ((z + 1.0, zi + 1, z + 1.0), (z + 1.0, zi, z)):
        assert torch.equal(sample_tokens(logits, t, k, p, seeds, pos), ref)


def test_sample_tokens_pure_in_seed_and_position():
    logits = _logits(rows=2)
    t, k, p = torch.ones(2), torch.zeros(2, dtype=torch.int64), torch.ones(2)
    seeds = torch.tensor([9, 9])
    a = sample_tokens(logits, t, k, p, seeds, torch.tensor([4, 4]))
    b = sample_tokens(logits, t, k, p, seeds, torch.tensor([4, 4]))
    assert torch.equal(a, b)
    draws = {int(sample_tokens(logits[:1], t[:1], k[:1], p[:1], seeds[:1],
                               torch.tensor([q]))[0]) for q in range(24)}
    assert len(draws) > 1


def test_sample_tokens_stay_in_top_k_and_top_p_support():
    logits = _logits(rows=1, vocab=12, seed=1)
    order = torch.argsort(logits[0], descending=True)
    top2 = set(order[:2].tolist())
    probs = torch.softmax(logits[0] / 2.0, dim=-1)[order]
    # the smallest prefix whose mass reaches 0.5
    nucleus = set(order[:int((torch.cumsum(probs, 0) - probs < 0.5).sum())]
                  .tolist())
    t = torch.tensor([2.0])
    seen_k, seen_p = set(), set()
    for q in range(80):
        pos, seed = torch.tensor([q]), torch.tensor([3])
        seen_k.add(int(sample_tokens(logits, t, torch.tensor([2]),
                                     torch.ones(1), seed, pos)[0]))
        seen_p.add(int(sample_tokens(logits, t, torch.tensor([0]),
                                     torch.tensor([0.5]), seed, pos)[0]))
    assert seen_k <= top2 and len(seen_k) == 2
    assert seen_p <= nucleus


def test_sampling_params_validation():
    for bad in (dict(temperature=float("nan")), dict(top_k=-1),
                dict(top_p=1.5), dict(seed=2 ** 31)):
        with pytest.raises(ValueError):
            SamplingParams(**bad)
    assert SamplingParams().greedy
    assert not SamplingParams(temperature=0.7).greedy


def test_bucket_ladder_matches_jax():
    for args in ((32,), (1024, 8), (48, 8), (7, 1, 3)):
        assert list(BucketLadder(*args)) == list(JaxLadder(*args))
    lad = BucketLadder(8)
    assert lad.bucket_for(3) == 4 and lad.bucket_for(9) is None
    assert lad.add(9) == 9 and lad.copy().rungs == lad.rungs


class TestBlockAllocator:
    """tests/test_paged.py's host-side cases, on the port's copy."""

    def test_alloc_free_refcount(self):
        a = BlockAllocator(num_blocks=8, block_size=4)
        assert a.begin_sequence("s1", list(range(10)), 10) == 0
        st = a.stats()
        assert st["blocks_used"] == 3 and st["blocks_free"] == 5
        assert a.table_row("s1", 6)[3:] == [8, 8, 8]
        a.free_sequence("s1")
        st = a.stats()
        assert st["blocks_used"] == 0 and st["sequences"] == 0

    def test_prefix_hit_and_lru_reuse(self):
        a = BlockAllocator(num_blocks=8, block_size=4)
        prompt = list(range(9))
        a.begin_sequence("s1", prompt, 9)
        a.commit_full_blocks("s1", 9)
        assert a.begin_sequence("s2", prompt, 9) == 8
        assert a.table_row("s1", 3)[:2] == a.table_row("s2", 3)[:2]
        a.free_sequence("s1")
        a.free_sequence("s2")
        assert a.stats()["blocks_cached"] == 2
        assert a.begin_sequence("s3", prompt, 9) == 8
        a.free_sequence("s3")
        a.begin_sequence("big", list(range(100, 132)), 32)
        assert a.stats()["blocks_cached"] == 0
        a.free_sequence("big")
        assert a.begin_sequence("s4", prompt, 9) == 0

    def test_match_capped_below_last_token(self):
        a = BlockAllocator(num_blocks=8, block_size=4)
        a.begin_sequence("s1", list(range(8)), 8)
        a.commit_full_blocks("s1", 8)
        assert a.begin_sequence("s2", list(range(8)), 8) == 4

    def test_cow_detach(self):
        a = BlockAllocator(num_blocks=8, block_size=4)
        prompt = list(range(9))
        a.begin_sequence("s1", prompt, 12)
        a.commit_full_blocks("s1", 9)
        a.begin_sequence("s2", prompt, 12)
        shared = a.table_row("s2", 3)[0]
        src, dst = a.ensure_writable("s2", 2)
        assert src == shared and a.table_row("s2", 3)[0] == dst
        assert a.table_row("s1", 3)[0] == shared
        assert a.ensure_writable("s1", 2) is None
        assert a.stats()["cow_copies"] == 1

    def test_exhaustion_is_typed(self):
        a = BlockAllocator(num_blocks=4, block_size=4)
        a.begin_sequence("live", list(range(8)), 12)
        before = a.table_row("live", 3)
        with pytest.raises(BlockPoolExhausted):
            a.begin_sequence("big", list(range(100, 108)), 16)
        st = a.stats()
        assert st["sequences"] == 1 and st["sheds"] == 1
        assert a.table_row("live", 3) == before


def test_engine_sheds_an_oversize_request_and_drains(models):
    _jm, tm = models
    with ServingEngine(tm, decode_slots=2, decode_max_len=48,
                       kv_block_size=4, kv_blocks=4, device="cpu") as eng:
        with pytest.raises(BlockPoolExhausted):
            eng.generate(list(range(20)), max_new_tokens=4).result(60)
        ok = eng.generate([1, 2, 3], max_new_tokens=4)
        assert eng.drain(timeout=60)
        assert len(ok.result(1)) == 4
        with pytest.raises(RuntimeError):
            eng.generate([1, 2, 3])


def test_engine_device_none_means_the_card(models):
    """The engine defaults to the card like every entry point, and it
    serves only on the device its model lies on."""
    _jm, tm = models
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServingEngine(tm, decode_slots=0)
    with pytest.raises(ValueError, match="model on cpu"):
        ServingEngine(tm, decode_slots=0, device="meta")
