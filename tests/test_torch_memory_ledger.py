"""The port's device-memory ledger (``bigdl_tpu_torch/observability/
memory.py``) against JAX's (``bigdl_tpu/observability/memory.py``), and
the serving engine's ledger sources (``memory_ledger``,
``memory_headroom``, ``record_memory``, the pool-exhaustion dump; JAX
``serving/engine.py`` :1087-1187) on the same engine shapes, on the CPU.

Every comparison is exact: the ledgers count bytes, blocks and events.
On the CPU neither package has allocator statistics (the live, residual
and headroom fields are None in both).
"""

import gc

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu.nn.attention import TransformerLM as JaxLM
from bigdl_tpu.observability import memory as jmem
from bigdl_tpu.serving import ServingEngine as JaxEngine
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.nn import TransformerLM
from bigdl_tpu_torch.observability import memory as tmem
from bigdl_tpu_torch.serving import BlockPoolExhausted, ServingEngine

VOCAB, HIDDEN, HEADS, LAYERS, MAX_LEN = 128, 32, 2, 2, 64


class Recorder:
    """A duck-typed telemetry with JAX's surface: ``record``,
    ``set_serving_info``, ``add_observer``, ``span``."""

    def __init__(self):
        self.events, self.observers = [], []

    def record(self, kind, **fields):
        event = dict(fields, kind=kind)
        self.events.append(event)
        for fn in self.observers:
            fn(event)
        return event

    def set_serving_info(self, info):
        pass

    def add_observer(self, fn):
        self.observers.append(fn)

    def span(self, name, **kw):
        import contextlib
        return contextlib.nullcontext()

    def of(self, kind):
        return [e for e in self.events if e["kind"] == kind]


def _stats():
    return {"cuda:0": {"bytes_in_use": 1000, "peak_bytes_in_use": 1500,
                       "bytes_limit": 4000},
            "cuda:1": {"bytes_in_use": 500, "bytes_limit": 4000}}


def _sources(led):
    led.register("params", lambda: 300)
    led.register("kv_cache", lambda: {"bytes": 200, "blocks_total": 8})
    led.register("constant", 7)
    led.register("broken", lambda: 1 / 0)
    return led


@pytest.mark.parametrize("stats_fn", [_stats, lambda: None])
def test_snapshot_reconciles_as_jax_does(stats_fn):
    got = _sources(tmem.MemoryLedger(stats_fn=stats_fn)).snapshot()
    want = _sources(jmem.MemoryLedger(stats_fn=stats_fn)).snapshot()
    assert got == want
    if stats_fn is _stats:
        assert got["attributed_bytes"] + got["residual_bytes"] \
            == got["live_bytes"] == 1500
        assert got["headroom_fraction"] == 0.8125
    assert got["subsystems"]["broken"]["bytes"] is None
    assert "ZeroDivisionError" in got["subsystems"]["broken"]["error"]


def test_record_dump_once_and_tick_ring_match_jax():
    outs = {}
    for name, mod in (("port", tmem), ("jax", jmem)):
        rec = Recorder()
        led = _sources(mod.MemoryLedger(stats_fn=_stats, last_ticks=2))
        led.attach(rec)
        led.unregister("broken")
        assert led.subsystems == ("params", "kv_cache", "constant")
        for t in range(3):
            rec.record("inference", step=t, bucket=4, nested={"x": 1})
        rec.record("other", step=9)
        ev = led.record(step=5, cause="drill")
        first = led.dump("oom", error=RuntimeError("out of memory"),
                         detail={"kv": 1})
        again = led.dump("oom")
        forced = led.dump("drill", force=True)
        outs[name] = (ev, first, again, forced, led.last_ticks(), led.dumped)
    port, jax_ = outs["port"], outs["jax"]
    assert port[2] is None and jax_[2] is None
    assert port[5] and jax_[5]
    assert port[4] == jax_[4] == [{"step": 1, "bucket": 4,
                                   "kind": "inference"},
                                  {"step": 2, "bucket": 4,
                                   "kind": "inference"}]
    for a, b in ((port[0], jax_[0]), (port[1], jax_[1]),
                 (port[3], jax_[3])):
        assert set(a) == set(b)
        assert a["kind"] == b["kind"]
    assert port[1]["error"] == jax_[1]["error"]
    assert port[1]["ledger"] == jax_[1]["ledger"]


def test_tree_bytes_and_oom_markers_match_jax():
    tree = {"a": np.zeros((3, 4), np.float32), "b": [np.zeros(5, np.int8),
            (np.zeros((2, 2), np.float16),)], "c": 3, "d": ()}
    assert tmem.tree_bytes(tree) == jmem.tree_bytes(tree) == 48 + 5 + 8
    assert tmem.tree_bytes({"t": torch.zeros(3, 2, dtype=torch.bfloat16)}) \
        == 12
    for exc in (RuntimeError("RESOURCE_EXHAUSTED: out of memory"),
                ValueError("failed to allocate 3 GB"),
                BlockPoolExhausted("pool"), RuntimeError("shape mismatch"),
                None, KeyError("x")):
        assert tmem.is_oom_error(exc) == jmem.is_oom_error(exc), exc
    assert tmem.is_oom_error(torch.cuda.OutOfMemoryError("CUDA"))


def test_device_memory_stats_are_none_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this case is the CPU's: a card has statistics")
    assert tmem.device_memory_stats() is None
    snap = tmem.MemoryLedger().snapshot()
    assert snap["live_bytes"] is None and snap["headroom_bytes"] is None


# --------------------------------------------------------------------------- #
# The engine's ledger
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def lms():
    jm = JaxLM(VOCAB, HIDDEN, HEADS, LAYERS, max_len=MAX_LEN)
    jm.build(jax.ShapeDtypeStruct((2, 16), jnp.int32),
             rng=jax.random.PRNGKey(2))
    tm = TransformerLM(VOCAB, HIDDEN, HEADS, LAYERS, max_len=MAX_LEN,
                       device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.parameters()[0]))
    return jm, tm


PROMPTS = [list(range(1, 14)), list(range(1, 14)) + [40, 41], [7, 8, 9]]


@pytest.mark.parametrize("quantize", [False, True])
def test_engine_ledger_sources_and_split_match_jax(lms, quantize):
    """The same engine shape in both packages after the same
    generations: the same subsystems (the port adds ``graphs`` and its own
    ``staged``), the same parameter bytes and the same KV block split."""
    jm, tm = lms
    kw = dict(decode_slots=2, decode_max_len=48, kv_block_size=4,
              quantize=quantize)
    snaps, heads = {}, {}
    for package in ("jax", "port"):
        rec = Recorder()
        eng = JaxEngine(jm, telemetry=rec, **kw) if package == "jax" \
            else ServingEngine(tm, telemetry=rec, device="cpu", **kw)
        with eng:
            eng.memory_ledger()
            for p in PROMPTS:
                eng.generate(p, max_new_tokens=3).result(120)
            snaps[package] = eng.memory_ledger().snapshot()
            heads[package] = eng.memory_headroom()
            ev = eng.record_memory(note="x")
            assert rec.of("memory")[-1]["note"] == "x" and ev is not None
    got, want = snaps["port"], snaps["jax"]
    assert set(got["subsystems"]) == set(want["subsystems"]) | {"graphs",
                                                                 "staged"}
    assert ("params_fp32" in got["subsystems"]) == quantize
    for name in want["subsystems"]:
        if name == "kv_cache":
            continue
        assert got["subsystems"][name] == want["subsystems"][name], name
    kv, jkv = got["subsystems"]["kv_cache"], want["subsystems"]["kv_cache"]
    assert set(kv) == set(jkv)
    for key in ("blocks_total", "blocks_active", "blocks_cached",
                "blocks_free", "kv_dtype"):
        assert kv[key] == jkv[key], key
    assert kv["blocks_cached"] > 0
    assert kv["active_bytes"] + kv["cached_bytes"] + kv["free_bytes"] \
        == kv["bytes"] * kv["blocks_total"] // (kv["blocks_total"] + 1)
    assert set(heads["port"]) == set(heads["jax"])
    for key in ("headroom_bytes", "headroom_fraction", "live_bytes",
                "kv_blocks_total", "kv_blocks_free", "kv_fill"):
        assert heads["port"][key] == heads["jax"][key], key
    assert got["live_bytes"] is None and got["headroom_bytes"] is None
    assert got["subsystems"]["graphs"]["generate_graphs"] > 0


def test_staged_source_counts_retained_handles(lms):
    _jm, tm = lms
    with ServingEngine(tm, decode_slots=0, device="cpu") as eng:
        led = eng.memory_ledger()
        assert led.snapshot()["subsystems"]["staged"] == {"bytes": 0,
                                                          "handles": 0}
        h = eng.stage_weights(tm.parameters_tree())
        st = led.snapshot()["subsystems"]["staged"]
        assert st["handles"] == 1
        assert st["bytes"] >= eng.serving_model_bytes()
        del h
        gc.collect()
        assert led.snapshot()["subsystems"]["staged"]["handles"] == 0


def test_pool_exhaustion_dumps_the_ledger_once(lms):
    """Generation's ``BlockPoolExhausted`` reaches the ledger before the
    caller sees it: one ``memory_dump`` with the block occupancy, however
    many requests are shed -- as in JAX."""
    jm, tm = lms
    kw = dict(decode_slots=2, decode_max_len=48, kv_block_size=4,
              kv_blocks=4)
    dumps = {}
    for package in ("jax", "port"):
        rec = Recorder()
        eng = JaxEngine(jm, telemetry=rec, **kw) if package == "jax" \
            else ServingEngine(tm, telemetry=rec, device="cpu", **kw)
        with eng:
            for _ in range(2):
                with pytest.raises(Exception, match="exhausted"):
                    eng.generate(list(range(20)),
                                 max_new_tokens=4).result(120)
        dumps[package] = rec.of("memory_dump")
    assert len(dumps["port"]) == len(dumps["jax"]) == 1
    got, want = dumps["port"][0], dumps["jax"][0]
    assert got["reason"] == want["reason"] == "kv_block_pool_exhausted"
    assert set(got["detail"]["kv"]) == set(want["detail"]["kv"])
    assert got["detail"]["kv"]["blocks_total"] == 4
