"""The port's versioned deployment (``bigdl_tpu_torch/serving/
deploy.py``) against the JAX package's (``bigdl_tpu/serving/deploy.py``)
on the CPU.

Held: a ``registry.json`` written by either package reads back in the
other with the same live / previous pointers and versions; the snapshot
digest and the chaos-spec parsers agree; on the same snapshots (written
by the JAX package's ``file_io``), ``RolloutController`` walks the same
sequence of (version, stage, verdict) deploy events in both packages,
for a promotion and for a poisoned candidate, with duck-typed recorders
as telemetry; a resume re-serves the live version bit for bit and
refuses a digest imposter in both packages.  A version rolled out on
the fleet's int8 weight wire is recorded so (a key the JAX reader
ignores), and a worker boots it as that wire delivered it: bit for bit
an engine given the quantized-then-dequantized tree.

The model is the fleet drill's TransformerLM (vocab 48, d 32, 4 heads, 2
layers, seq 16) from the JAX package's seed 0, carried into the port
through ``interop/jax_params.py``.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.nn.attention import TransformerLM as JaxLM
from bigdl_tpu.serving import ServingEngine as JaxEngine
from bigdl_tpu.serving import deploy as jd
from bigdl_tpu.utils import file_io as jfile_io
from bigdl_tpu.utils.errors import ConfigurationError as JaxConfigError
from bigdl_tpu.utils.random_generator import RNG as JaxRNG
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.nn import TransformerLM
from bigdl_tpu_torch.serving import ServingEngine
from bigdl_tpu_torch.serving import deploy as td
from bigdl_tpu_torch.serving.worker import boot_from_registry
from bigdl_tpu_torch.utils.errors import ConfigurationError

VOCAB, SEQ = 48, 16


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lm():
    JaxRNG.set_seed(0)
    jm = JaxLM(VOCAB, 32, 4, num_layers=2, max_len=SEQ)
    jm.build(jax.ShapeDtypeStruct((2, SEQ), jnp.int32))
    params = jax.tree.map(np.asarray, jm.parameters()[0])
    x = np.random.default_rng(0).integers(0, VOCAB, (16, SEQ)) \
        .astype(np.int32)
    return jm, params, x


def _port_engine(params, **kw):
    tm = TransformerLM(VOCAB, 32, 4, num_layers=2, max_len=SEQ,
                       device="cpu")
    load_jax_params(tm, params)
    return ServingEngine(tm, max_batch_size=4, max_wait_ms=1.0,
                         device="cpu", **kw)


def _write_snapshot(ckpt_dir, params, tag):
    os.makedirs(ckpt_dir, exist_ok=True)
    target = os.path.join(ckpt_dir, f"checkpoint.{tag}.pkl")
    jfile_io.atomic_save({"model_params": params, "model_state": None},
                         target)
    jfile_io.write_snapshot_manifest(target)
    return target


def _poison(params):
    """The drill's poisoning recipe on the head: ~zero but one huge input
    column (``tools/serve_live.py`` ``poison_params``)."""
    out = jax.tree.map(np.array, params)
    w = out["head"] * np.float32(1e-5)
    w[:, 0] = np.random.default_rng(9).standard_normal(w.shape[0]) * 1e3
    out["head"] = w.astype(np.float32)
    return out


class Recorder:
    """A duck-typed telemetry: ``record(kind, **fields)``."""

    def __init__(self):
        self.events = []
        self._lock = threading.Lock()

    def record(self, kind, **fields):
        with self._lock:
            self.events.append({"kind": kind, **fields})

    def set_serving_info(self, info):
        pass

    def deploys(self):
        return [(e["version"], e["stage"], e["verdict"])
                for e in self.events if e["kind"] == "deploy"]


# --------------------------------------------------------------------------- #
# Units.
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_registry_json_crosses_packages(tmp_path, writer):
    mods = {"jax": jd, "torch": td}
    reader = mods["torch" if writer == "jax" else "jax"]
    path = str(tmp_path / "registry.json")
    reg = mods[writer].ModelRegistry(path)
    reg.register({"h": 1}, path="/snap/a", digest="d1")
    reg.register({"h": 2}, path="/snap/b", digest="d2",
                 layout={"kind": "dp", "true_size": 7})
    reg.register({"h": 3}, path="/snap/c", digest="d3")
    reg.promote(1)
    reg.promote(2)
    reg.mark(3, "rejected")
    back = reader.ModelRegistry(path)
    assert back.describe() == reg.describe()
    assert back.live.version == 2 and back.previous.version == 1
    assert back.get(3).stage == "rejected"
    assert back.known_digests() == reg.known_digests()
    # the reader's own mutation persists in a form the writer reads
    back.rollback()
    again = mods[writer].ModelRegistry(path)
    assert again.live.version == 1 and again.previous is None
    assert again.get(2).stage == "rolled_back"


@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_boot_from_registry_serves_the_recorded_weight_wire(tmp_path, lm,
                                                            wire):
    from bigdl_tpu_torch.serving import transport as tt

    _, params, x = lm
    cand = jax.tree.map(lambda a: a * np.float32(1.01), params)
    snap = _write_snapshot(str(tmp_path / "ckpt"), cand, 4)
    path = str(tmp_path / "registry.json")
    reg = td.ModelRegistry(path)
    reg.register(None, path=snap, digest=td.snapshot_digest(snap),
                 weight_wire=wire)
    reg.promote(1)
    with open(path) as f:
        keys = set(json.load(f)["versions"][0])
    assert ("weight_wire" in keys) == (wire == "int8")
    assert jd.ModelRegistry(path).live.version == 1
    assert td.ModelRegistry(path).live.weight_wire == \
        (None if wire == "fp32" else wire)
    delivered = cand if wire == "fp32" else tt.dequantize_wire_tree(
        tt.quantize_tree_for_wire(cand))
    booted, want, exact = (_port_engine(params), _port_engine(delivered),
                           _port_engine(cand))
    try:
        assert boot_from_registry(booted, path)[0] == 1
        y = booted.predict_at(x[0], 4)
        np.testing.assert_array_equal(y, want.predict_at(x[0], 4))
        assert np.array_equal(y, exact.predict_at(x[0], 4)) \
            == (wire == "fp32")
    finally:
        for e in (booted, want, exact):
            e.close()


@pytest.mark.parametrize("spec", [None, "", "kill:cutover:2", "kill:cutover",
                                  "kill:cutover:0", "kill:step:3",
                                  "kill:replica:1@40", "kill:replica:1",
                                  "kill:replica:x@3", "kill:replica:1@0",
                                  "replica:1@2"])
def test_chaos_specs_parse_as_jax(spec):
    for parse in ("parse_deploy_chaos", "parse_fleet_chaos"):
        try:
            want = getattr(jd, parse)(spec)
        except JaxConfigError:
            with pytest.raises(ConfigurationError):
                getattr(td, parse)(spec)
        else:
            assert getattr(td, parse)(spec) == want


def test_snapshot_digest_equals_jax(tmp_path, lm):
    _, params, _ = lm
    p = _write_snapshot(str(tmp_path), params, 4)
    assert td.snapshot_digest(p) == jd.snapshot_digest(p)
    assert len(td.snapshot_digest(p)) == 16
    bare = str(tmp_path / "checkpoint.9.pkl")
    jfile_io.atomic_save({"model_params": params}, bare)
    assert td.snapshot_digest(bare) is None


# --------------------------------------------------------------------------- #
# The staged rollout, walked by both packages.
# --------------------------------------------------------------------------- #


def _traffic(engine, xs, stop, stats):
    i = 0
    while not stop.is_set():
        try:
            engine.predict(xs[i % len(xs)], timeout=20.0)
            stats["ok"] += 1
        except Exception:
            if not stop.is_set():
                stats["fail"] += 1
        i += 1


CTL = dict(shadow_fraction=1.0, shadow_min_rows=4, min_top1_agreement=None,
           max_logit_rmse=100.0, canary_fraction=0.5, canary_min_ticks=2,
           stage_timeout_s=60.0)


def _walk(pkg, engine, tmp, snaps):
    """Baseline, then each snapshot through ``poll_once`` under traffic;
    -> (deploy events, live version, registry path)."""
    mod = {"jax": jd, "torch": td}[pkg]
    rec = Recorder()
    reg = mod.ModelRegistry(os.path.join(tmp, f"{pkg}_registry.json"))
    ckpt = os.path.join(tmp, f"{pkg}_ckpt")
    ctl = mod.RolloutController(engine, reg, ckpt, telemetry=rec, **CTL)
    ctl.baseline()
    stop, stats = threading.Event(), {"ok": 0, "fail": 0}
    t = threading.Thread(target=_traffic,
                         args=(engine, snaps["xs"], stop, stats),
                         daemon=True)
    t.start()
    try:
        for tag, params in snaps["walk"]:
            _write_snapshot(ckpt, params, tag)
            v = ctl.poll_once()
            assert v is not None
            assert ctl.poll_once() is None      # seen: not walked again
    finally:
        stop.set()
        t.join(10)
    assert stats["fail"] == 0 and stats["ok"] > 0
    return rec.deploys(), reg.live.version, reg.path


@pytest.mark.parametrize("case", ["promote", "poison"])
def test_rollout_walks_as_jax_does(tmp_path, lm, case):
    jm, params, x = lm
    healthy = jax.tree.map(lambda a: a * np.float32(1.01), params)
    walk = [(4, healthy)]
    if case == "poison":
        walk.append((8, _poison(params)))
    snaps = {"xs": x, "walk": walk}
    jeng = JaxEngine(jm, max_batch_size=4, max_wait_ms=1.0)
    try:
        want = _walk("jax", jeng, str(tmp_path), snaps)
    finally:
        jeng.close()
    teng = _port_engine(params)
    try:
        got = _walk("torch", teng, str(tmp_path), snaps)
    finally:
        teng.close()
    assert got[0] == want[0]
    assert got[1] == want[1] == 2
    expect = [(1, "live", "ok"), (2, "registered", "ok"),
              (2, "shadow", "ok"), (2, "canary", "ok"),
              (2, "cutover", "ok"), (2, "live", "ok")]
    if case == "poison":
        expect += [(3, "registered", "ok"), (3, "shadow", "rejected")]
    assert got[0] == expect


def test_resume_restages_and_refuses_an_imposter(tmp_path, lm):
    """A fresh engine resumes the registry's live version bit for bit (and
    a fresh worker boots it); after the snapshot is replaced behind the
    registry's back, resume and boot refuse it in the port, as
    ``resume`` does in the JAX package."""
    jm, params, x = lm
    ckpt = str(tmp_path / "ckpt")
    reg_path = str(tmp_path / "registry.json")
    eng = _port_engine(params)
    try:
        ctl = td.RolloutController(eng, td.ModelRegistry(reg_path), ckpt,
                                   **CTL)
        ctl.baseline()
        snap = _write_snapshot(ckpt, jax.tree.map(
            lambda a: a * np.float32(1.01), params), 4)
        stop, stats = threading.Event(), {"ok": 0, "fail": 0}
        t = threading.Thread(target=_traffic, args=(eng, x, stop, stats),
                             daemon=True)
        t.start()
        try:
            assert ctl.poll_once().stage == "live"
        finally:
            stop.set()
            t.join(10)
        y_live = eng.predict_at(x[0], 4)
    finally:
        eng.close()
    eng2 = _port_engine(params)
    eng3 = _port_engine(params)
    try:
        ctl2 = td.RolloutController(eng2, td.ModelRegistry(reg_path), ckpt)
        assert ctl2.resume().version == 2
        np.testing.assert_array_equal(y_live, eng2.predict_at(x[0], 4))
        assert ctl2.poll_once() is None          # the live one is seen
        assert boot_from_registry(eng3, reg_path)[0] == 2
        np.testing.assert_array_equal(y_live, eng3.predict_at(x[0], 4))
    finally:
        eng2.close()
        eng3.close()
    _write_snapshot(ckpt, jax.tree.map(lambda a: a * np.float32(9.0),
                                       params), 4)
    assert os.path.exists(snap)
    eng4 = _port_engine(params)
    jeng = JaxEngine(jm, max_batch_size=4, max_wait_ms=1.0)
    try:
        with pytest.raises(RuntimeError, match="imposter"):
            td.RolloutController(eng4, td.ModelRegistry(reg_path),
                                 ckpt).resume()
        with pytest.raises(RuntimeError, match="imposter"):
            boot_from_registry(eng4, reg_path)
        with pytest.raises(RuntimeError, match="imposter"):
            jd.RolloutController(jeng, jd.ModelRegistry(reg_path),
                                 ckpt).resume()
    finally:
        eng4.close()
        jeng.close()


def _serve_live(tmp_path, name, *extra, timeout=300):
    """``tools/torch_serve_live.py`` as a child process, its output in a
    file; terminated (then killed) if it outlives ``timeout``."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    out = tmp_path / "live"
    with open(tmp_path / f"{name}.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tools.torch_serve_live", "--device",
             "cpu", "--out", str(out), "--shadowRows", "8", "--canaryTicks",
             "2", "--idleRounds", "4", *extra],
            cwd=repo, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(30)
    return rc, out


@pytest.mark.slow
def test_live_loop_rejects_poison_and_resumes_after_a_cutover_kill(
        tmp_path):
    """The live drills of ``tools/torch_serve_live.py`` (the JAX package's
    are slow-marked too): a poisoned candidate is rejected in shadow with
    zero failed requests; a driver SIGKILLed mid-way through its second
    cutover resumes, with ``--noTrainer``, the last committed version and
    serves its probe digest bit for bit."""
    rc, out = _serve_live(tmp_path, "poison", "--poison", "--steps", "6",
                          "--ckptEvery", "6")
    assert rc == 0, (tmp_path / "poison.log").read_text()[-3000:]
    with open(out / "result.json") as f:
        r = json.load(f)
    assert r["client"]["failed"] == 0 and r["live_version"] == 2
    assert [3, "shadow", "rejected"] in [
        [d["version"], d["stage"], d["verdict"]] for d in r["deploys"]]
    chaos = tmp_path / "chaos"
    chaos.mkdir()
    rc, out = _serve_live(chaos, "kill", "--chaos", "kill:cutover:2",
                          "--steps", "12", "--ckptEvery", "6")
    assert rc == -9, (chaos / "kill.log").read_text()[-3000:]
    with open(out / "chaos_fired.json") as f:
        fired = json.load(f)
    history = [json.loads(line) for line in open(out / "live_history.jsonl")]
    committed = [h for h in history if h["version"] < fired["version"]][-1]
    rc, out = _serve_live(chaos, "resume", "--noTrainer")
    assert rc == 0, (chaos / "resume.log").read_text()[-3000:]
    with open(out / "result.json") as f:
        r = json.load(f)
    assert r["resumed"] and r["live_version"] == committed["version"]
    assert r["probe_digest"] == committed["probe"]
