"""The run supervisor of the port (``bigdl_tpu_torch/optim/recovery.py``)
against the JAX package's ``bigdl_tpu/optim/recovery.py``, on the CPU;
the cases of JAX's ``tests/test_recovery.py:253-290, 559-630``.

- ``RunSupervisor.run``: a failure injected mid-run restarts from the
  newest snapshot and finishes; the recovery event (cause, snapshot
  step, steps replayed, backoff) equals JAX's for the same run, and the
  parameters match a straight run within 1e-5 relative L2 (two CPU runs
  of one step drift by about 1e-7); a watchdog halt's cause; the
  repeated-failure stop; the budget; capped, jittered backoff equal to
  JAX's draws; the parsers; ``last_step_in_telemetry``; sharded
  snapshots refused naming A4; the prefetch datasets' position hooks.
- ``RunSupervisor.run_process``: one subprocess drill, under its own time
  limit: a child training on the CPU is SIGKILLed by
  ``ChaosKillTrigger(5)``, restarted from its last snapshot, and finishes
  at step 10 with the straight run's parameters.
"""

import json
import os
import random
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import SampleToMiniBatch as JToBatch
from bigdl_tpu.dataset import array_dataset as jarray
from bigdl_tpu.optim import recovery as jrec
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.optim import recovery as trec
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.utils.errors import (ConfigurationError,
                                          TrainingHaltedError,
                                          UnsupportedFeatureError)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the subprocess drill's own limit, for each child
CHILD_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _two_threads(monkeypatch):
    monkeypatch.setenv("BIGDL_FAILURE_RETRY_TIMES", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _data(n=96, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 12)).astype("float32")
    w = rng.standard_normal((12, 5)).astype("float32")
    return x, np.argmax(x @ w, axis=1).astype("int32")


def _jax_mlp():
    m = (jnn.Sequential().add(jnn.Linear(12, 32)).add(jnn.ReLU())
         .add(jnn.Linear(32, 5)))
    m.build(jax.ShapeDtypeStruct((2, 12), jnp.float32),
            rng=jax.random.PRNGKey(7))
    return m


def _mlp():
    m = (nn.Sequential().add(nn.Linear(12, 32)).add(nn.ReLU())
         .add(nn.Linear(32, 5))).to("cpu")
    return load_jax_params(m, jax.tree.map(np.asarray,
                                           _jax_mlp().parameters()[0]))


class _Boom(Trigger):
    """Raise once per test, at the first end-trigger check past
    ``at_step`` (an injected transient)."""

    stateful = True

    def __init__(self, at_step, exc=None, fired=None):
        self.at_step = at_step
        self.exc = exc or RuntimeError("injected failure")
        self.fired = fired if fired is not None else [False]

    def __call__(self, state):
        if not self.fired[0] and state.get("neval", 1) > self.at_step:
            self.fired[0] = True
            raise self.exc
        return False


def _factory(path, pkg="port", boom=None, steps=6, every=2):
    """``factory(attempt)``: a fresh optimizer on the same weights and
    data, checkpointing under ``path``; ``boom`` joins the first
    attempt's end trigger."""
    o, t = (optim, Trigger) if pkg == "port" else (joptim, joptim.Trigger)

    def factory(attempt):
        x, y = _data()
        if pkg == "port":
            opt = o.Optimizer(_mlp(),
                              array_dataset(x, y) >> SampleToMiniBatch(16),
                              nn.CrossEntropyCriterion(),
                              o.SGD(learning_rate=0.1), device="cpu")
        else:
            opt = o.LocalOptimizer(_jax_mlp(),
                                   jarray(x, y) >> JToBatch(16),
                                   jnn.CrossEntropyCriterion(),
                                   o.SGD(learning_rate=0.1))
        end = t.max_iteration(steps)
        if attempt == 0 and boom is not None:
            end = t.or_(boom, end)
        opt.set_end_when(end)
        opt.set_checkpoint(str(path), t.several_iteration(every))
        return opt
    return factory


def _event_fields(ev):
    return {k: ev[k] for k in ("restart", "cause", "at_step",
                               "snapshot_step", "steps_replayed",
                               "backoff_s")}


def test_restarts_from_the_last_snapshot_like_jax(tmp_path):
    slept, jslept = [], []
    sup = trec.RunSupervisor(max_restarts=2, backoff_base_s=0.5,
                             backoff_max_s=4.0, sleep=slept.append)
    opt = sup.run(_factory(tmp_path / "t", boom=_Boom(4)))
    assert opt.driver_state["neval"] == 7
    assert sup.restarts == 1 and slept == [0.5]
    ev = sup.events[0]
    assert set(ev) == set(trec.RECOVERY_EVENT_KEYS)
    assert ev["cause"] == "exception" and ev["snapshot"].endswith(
        "checkpoint.4.pkl")
    assert ev["at_step"] == 5 and ev["steps_replayed"] == 1

    jsup = jrec.RunSupervisor(max_restarts=2, backoff_base_s=0.5,
                              backoff_max_s=4.0, sleep=jslept.append)

    class JBoom(joptim.Trigger):
        stateful = True
        fired = False

        def __call__(self, state):
            if not JBoom.fired and state.get("neval", 1) > 4:
                JBoom.fired = True
                raise RuntimeError("injected failure")
            return False

    jsup.run(_factory(tmp_path / "j", "jax", boom=JBoom()))
    assert [_event_fields(e) for e in sup.events] == \
        [_event_fields(e) for e in jsup.events]
    assert slept == jslept

    straight = _factory(tmp_path / "s")(0)
    straight.optimize()
    for pa, pb in zip(straight.model.parameters(), opt.model.parameters()):
        assert ((pb - pa).norm() / pa.norm()).item() <= 1e-5


def test_watchdog_halt_cause(tmp_path):
    sup = trec.RunSupervisor(max_restarts=3, backoff_base_s=0.0,
                             sleep=lambda s: None)
    opt = sup.run(_factory(tmp_path, boom=_Boom(
        2, TrainingHaltedError("numerics"))))
    assert sup.events[0]["cause"] == "watchdog_halt"
    assert opt.driver_state["neval"] == 7


def test_configuration_errors_are_not_restarted(tmp_path):
    sup = trec.RunSupervisor(max_restarts=3, sleep=lambda s: None)
    with pytest.raises(ConfigurationError):
        sup.run(_factory(tmp_path, boom=_Boom(2, ConfigurationError("x"))))
    assert sup.restarts == 0


class _Dummy:
    checkpoint_path = None
    sharded_checkpoint_path = None

    def __init__(self, neval=5):
        self.driver_state = {"neval": neval}

    def optimize(self):
        raise RuntimeError("always")


def test_repeated_identical_failure_stops_early():
    sup = trec.RunSupervisor(max_restarts=10, backoff_base_s=0.0,
                             sleep=lambda s: None)
    with pytest.raises(RuntimeError, match="twice in a row"):
        sup.run(lambda attempt: _Dummy())
    assert sup.restarts == 1


def test_budget_exhausted_raises():
    sup = trec.RunSupervisor(max_restarts=2, backoff_base_s=0.0,
                             sleep=lambda s: None)
    with pytest.raises(RuntimeError, match="budget"):
        sup.run(lambda attempt: _Dummy(attempt))
    assert sup.restarts == 2


def test_backoff_caps_and_jitter_match_jax():
    sup = trec.RunSupervisor(backoff_base_s=1.0, backoff_max_s=5.0)
    assert [sup.backoff_s(i) for i in range(5)] == [1, 2, 4, 5, 5]
    got = [trec.capped_backoff(i, 0.5, 4.0, 0.25, random.Random(3))
           for i in range(6)]
    want = [jrec.capped_backoff(i, 0.5, 4.0, 0.25, random.Random(3))
            for i in range(6)]
    assert got == want
    with pytest.raises(ConfigurationError):
        trec.capped_backoff(1, 1.0, 2.0, jitter=1.5)
    with pytest.raises(ConfigurationError):
        trec.RunSupervisor(max_restarts=-1)


@pytest.mark.parametrize("spec", ["kill:9", None, "", "kill", "kill:0",
                                  "kill:x", "explode:3", "tp:2", "tp:0"])
def test_parsers_match_jax(spec):
    for name in ("parse_chaos", "parse_restart_strategy"):
        try:
            want = getattr(jrec, name)(spec)
        except Exception as e:
            with pytest.raises(ConfigurationError):
                getattr(trec, name)(spec)
            assert type(e).__name__ == "ConfigurationError"
        else:
            assert getattr(trec, name)(spec) == want


@pytest.mark.parametrize("path", ["/a/b/checkpoint.12.pkl", "/a/b/snap_7",
                                  "/a/snap_3/", None, "weird"])
def test_snapshot_step_of_matches_jax(path):
    assert trec.snapshot_step_of(path) == jrec.snapshot_step_of(path)


def test_last_step_in_telemetry_skips_a_torn_tail(tmp_path):
    p = tmp_path / "telemetry.jsonl"
    with open(p, "w") as f:
        for step in (1, 2, 3):
            f.write(json.dumps({"kind": "step", "step": step}) + "\n")
        f.write(json.dumps({"kind": "recovery", "step": 9}) + "\n")
        f.write('{"kind": "step", "st')          # SIGKILLed mid-write
    assert trec.last_step_in_telemetry(str(p)) == 4 == \
        jrec.last_step_in_telemetry(str(p))
    assert trec.last_step_in_telemetry(str(tmp_path / "none")) is None


def test_chaos_trigger_is_stateful_inside_a_composition():
    chaos = trec.ChaosKillTrigger(5)
    assert chaos.stateful and not chaos({"neval": 5})
    assert Trigger.or_(chaos, Trigger.max_iteration(9)).stateful


def test_sharded_snapshots_refused_naming_a4(tmp_path):
    class Sharded(_Dummy):
        sharded_checkpoint_path = str(tmp_path)

    sup = trec.RunSupervisor(sleep=lambda s: None)
    with pytest.raises(UnsupportedFeatureError, match="A4"):
        sup.run(lambda attempt: Sharded())
    with pytest.raises(UnsupportedFeatureError, match="A4"):
        sup.run_process(lambda attempt: None, sharded=True)


def test_prefetch_dataset_position_hooks_delegate():
    x, y = _data(24)
    ds = (array_dataset(x, y) >> SampleToMiniBatch(8)).prefetch(
        num_workers=2)
    state = ds.position_state()
    assert state is not None and state["kind"] == "local"
    next(ds.data(train=True))
    ds.restore_position(state)         # retires the live threads
    assert ds.queue_stats() is None


CHILD = textwrap.dedent('''
    import sys

    import numpy as np
    import torch

    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
    from bigdl_tpu_torch.optim import ChaosKillTrigger

    ckpt, chaos, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    g = torch.Generator().manual_seed(0)
    model = (nn.Sequential().add(nn.Linear(12, 32, generator=g))
             .add(nn.ReLU()).add(nn.Linear(32, 5, generator=g))).to("cpu")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((96, 12)).astype("float32")
    y = rng.integers(0, 5, 96).astype("int32")
    opt = optim.Optimizer(model, array_dataset(x, y) >> SampleToMiniBatch(16),
                          nn.CrossEntropyCriterion(),
                          optim.SGD(learning_rate=0.1, momentum=0.9,
                                    dampening=0.0), device="cpu")
    end = optim.Trigger.max_iteration(10)
    if chaos:
        end = optim.Trigger.or_(ChaosKillTrigger(chaos), end)
    opt.set_end_when(end)
    if ckpt != "-":
        opt.set_checkpoint(ckpt, optim.Trigger.several_iteration(4))
        opt.resume_from_checkpoint()
    opt.optimize()
    np.save(out, torch.cat([p.detach().reshape(-1)
                            for p in model.parameters()]).numpy())
    print("neval", opt.driver_state["neval"])
''')


def test_run_process_survives_a_sigkill(tmp_path):
    """The child is SIGKILLed when step 5 completes (its last snapshot
    holds neval 4), restarted from that snapshot, and finishes at step 10
    with the straight run's parameters."""
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    env = {**os.environ, "PYTHONPATH": REPO}
    rcs = []

    def launch(*args):
        return subprocess.Popen(
            ["timeout", "-s", "KILL", str(CHILD_TIMEOUT_S), sys.executable,
             str(script), *args], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)

    def spawn(attempt):
        proc = launch(str(ckpt), "5" if attempt == 0 else "0",
                      str(tmp_path / "resumed.npy"))
        rcs.append(proc)
        return proc

    sup = trec.RunSupervisor(max_restarts=2, backoff_base_s=0.0,
                             sleep=lambda s: None)
    assert sup.run_process(spawn, checkpoint_path=str(ckpt),
                           probe_step=lambda: 6) == 1
    assert rcs[0].returncode in (-9, 137), rcs[0].stdout.read()
    assert "neval 11" in rcs[1].stdout.read()
    ev = sup.events[0]
    assert ev["cause"] == "process_death" and ev["snapshot_step"] == 4
    assert ev["steps_replayed"] == 2
    straight = launch("-", "0", str(tmp_path / "straight.npy"))
    assert straight.wait() == 0
    a = np.load(tmp_path / "straight.npy")
    b = np.load(tmp_path / "resumed.npy")
    assert np.linalg.norm(a - b) / np.linalg.norm(a) <= 1e-5
