"""The port's model-parallel facade (``bigdl_tpu_torch/optim/
strategy_optimizer.py``: ``Optimizer(strategy=...)``) against the JAX
package's ``StrategyOptimizer`` on the CPU.

In this process (a world of one, destroyed after each test): the
factory's routes and JAX's refusals and messages (unknown strategy or
keyword, an absent data axis, pp with ``tensor_parallel=True`` and orbax
snapshots naming ROADMAP A7 and A4, ``set_grad_transform``, floating
module state, frozen modules, ``set_optim_methods`` on tp and ep), the
recipe's shape refusals (``transformer-train --sp`` and ``--pp``), and a
tp checkpoint of a world of two resumed at world one (redistributed
onto the run's layout), continuing the straight run.

In a spawned gloo world of 2 ranks (``tests/_torch_strategy_worker.py``;
TransformerLM(64, 32, 4 heads, 2 layers), T 16, global batch 4, SGD
with momentum, a ``(1, 2)`` ``("data", "model")`` mesh): the tp
checkpoint's manifest ``layout`` block equals JAX's
``LayoutSpec.to_manifest()``; a port checkpoint resumed in the port at
the same layout continues the straight run; a JAX ``StrategyOptimizer``
checkpoint resumed in the port, and a port checkpoint resumed in JAX,
each match JAX's straight run; sequence-parallel validation (under the
mesh, logits gathered) matches JAX's.  Per-step losses within 1e-5
relative, parameters by relative L2 within 1e-5 (fp32 drift, ROADMAP C).
Global-norm clipping under tp is held in ``tests/test_torch_tp.py``.
"""

import numpy as np
import pytest

from _torch_strategy_worker import (REL, jax_fit, rel_l2, spawn_world,
                                    step_rel, train_case)

from bigdl_tpu.parallel.reshard import LayoutSpec as JaxLayoutSpec
from bigdl_tpu.parallel.tp import TRANSFORMER_TP_RULES as JAX_TP_RULES
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
from bigdl_tpu_torch.models import run
from bigdl_tpu_torch.optim import StrategyOptimizer
from bigdl_tpu_torch.utils.engine import Engine
from bigdl_tpu_torch.utils.errors import UnsupportedFeatureError

SPEC = {"kind": "lm", "vocab": 64, "hidden": 32, "heads": 4, "layers": 2,
        "max_len": 32}
TP = ("tp", (1, 2), ("data", "model"))


@pytest.fixture
def world_of_one():
    yield
    Engine.reset()


def _lm():
    return nn.TransformerLM(64, 32, 4, 1, max_len=32, device="cpu")


def _ds(n=4):
    x = np.random.default_rng(0).integers(0, 64, (n, 8)).astype(np.int32)
    return array_dataset(x, x) >> SampleToMiniBatch(n)


CRIT = nn.TimeDistributedCriterion(nn.FusedSoftmaxCrossEntropyCriterion())


def test_factory_routes_and_refuses(world_of_one):
    mesh = Engine.build_mesh((1, 1), ("data", "model"), device="cpu")
    opt = optim.Optimizer(_lm(), _ds(), CRIT, strategy="tp", mesh=mesh,
                          device="cpu")
    assert isinstance(opt, StrategyOptimizer) and opt.data_axis == "data"
    with pytest.raises(ValueError, match="unknown parallel strategy"):
        optim.Optimizer(_lm(), _ds(), CRIT, strategy="zz", mesh=mesh,
                        device="cpu")
    with pytest.raises(TypeError, match="to route them"):
        optim.Optimizer(_lm(), _ds(), CRIT, n_microbatches=2, device="cpu")
    with pytest.raises(TypeError, match="does not understand"):
        optim.Optimizer(_lm(), _ds(), CRIT, strategy="tp", mesh=mesh,
                        seq_axis="seq", device="cpu")
    with pytest.raises(ValueError, match="not an axis of the mesh"):
        optim.Optimizer(_lm(), _ds(), CRIT, strategy="tp", mesh=mesh,
                        data_axis="rows", device="cpu")
    pp_mesh = Engine.build_mesh((1, 1), ("data", "pipe"), device="cpu")
    pp = optim.Optimizer(_lm(), _ds(), CRIT, strategy="pp", mesh=pp_mesh,
                         device="cpu")
    assert isinstance(pp, StrategyOptimizer) and pp.strategy == "pp"
    # pp+tp is ported: it needs the "model" axis of a 3-D mesh
    with pytest.raises(ValueError, match="'model' axis"):
        optim.Optimizer(_lm(), _ds(), CRIT, strategy="pp", mesh=pp_mesh,
                        tensor_parallel=True, device="cpu")
    mesh3 = Engine.build_mesh((1, 1, 1), ("data", "pipe", "model"),
                              device="cpu")
    pptp = optim.Optimizer(_lm(), _ds(), CRIT, strategy="pp", mesh=mesh3,
                           tensor_parallel=True, device="cpu")
    assert pptp._layout_spec().plane["tensor_parallel"] is True
    with pytest.raises(UnsupportedFeatureError, match="A4"):
        opt.set_sharded_checkpoint("/nonexistent", optim.Trigger.every_epoch())
    # the "data" default degrades to None on a mesh without that axis
    only = Engine.build_mesh((1,), ("model",), device="cpu")
    assert optim.Optimizer(_lm(), _ds(), CRIT, strategy="tp", mesh=only,
                           device="cpu").data_axis is None


def test_refusals_at_optimize(world_of_one):
    mesh = Engine.build_mesh((1, 1), ("data", "model"), device="cpu")

    def tp(model, **setters):
        opt = optim.Optimizer(model, _ds(), CRIT, strategy="tp", mesh=mesh,
                              device="cpu")
        opt.set_end_when(optim.Trigger.max_iteration(1))
        for name, arg in setters.items():
            getattr(opt, name)(arg)
        return opt

    with pytest.raises(UnsupportedFeatureError, match="grad_transform"):
        tp(_lm(), set_grad_transform=lambda g: g).optimize()
    with pytest.raises(UnsupportedFeatureError, match="set_optim_methods"):
        tp(_lm(), set_optim_methods={"block0": optim.SGD()}).optimize()
    with pytest.raises(NotImplementedError, match="freeze"):
        tp(_lm().freeze()).optimize()
    bn = nn.Sequential().add(nn.Linear(4, 4)).add(nn.BatchNormalization(4))
    x = np.zeros((4, 4), np.float32)
    opt = optim.Optimizer(bn, array_dataset(x, x) >> SampleToMiniBatch(4),
                          nn.MSECriterion(), strategy="tp", mesh=mesh,
                          device="cpu")
    with pytest.raises(UnsupportedFeatureError, match="floating state"):
        opt.optimize()
    seq = Engine.build_mesh((1, 1), ("data", "seq"), device="cpu")
    opt = optim.Optimizer(_lm(), _ds(), CRIT, strategy="sp", mesh=seq,
                          device="cpu")
    with pytest.raises(ValueError, match="seq_axis_name"):
        opt.optimize()


def test_recipe_refuses_bad_shapes(world_of_one):
    base = ["transformer-train", "--device", "cpu", "--seq-len", "32",
            "-b", "4", "--maxIteration", "1", "--synthN", "8"]
    with pytest.raises(ValueError, match="pick ONE"):
        run.main(base + ["--sp", "2", "--pp", "2"])
    with pytest.raises(ValueError, match="scanLayers on"):
        run.main(base + ["--sp", "2", "--scanLayers", "on"])
    with pytest.raises(ValueError, match=r"device count 1 % degree 2"):
        run.main(base + ["--sp", "2"])
    with pytest.raises(ValueError, match=r"device count 1 % degree 2"):
        run.main(base + ["--pp", "2"])
    with pytest.raises(ValueError, match="rematPolicy has no effect"):
        run.main(base + ["--pp", "2", "--rematPolicy", "dots_saveable"])


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("facade")
    straight = train_case("straight", SPEC, *TP, steps=4)
    jax_ck = str(tmp / "jax_ck")
    manifest = jax_fit(dict(straight, steps=2), ckpt=jax_ck,
                       ckpt_every=2)[3]
    cases = [
        straight,
        dict(straight, name="port_ck", steps=2, ckpt=str(tmp / "port_ck"),
             ckpt_every=2),
        dict(straight, name="port_resume", resume=str(tmp / "port_ck")),
        dict(straight, name="jax_resume", resume=jax_ck),
        train_case("sp_val", dict(SPEC, seq_axis_name="seq"), "sp", (1, 2),
                   ("data", "seq"), steps=2, val_every=2, seed=3),
    ]
    out = spawn_world(tmp, 2, cases)
    return {c["name"]: c for c in cases}, out, tmp, manifest


def _held(got, want):
    losses, params = want
    assert np.all(step_rel(got["losses"], losses) < REL), (got["losses"],
                                                          losses)
    assert rel_l2(got["params"], params) < REL


def test_checkpoint_layout_block_is_jax(world2):
    _, out, _, jax_manifest = world2
    want = JaxLayoutSpec.tp({"data": 1, "model": 2}, rules=JAX_TP_RULES,
                            block_layout="unrolled").to_manifest()
    assert jax_manifest["layout"] == want
    for res in out["port_ck"]:
        assert res["manifest"]["layout"] == want


def test_resume_continues_the_straight_run_both_ways(world2):
    cases, out, tmp, _ = world2
    losses, params, neval, _ = jax_fit(cases["straight"])
    for res in out["straight"]:
        _held(res, (losses, params))
    # the checkpoint fired at neval 2, after the first step: a resume runs
    # steps 2-4 of the straight run
    for res in out["port_resume"] + out["jax_resume"]:
        assert res["neval"] == neval == 5
        _held(res, (losses[1:], params))
    # the port's checkpoint resumed by JAX's StrategyOptimizer
    got = jax_fit(cases["straight"], resume=str(tmp / "port_ck"))
    _held({"losses": got[0], "params": got[1]}, (losses[1:], params))


def test_sp_validation_matches_jax(world2):
    cases, out, _, _ = world2
    case = cases["sp_val"]
    losses, params, _, _ = jax_fit(case)
    want = jax_fit.last.driver_state["Loss"]
    for res in out["sp_val"]:
        _held(res, (losses, params))
        np.testing.assert_allclose(res["val_loss"], want, rtol=REL)


def test_resume_at_another_layout_is_refused(world2, world_of_one):
    """No longer refused: the tp (1, 2) checkpoint resumed at tp (1, 1)
    (``parallel/reshard.redistribute``, the identity on the logical
    trees) continues the straight world-2 run."""
    from _torch_strategy_worker import KINDS

    cases, out, tmp, _ = world2
    res = KINDS["train"](dict(cases["straight"], mesh=(1, 1),
                              resume=str(tmp / "port_ck")))
    straight = out["straight"][0]
    assert res["neval"] == 5
    _held(res, (straight["losses"][1:], straight["params"]))
