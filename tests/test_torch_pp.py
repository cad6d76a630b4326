"""The port's pipeline parallelism (``bigdl_tpu_torch/parallel/pp.py``,
``Optimizer(strategy="pp")``, ``transformer-train --pp``) against the
JAX package on the CPU.

JAX's sizes (``tests/test_pp.py``): TransformerLM(64, 32, 4 heads, 4
layers, max_len 32), B8 T16, tokens from ``numpy.random.default_rng``,
the JAX model's weights carried over through ``interop``, SGD with
momentum 0.9.

- In this process (a world of one, destroyed after each test): the
  stage stacking bitwise JAX's ``stack_stage_params`` and a rank's stage
  its slice (and its ``"model"`` shards: ``tp.shard_params``' pieces);
  the facade's construction checks and refusals (a Sequential takes the
  heterogeneous pipeline, and refuses 1F1B and ``tensor_parallel`` with
  JAX's type; ``tensor_parallel=True`` stamps JAX's pp+tp layout);
  GPipe and 1F1B at ``(1, 1)``; a JAX-format pp pickle (JAX's
  ``stack_stage_params`` and ``save_checkpoint`` with
  ``LayoutSpec.pp``'s manifest) resumed by the port; the pp+tp
  checkpoint resumed at a world of one as pp+tp ``(1, 1, 1)``.
- In spawned gloo worlds (``tests/_torch_strategy_worker.py``, ``pp``
  cases; one spawn of 4 ranks, then one of 2): GPipe and 1F1B at
  ``(data, pipe)`` = ``(1, 2)``, ``(1, 4)``, ``(2, 2)`` with validation
  every 3 steps, held against JAX's single-device ``LocalOptimizer``
  over 3 steps (losses within 1e-5 relative; parameters within rtol
  2e-4, atol 2e-5, JAX's own pp bound, ``tests/test_pp.py:98-99``; the
  validation loss within 1e-5: JAX's facade validates a pipelined
  Sequential with ``()`` state and crashes, the port validates the
  gathered model); ``make_pp_loss_fn`` against JAX's first loss; 1F1B
  against GPipe under attention dropout (1e-6 relative: JAX's threefry
  masks cannot be matched) and in bf16 (5e-3); a 4-stage checkpoint
  resumed as 2 stages and a tp checkpoint resumed as pp, each against
  the straight run (rtol 1e-5, atol 1e-6, JAX's
  ``test_pp_recut_pickle_resume`` bound); a port pp checkpoint loaded by
  JAX (``pp_tree_to_blocks`` of its trees equals the port's logical
  parameters and moments); clipping by global norm over the logical
  tree; an uneven cut raising in every entry point; ``transformer-train
  --pp 2``.
- pp with tensor parallelism (``tensor_parallel=True`` on a ``("data",
  "pipe", "model")`` mesh), in the 4-rank spawn: GPipe and 1F1B at
  ``(1, 2, 2)`` against JAX's single-device run (the bounds above, inside
  JAX's own ``test_1f1b_composes_with_tensor_parallel_3d`` bounds: loss
  5e-4, parameters rtol 2e-3, atol 2e-5); a pp ``(1, 4)`` checkpoint
  resumed as pp+tp, and a pp+tp checkpoint resumed as pp ``(1, 2)`` and
  as tp ``(1, 2)`` in the 2-rank spawn.
- JAX's own GPipe and 1F1B steps at pipe 2, and its pp+tp steps
  (``pp_tp_shardings``, ``manual_axes=("data", "pipe")``) on a ``(1, 2,
  2)`` mesh of four CPU devices, one step each, in one child process
  (``tests/_torch_jax_pp_child.py``), against the port's world-2 and
  world-4 steps.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_strategy_worker import (REL, jax_fit, spawn_world, step_rel,
                                    train_case)

import jax

from bigdl_tpu.parallel.pp import stack_stage_params as jax_stack
from bigdl_tpu.parallel.reshard import LayoutSpec as JaxLayoutSpec
from bigdl_tpu.parallel.reshard import blocks_to_pp_tree as jax_to_pp
from bigdl_tpu.parallel.reshard import pp_tree_to_blocks as jax_to_blocks
from bigdl_tpu.utils import file_io as jax_file_io
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
from bigdl_tpu_torch.interop import (load_jax_params, load_jax_pp_params,
                                     to_jax_pp_params)
from bigdl_tpu_torch.optim import StrategyOptimizer
from bigdl_tpu_torch.parallel import pp as ppm
from bigdl_tpu_torch.utils.engine import Engine
from bigdl_tpu_torch.utils.errors import UnsupportedFeatureError

HERE = os.path.dirname(os.path.abspath(__file__))
SPEC = {"kind": "lm", "vocab": 64, "hidden": 32, "heads": 4, "layers": 4,
        "max_len": 32}
SGD = ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "dampening": 0.0})
PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-5
RESUME_RTOL, RESUME_ATOL = 1e-5, 1e-6
AXES = ("data", "pipe")
AXES3 = ("data", "pipe", "model")
CRIT = nn.TimeDistributedCriterion(nn.FusedSoftmaxCrossEntropyCriterion())
#: (mesh, microbatches) of the parity cases
LAYOUTS = {"11": ((1, 1), 2), "12": ((1, 2), 2), "14": ((1, 4), 4),
           "22": ((2, 2), 2)}
JAX_CHILD_TIMEOUT_S = 240


def _case(name, mesh=(1, 2), micro=2, schedule="gpipe", steps=3, **extra):
    case = train_case(name, SPEC, "pp", mesh, AXES, n=8, t=16, batch=8,
                      steps=steps, method=SGD, seed=5,
                      kw={"n_microbatches": micro, "schedule": schedule},
                      **extra)
    case["kind"] = "pp"
    return case


@pytest.fixture(scope="module")
def base():
    """The parity runs' case and JAX's single-device run of it (3 SGD
    steps, validation after the third)."""
    case = _case("base", val_every=3)
    losses, params, neval, _ = jax_fit(case, strategy=None)
    return case, (losses, params, jax_fit.last.driver_state["Loss"])


@pytest.fixture
def world_of_one():
    yield
    Engine.reset()


def _held(res, ref, rtol=PARAM_RTOL, atol=PARAM_ATOL):
    losses, params = ref[0], ref[1]
    assert np.all(step_rel(res["losses"], losses) < REL), (res["losses"],
                                                          losses)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(res["params"])):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol,
                                   atol=atol)


def _pptp(schedule):
    """A case's pp+tp settings: ``(1, 2, 2)`` over ``("data", "pipe",
    "model")``, 2 microbatches."""
    return {"mesh": (1, 2, 2), "axes": AXES3,
            "kw": {"n_microbatches": 2, "schedule": schedule,
                   "tensor_parallel": True}}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, base):
    """Every world case: one spawn of 4 ranks (its 4-stage checkpoint
    resumed by the second), then one of 2."""
    case = base[0]
    tmp = tmp_path_factory.mktemp("pp")
    ck = {k: str(tmp / k) for k in ("pp4", "tp", "pp2", "pptp")}
    w4 = [dict(case, name=f"{lay}_{sch}", mesh=LAYOUTS[lay][0],
               kw={"n_microbatches": LAYOUTS[lay][1], "schedule": sch})
          for lay in ("14", "22") for sch in ("gpipe", "1f1b")]
    w4.append(dict(case, name="pp4_ck", mesh=(1, 4), steps=2,
                   ckpt=ck["pp4"], ckpt_every=2, val_every=None,
                   kw={"n_microbatches": 4, "schedule": "gpipe"}))
    for sch in ("gpipe", "1f1b"):
        w4.append(dict(case, name=f"pptp_{sch}", **_pptp(sch)))
        w4.append(dict(case, name=f"one_pptp_{sch}", steps=1,
                       val_every=None, **_pptp(sch)))
    w4.append(dict(case, name="pptp_ck", steps=2, ckpt=ck["pptp"],
                   ckpt_every=2, val_every=None, **_pptp("gpipe")))
    w4.append(dict(case, name="pptp_from_pp4", resume=ck["pp4"],
                   val_every=None, **_pptp("gpipe")))
    out = spawn_world(tmp_path_factory.mktemp("w4"), 4, w4)
    tp = train_case("tp_ck", SPEC, "tp", (1, 2), ("data", "model"), n=8,
                    t=16, batch=8, steps=2, method=SGD, seed=5,
                    ckpt=ck["tp"], ckpt_every=2)
    x, y = case["x"], case["y"]
    w2 = [dict(case, name=f"12_{sch}",
               kw={"n_microbatches": 2, "schedule": sch})
          for sch in ("gpipe", "1f1b")]
    w2 += [dict(case, name=f"one_{sch}", steps=1, val_every=None,
                kw={"n_microbatches": 2, "schedule": sch})
           for sch in ("gpipe", "1f1b")]
    for sch in ("gpipe", "1f1b"):
        w2.append(dict(case, name=f"drop_{sch}", steps=2, val_every=None,
                       dropout=0.25,
                       kw={"n_microbatches": 2, "schedule": sch}))
        w2.append(dict(case, name=f"bf16_{sch}", steps=2, val_every=None,
                       compute_dtype="bfloat16",
                       kw={"n_microbatches": 2, "schedule": sch}))
    w2 += [
        dict(case, name="from_pp4", resume=ck["pp4"], val_every=None),
        tp,
        dict(case, name="from_tp", resume=ck["tp"], val_every=None),
        dict(case, name="from_pptp", resume=ck["pptp"], val_every=None),
        dict(tp, name="tp_from_pptp", resume=ck["pptp"], ckpt=None,
             steps=3),
        dict(case, name="clip", clip_norm=0.5, val_every=None),
        dict(case, name="pp2_ck", steps=1, ckpt=ck["pp2"], ckpt_every=1,
             val_every=None, kw={"n_microbatches": 2, "schedule": "1f1b"}),
        {"kind": "pp", "name": "uneven", "uneven": True, "mesh": (1, 2),
         "axes": AXES, "model": dict(SPEC, layers=3), "criterion": "fused",
         "x": x, "y": y, "batch": 8},
        {"kind": "recipe", "name": "recipe", "argv": [
            "transformer-train", "--device", "cpu", "--pp", "2",
            "--pp-schedule", "1f1b", "--seq-len", "16", "-b", "4",
            "--vocab", "64", "--maxIteration", "2", "--synthN", "16"]},
    ]
    out.update(spawn_world(tmp_path_factory.mktemp("w2"), 2, w2))
    return out, ck


# --------------------------------------------------------------------------- #
# In this process: stacking, the facade's checks, world 1
# --------------------------------------------------------------------------- #


def _port_lm(params, layers=4):
    model = nn.TransformerLM(64, 32, 4, layers, max_len=32, device="cpu")
    return load_jax_params(model, params)


def test_stage_stacking_is_jax(base):
    from _torch_strategy_worker import jax_model

    case = base[0]
    jm = jax_model(SPEC, case["x"], seed=5)
    model = _port_lm(case["params"])
    for n_stages in (1, 2, 4):
        want = jax.tree.map(np.asarray, jax_stack(jm, n_stages))
        got = ppm.stack_stage_params(model, n_stages)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            np.testing.assert_array_equal(b.numpy(), a)
        assert jax.tree.all(jax.tree.map(
            lambda a, b: np.array_equal(a.numpy(), np.asarray(b)),
            ppm.unstack_stage_params(model, got), case["params"]))
        np.testing.assert_array_equal(
            to_jax_pp_params(model, n_stages)["stages"]["layer0"]["fc1"][
                "weight"], want["stages"]["layer0"]["fc1"]["weight"])
        # a rank's stage is the slice JAX's pp_shardings places there
        for s in range(n_stages):
            stage = ppm.PipelineStage(model, s, n_stages)
            local = stage.parameters_tree()
            for j in range(4 // n_stages):
                for (_, a), (_, b) in zip(
                        sorted(_flat(want["stages"][f"layer{j}"])),
                        sorted(_flat(local[f"layer{j}"]))):
                    np.testing.assert_array_equal(b.numpy(), a[s])
            np.testing.assert_array_equal(local["head"].numpy(),
                                          want["tail"]["head"])
    back = _port_lm(case["params"])
    load_jax_pp_params(back, jax.tree.map(np.asarray, jax_stack(jm, 2)))
    assert all(torch.equal(a, b) for a, b in zip(back.parameters(),
                                                 model.parameters()))
    with pytest.raises(ValueError, match="divide evenly"):
        ppm.stack_stage_params(model, 3)
    with pytest.raises(ValueError, match="divide evenly"):
        ppm.PipelineStage(model, 0, 3)


def test_pp_tp_stage_holds_the_model_shards(base):
    """A pp+tp rank's stage: its blocks' leaves are the ``"model"`` shards
    of JAX's ``pp_tp_shardings`` (the sharded dimension halved at tp 2,
    q, k and v cut by heads), the embedding and the tail whole; the two
    ranks' pieces give back the logical leaf."""
    import types

    from jax.sharding import Mesh

    from bigdl_tpu.parallel.pp import pp_tp_shardings

    case = base[0]
    model = _port_lm(case["params"])
    jmesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1), AXES3)
    stacked = jax_stack(_jax_lm(case), 2)
    specs = dict(_flat(jax.tree.map(
        lambda sh: tuple(sh.spec), pp_tp_shardings(stacked, jmesh),
        is_leaf=lambda x: hasattr(x, "spec"))["stages"]))
    for s in range(2):
        stages = [ppm.PipelineStage(model, s, 2, tp=types.SimpleNamespace(
            world=2, rank=r)) for r in range(2)]
        assert stages[0].layers[0].attn.num_heads == 2
        for name, piece in stages[0].named_parameters():
            logical = dict(model.named_parameters())[
                stages[0].logical_name(name)].detach()
            if name.split(".")[0] in ("wte", "wpe", "ln_f", "head"):
                assert torch.equal(piece, logical)
                continue
            spec = specs[f"layer{int(name[5])}." + name.split(".", 1)[1]]
            pieces = [dict(st.named_parameters())[name].detach()
                      for st in stages]
            if "model" not in spec:
                assert stages[0].tp_specs[name] == () and \
                    all(torch.equal(p, logical) for p in pieces)
                continue
            dim = spec.index("model") - 1
            assert pieces[0].shape[dim] * 2 == logical.shape[dim], name
            if "qkv" in name:
                whole = torch.cat([torch.stack(p.unflatten(
                    0, (3, -1)).unbind(0)) for p in pieces], 1).flatten(0, 1)
            else:
                whole = torch.cat(pieces, dim)
            assert torch.equal(whole, logical), name


def _jax_lm(case):
    from _torch_strategy_worker import jax_model

    jm = jax_model(SPEC, case["x"], seed=5)
    jm.set_parameters(jax.tree.map(np.asarray, case["params"]))
    return jm


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_facade_checks_and_refusals(world_of_one):
    x = np.zeros((8, 16), np.int32)
    ds = array_dataset(x, x) >> SampleToMiniBatch(8)
    lm = nn.TransformerLM(64, 32, 4, 4, max_len=32, device="cpu")
    mesh = Engine.build_mesh((1, 1), AXES, device="cpu")

    def pp(model=lm, m=mesh, **kw):
        return optim.Optimizer(model, ds, CRIT, optim.SGD(), strategy="pp",
                               mesh=m, device="cpu", **kw)

    opt = pp(n_microbatches=2, schedule="1f1b")
    assert isinstance(opt, StrategyOptimizer) and opt.data_axis == "data"
    assert opt._layout_spec().to_manifest() == JaxLayoutSpec.pp(
        {"data": 1, "pipe": 1}, 1).to_manifest()
    with pytest.raises(ValueError, match="unknown pp schedule"):
        pp(schedule="zigzag")
    with pytest.raises(TypeError, match="boundaries"):
        pp(boundaries=[1])
    with pytest.raises(TypeError, match="does not understand"):
        pp(rules=[])
    # a Sequential takes the heterogeneous pipeline (its layout marked
    # "het"), which refuses 1F1B and tensor parallelism as JAX does
    # (NotImplementedError, strategy_optimizer.py:136-144)
    seq = nn.Sequential().add(nn.Linear(8, 8)).add(nn.ReLU())
    het = pp(model=seq)
    assert het._layout_spec().to_manifest() == dict(
        JaxLayoutSpec.pp({"data": 1, "pipe": 1}, 1).to_manifest(), het=True)
    for bad in ({"schedule": "1f1b"}, {"tensor_parallel": True}):
        with pytest.raises(NotImplementedError, match="heterogeneous"):
            pp(model=seq, **bad)
    # tensor_parallel=True needs the "model" axis, and stamps JAX's
    # pp+tp layout
    with pytest.raises(ValueError, match="'model' axis"):
        pp(tensor_parallel=True)
    mesh3 = Engine.build_mesh((1, 1, 1), AXES3, device="cpu")
    assert pp(m=mesh3, tensor_parallel=True)._layout_spec().to_manifest() \
        == JaxLayoutSpec.pp({"data": 1, "pipe": 1, "model": 1}, 1, "pipe",
                            True).to_manifest()
    with pytest.raises(ValueError, match="not an axis of the mesh"):
        pp(m=Engine.build_mesh((1, 1), ("data", "model"), device="cpu"))

    def run(model=lm, method=None, **setters):
        o = optim.Optimizer(model, ds, CRIT, method or optim.SGD(),
                            strategy="pp", mesh=mesh, device="cpu")
        o.set_end_when(optim.Trigger.max_iteration(1))
        for name, arg in setters.items():
            getattr(o, name)(arg)
        return o.optimize

    with pytest.raises(UnsupportedFeatureError, match="set_optim_methods"):
        run(set_optim_methods={"block0": optim.SGD()})()
    with pytest.raises(UnsupportedFeatureError, match="grad_transform"):
        run(set_grad_transform=lambda g: g)()
    with pytest.raises(NotImplementedError, match="freeze"):
        run(model=nn.TransformerLM(64, 32, 4, 2, max_len=32,
                                   device="cpu").freeze())()
    with pytest.raises(UnsupportedFeatureError, match="Fused"):
        run(method=optim.Fused(optim.SGD()))()
    scanned = nn.TransformerLM(64, 32, 4, 2, max_len=32, device="cpu",
                               scan_layers=True)
    with pytest.raises(UnsupportedFeatureError, match="scan_layers"):
        run(model=scanned)()


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_world_one_matches_jax_single_device(base, schedule, world_of_one,
                                             tmp_path):
    from _torch_strategy_worker import KINDS

    case, ref = base
    res = KINDS["pp"](dict(case, mesh=(1, 1), kw={
        "n_microbatches": 2, "schedule": schedule}))
    _held(res, ref)
    np.testing.assert_allclose(res["val_loss"], ref[2], rtol=REL)
    np.testing.assert_allclose(res["first_loss"], ref[0][0], rtol=REL)


def test_jax_pp_pickle_resumes_in_the_port(base, tmp_path, world_of_one):
    """A JAX LocalOptimizer checkpoint after step 1 re-written as JAX's pp
    pickle over 2 stages (``stack_stage_params``, the moments by
    ``blocks_to_pp_tree``, ``save_checkpoint`` with the pp manifest),
    resumed by the port at pp (1, 1): steps 2-3 of the straight run."""
    from _torch_strategy_worker import KINDS, jax_model

    case, ref = base
    local = str(tmp_path / "local")
    jax_fit(dict(case, val_every=None), steps=1, ckpt=local, ckpt_every=1,
            strategy=None)
    intact, _ = jax_file_io.scan_checkpoints(local)
    snap = jax_file_io.load(intact[0])
    jm = jax_model(SPEC, case["x"], seed=5)
    jm.set_parameters(snap["model_params"])
    opt = dict(snap["opt_state"],
               velocity=jax_to_pp(snap["opt_state"]["velocity"], 2))
    pp_dir = str(tmp_path / "pp")
    host = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
    jax_file_io.save_checkpoint(
        pp_dir, snap["driver_state"]["neval"], host(jax_stack(jm, 2)), (),
        host(opt), snap["driver_state"], manifest_meta={"layout": JaxLayoutSpec.pp(
            {"data": 1, "pipe": 2}, 2).to_manifest()})
    res = KINDS["pp"](dict(case, mesh=(1, 1), resume=pp_dir, val_every=None))
    assert res["neval"] == 4
    _held(res, (ref[0][1:], ref[1]))


# --------------------------------------------------------------------------- #
# The spawned worlds
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("layout", ["12", "14", "22"])
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_worlds_match_jax_single_device(worlds, base, layout, schedule):
    out, _ = worlds
    ref = base[1]
    ranks = out[f"{layout}_{schedule}"]
    assert len(ranks) == np.prod(LAYOUTS[layout][0])
    for res in ranks:
        assert res["losses"] == ranks[0]["losses"]
        _held(res, ref)
        np.testing.assert_allclose(res["val_loss"], ref[2], rtol=REL)
        np.testing.assert_allclose(res["first_loss"], ref[0][0], rtol=REL)


def test_1f1b_equals_gpipe_under_dropout_and_in_bf16(worlds):
    out, _ = worlds
    g, f = out["drop_gpipe"][0], out["drop_1f1b"][0]
    assert np.all(step_rel(f["losses"], g["losses"]) < 1e-6), (f, g)
    clean = out["one_gpipe"][0]["losses"][0]
    assert g["losses"][0] != clean          # the masks are drawn
    g, f = out["bf16_gpipe"][0], out["bf16_1f1b"][0]
    assert np.all(step_rel(f["losses"], g["losses"]) < 5e-3), (f, g)
    assert all(np.asarray(a).dtype == np.float32
               for a in jax.tree.leaves(f["params"]))


def test_resume_across_layouts(worlds, base):
    """pp (1, 4) -> pp (1, 2), tp (1, 2) -> pp (1, 2), pp (1, 4) -> pp+tp
    (1, 2, 2), and pp+tp (1, 2, 2) -> pp (1, 2) and -> tp (1, 2): steps
    2-3 of the straight pp (1, 2) run."""
    out, _ = worlds
    straight = out["12_gpipe"][0]
    for name in ("from_pp4", "from_tp", "pptp_from_pp4", "from_pptp",
                 "tp_from_pptp"):
        for res in out[name]:
            assert res["neval"] == 4
            np.testing.assert_allclose(res["losses"], straight["losses"][1:],
                                       rtol=RESUME_RTOL)
            for a, b in zip(jax.tree.leaves(straight["params"]),
                            jax.tree.leaves(res["params"])):
                np.testing.assert_allclose(b, a, rtol=RESUME_RTOL,
                                           atol=RESUME_ATOL)
    assert out["pp4_ck"][0]["manifest"]["layout"] == JaxLayoutSpec.pp(
        {"data": 1, "pipe": 4}, 4).to_manifest()
    assert out["pptp_ck"][0]["manifest"]["layout"] == JaxLayoutSpec.pp(
        {"data": 1, "pipe": 2, "model": 2}, 2, "pipe", True).to_manifest()


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pp_tp_worlds_match_jax_single_device(worlds, base, schedule):
    """pp+tp at (1, 2, 2): every rank's losses, validation loss and
    gathered parameters against JAX's single-device run."""
    out, _ = worlds
    ref = base[1]
    ranks = out[f"pptp_{schedule}"]
    assert len(ranks) == 4
    for res in ranks:
        assert res["losses"] == ranks[0]["losses"]
        _held(res, ref)
        np.testing.assert_allclose(res["val_loss"], ref[2], rtol=REL)
        np.testing.assert_allclose(res["first_loss"], ref[0][0], rtol=REL)
        assert res["route"] == "eager"


def test_pp_tp_checkpoint_resumes_at_a_world_of_one(worlds, base,
                                                    world_of_one):
    """The pp+tp (1, 2, 2) checkpoint resumed by pp+tp at (1, 1, 1) (one
    stage, tp 1): steps 2-3 of the straight run."""
    from _torch_strategy_worker import KINDS

    out, ck = worlds
    straight = out["12_gpipe"][0]
    res = KINDS["pp"](dict(base[0], resume=ck["pptp"], val_every=None,
                           mesh=(1, 1, 1), axes=AXES3,
                           kw={"n_microbatches": 2, "schedule": "1f1b",
                               "tensor_parallel": True}))
    assert res["neval"] == 4
    np.testing.assert_allclose(res["losses"], straight["losses"][1:],
                               rtol=RESUME_RTOL)
    for a, b in zip(jax.tree.leaves(straight["params"]),
                    jax.tree.leaves(res["params"])):
        np.testing.assert_allclose(b, a, rtol=RESUME_RTOL, atol=RESUME_ATOL)


def test_port_pp_checkpoint_loads_in_jax(worlds):
    out, ck = worlds
    res = out["pp2_ck"][0]
    intact, _ = jax_file_io.scan_checkpoints(ck["pp2"])
    snap = jax_file_io.load(intact[0])
    assert res["manifest"]["layout"] == JaxLayoutSpec.pp(
        {"data": 1, "pipe": 2}, 2).to_manifest()
    assert jax.tree.leaves(snap["model_params"]["stages"])[0].shape[0] == 2
    got = jax_to_blocks(snap["model_params"])
    for a, b in zip(jax.tree.leaves(res["params"]), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(b), a)
    moments = jax_to_blocks(snap["opt_state"]["velocity"])
    for a, b in zip(jax.tree.leaves(res["opt_state"]["velocity"]),
                    jax.tree.leaves(moments)):
        np.testing.assert_array_equal(np.asarray(b), a)
    assert int(snap["opt_state"]["neval"]) == \
        int(res["opt_state"]["neval"]) == 1


def test_global_norm_clipping_spans_the_logical_tree(worlds, base):
    """Clipping by global norm at pipe 2: each stage's blocks counted
    once, the replicated embedding and tail once (JAX clips the whole
    stacked tree in one jit; its single-device run is the reference)."""
    out, _ = worlds
    case = dict(base[0], clip_norm=0.5, val_every=None)
    losses, params, _, _ = jax_fit(case, strategy=None)
    assert losses[1] != base[1][0][1]           # the clip acts
    for res in out["clip"]:
        _held(res, (losses, params))


def test_uneven_cut_raises_everywhere(worlds):
    out, _ = worlds
    for errors in out["uneven"]:
        assert set(errors) == {"stack_stage_params", "make_pp_loss_fn",
                               "make_pp_1f1b_train_step", "Optimizer"}
        for name, msg in errors.items():
            assert msg is not None and "divide evenly" in msg, name


def test_recipe_trains_pipelined(worlds):
    out, _ = worlds
    for res in out["recipe"]:
        assert res["strategy"] == "pp"
        assert res["mesh"] == {"data": 1, "pipe": 2}
        assert len(res["losses"]) == 2 and np.all(np.isfinite(res["losses"]))
    assert out["recipe"][0]["losses"] == out["recipe"][1]["losses"]


def test_jax_pp_steps_match_the_port(worlds, base, tmp_path):
    """JAX's GPipe and 1F1B steps at pipe 2, and its pp+tp steps at (1, 2,
    2), in one child process, against the port's world-2 and world-4
    steps on the same weights and batch."""
    out, _ = worlds
    case = base[0]
    job = tmp_path / "job.pkl"
    with open(job, "wb") as f:
        pickle.dump({"model": SPEC, "params": case["params"], "x": case["x"],
                     "y": case["y"], "sgd": SGD[1], "n_microbatches": 2,
                     "tasks": ["pp", "pp_tp"]}, f)
    result = tmp_path / "jax.pkl"
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    with open(tmp_path / "child.log", "w") as log:
        child = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_torch_jax_pp_child.py"),
             str(job), str(result)], env=env, stdout=log,
            stderr=subprocess.STDOUT)
        try:
            rc = child.wait(timeout=JAX_CHILD_TIMEOUT_S)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait(timeout=30)
    assert rc == 0, (tmp_path / "child.log").read_text()[-3000:]
    with open(result, "rb") as f:
        got = pickle.load(f)
    for task, prefix in (("pp", "one"), ("pp_tp", "one_pptp")):
        for sch in ("gpipe", "1f1b"):
            want = got[task][sch]
            for port in out[f"{prefix}_{sch}"]:
                np.testing.assert_allclose(port["losses"][0], want["loss"],
                                           rtol=REL)
                for a, b in zip(jax.tree.leaves(want["params"]),
                                jax.tree.leaves(port["params"])):
                    np.testing.assert_allclose(b, a, rtol=PARAM_RTOL,
                                               atol=PARAM_ATOL)
