"""The port's heterogeneous Sequential pipeline
(``bigdl_tpu_torch/parallel/pp_het.py``, ``Optimizer(strategy="pp")`` on
a ``Sequential``) against the JAX package on the CPU.

JAX's sizes (``tests/test_pp.py`` ``TestHeterogeneousPipeline``): its
``_cnn`` (three 3x3 convolutions, a pooling, a linear head; input
(8, 16, 16, 3)), ``CrossEntropyCriterion``, SGD with momentum 0.9, the
JAX model's weights carried over through ``interop``.

- In this process: ``partition_sequential`` against JAX's (auto and
  explicit cuts of ``_cnn`` and of ``AlexNetOWT``, the trees with JAX's
  ``()`` entries, the errors); the refusals with JAX's types (floating
  module state, ``freeze()``, 1F1B, ``tensor_parallel``, a batch other
  than the compiled one); the facade at ``(1, 1)`` against JAX's
  single-device run.
- In spawned gloo worlds (``tests/_torch_strategy_worker.py``, ``het``
  cases; one spawn of 2 ranks, one of 4): ``(1, 2)`` auto, ``(1, 4)``
  with ``boundaries=[1, 4, 7]`` and ``(2, 2)`` auto against JAX's
  single-device ``LocalOptimizer`` over 3 steps (losses 1e-5 relative,
  inside JAX's own 5e-4; parameters rtol 2e-4, atol 2e-5), with
  ``set_validation`` held against JAX's single-device validation loss
  (a corrected expectation: JAX's facade validates a pipelined
  Sequential with ``()`` state, ``strategy_optimizer.py:557``); bf16
  against fp32 (JAX's 5e-2) with fp32 masters; token ids above 256
  crossing a boundary exact in bf16 (a corrected expectation: JAX's
  ``embed_input`` rounds them, ``pp_het.py:178-181``); checkpoints: the
  port's resumed by JAX and JAX's (its ``partition_sequential`` tree
  under the het layout) resumed by the port, a same-layout resume
  continuing the run, a cross-layout one refused with JAX's message.
- JAX's own ``make_het_pp_train_step`` at pipe 2 and its facade's resume
  of the port's checkpoint, in one child process
  (``tests/_torch_jax_pp_child.py``), against the port's world-2 runs.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_strategy_worker import REL, jax_fit, spawn_world, step_rel

import jax

from bigdl_tpu.parallel.pp_het import partition_sequential as jax_partition
from bigdl_tpu.parallel.reshard import LayoutSpec as JaxLayoutSpec
from bigdl_tpu.utils import file_io as jax_file_io
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.parallel import pp_het
from bigdl_tpu_torch.utils.engine import Engine

HERE = os.path.dirname(os.path.abspath(__file__))
CNN = {"kind": "cnn"}
IDS = {"kind": "ids", "vocab": 1024, "t": 4}
SGD = ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "dampening": 0.0})
PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-5
RESUME_RTOL, RESUME_ATOL = 1e-5, 1e-6
#: bf16 against fp32 (JAX's ``test_het_cnn_bf16_compute_dtype``)
BF16_REL = 5e-2
AXES = ("data", "pipe")
JAX_CHILD_TIMEOUT_S = 240


def _data(seed=0, n=8):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n, 16, 16, 3)).astype(np.float32),
            r.integers(0, 10, n).astype(np.int32))


def _ids():
    """Token ids 257-1023 (every one above bf16's exact integers) and
    class labels for the ``IDS`` model."""
    r = np.random.default_rng(3)
    return (r.integers(257, IDS["vocab"], (8, IDS["t"])).astype(np.int32),
            r.integers(0, 10, 8).astype(np.int32))


def _case(name, spec=CNN, x=None, y=None, mesh=(1, 2), steps=3, micro=2,
          boundaries=None, **extra):
    from _torch_strategy_worker import jax_params

    if x is None:
        x, y = _data()
    kw = {"n_microbatches": micro}
    if boundaries is not None:
        kw["boundaries"] = boundaries
    case = {"kind": "het", "name": name, "model": spec, "strategy": "pp",
            "mesh": tuple(mesh), "axes": AXES, "x": x, "y": y, "batch": 8,
            "steps": steps, "method": SGD, "criterion": "class", "seed": 5,
            "kw": kw, "params": jax_params(spec, x, seed=5)}
    case.update(extra)
    return case


def _held(res, ref, rtol=PARAM_RTOL, atol=PARAM_ATOL):
    assert np.all(step_rel(res["losses"], ref[0]) < REL), (res["losses"],
                                                          ref[0])
    for a, b in zip(jax.tree.leaves(ref[1]), jax.tree.leaves(res["params"])):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol,
                                   atol=atol)


@pytest.fixture(scope="module")
def base():
    """The parity case and JAX's single-device run of it (3 SGD steps,
    validation after the third)."""
    case = _case("base", val_every=3)
    losses, params, _, _ = jax_fit(case, strategy=None)
    return case, (losses, params, jax_fit.last.driver_state["Loss"])


def _jax_het_checkpoint(case, path):
    """JAX's LocalOptimizer after one step, re-written as JAX's het
    pickle over 2 stages: its ``partition_sequential`` tree, the
    velocity split alike, the pp manifest marked ``het``."""
    from _torch_strategy_worker import jax_model

    local = path + "_local"
    jax_fit(dict(case, val_every=None), steps=1, ckpt=local, ckpt_every=1,
            strategy=None)
    intact, _ = jax_file_io.scan_checkpoints(local)
    snap = jax_file_io.load(intact[0])
    jm = jax_model(CNN, case["x"], seed=5)
    jm.set_parameters(snap["model_params"])
    slices, tree = jax_partition(jm, 2)
    vel = snap["opt_state"]["velocity"]
    opt = dict(snap["opt_state"], velocity=[
        {str(j): vel[str(j)] for j in range(a, b)} for a, b in slices])
    layout = JaxLayoutSpec.pp({"data": 1, "pipe": 2}, 2)
    layout.plane["het"] = True
    host = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
    jax_file_io.save_checkpoint(
        path, snap["driver_state"]["neval"], host(tree), (), host(opt),
        snap["driver_state"], manifest_meta={"layout": layout.to_manifest()})
    return layout.to_manifest()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, base):
    """Every world case: one spawn of 2 ranks, then one of 4."""
    case = base[0]
    tmp = tmp_path_factory.mktemp("het")
    ck = {k: str(tmp / k) for k in ("port", "jax")}
    jax_layout = _jax_het_checkpoint(case, ck["jax"])
    ids_x, ids_y = _ids()
    w2 = [
        case,
        dict(case, name="one", steps=1, val_every=None),
        dict(case, name="bf16", steps=2, val_every=None,
             compute_dtype="bfloat16"),
        dict(case, name="ck", steps=1, val_every=None, ckpt=ck["port"],
             ckpt_every=1),
        dict(case, name="same", val_every=None, resume=ck["port"]),
        dict(case, name="from_jax", val_every=None, resume=ck["jax"]),
        dict(case, name="cross", val_every=None, resume=ck["port"],
             mesh=(2, 1), expect_error=True),
        _case("ids_bf16", IDS, ids_x, ids_y, steps=2, boundaries=[1],
              compute_dtype="bfloat16"),
        _case("ids_fp32", IDS, ids_x, ids_y, steps=2, boundaries=[1]),
    ]
    out = spawn_world(tmp_path_factory.mktemp("w2"), 2, w2)
    w4 = [dict(case, name="b147", mesh=(1, 4),
               kw={"n_microbatches": 2, "boundaries": [1, 4, 7]}),
          dict(case, name="auto22", mesh=(2, 2), val_every=None)]
    out.update(spawn_world(tmp_path_factory.mktemp("w4"), 4, w4))
    return out, ck, jax_layout


@pytest.fixture(scope="module")
def jax_child(worlds, base, tmp_path_factory):
    """JAX's het step on the parity case and JAX's facade resuming the
    port's checkpoint to 3 steps, in one child process."""
    _, ck, _ = worlds
    case = base[0]
    tmp = tmp_path_factory.mktemp("jax_het")
    job = tmp / "job.pkl"
    with open(job, "wb") as f:
        pickle.dump({"het_model": CNN, "het_params": case["params"],
                     "het_x": case["x"], "het_y": case["y"], "sgd": SGD[1],
                     "n_microbatches": 2, "het_resume": ck["port"],
                     "het_steps": 3, "tasks": ["het", "het_resume"]}, f)
    result = tmp / "jax.pkl"
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    with open(tmp / "child.log", "w") as log:
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
    assert rc == 0, (tmp / "child.log").read_text()[-3000:]
    with open(result, "rb") as f:
        return pickle.load(f)


@pytest.fixture
def world_of_one():
    yield
    Engine.reset()


# --------------------------------------------------------------------------- #
# In this process
# --------------------------------------------------------------------------- #


def _port_seq(spec, params):
    from _torch_strategy_worker import build_model

    return load_jax_params(build_model(spec), params)


def _tree_equal(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_partition_matches_jax(base):
    from _torch_strategy_worker import jax_model

    case = base[0]
    jm = jax_model(CNN, case["x"], seed=5)
    model = _port_seq(CNN, case["params"])
    for n, cut in ((1, None), (2, None), (3, None), (4, None), (3, [2, 7]),
                   (4, [1, 4, 7])):
        want = jax_partition(jm, n, cut)
        got = pp_het.partition_sequential(model, n, cut)
        assert got[0] == want[0], (n, cut)
        _tree_equal(jax.tree.map(lambda t: t.numpy(), got[1]),
                    jax.tree.map(np.asarray, want[1]))
        assert pp_het.merge_stage_params(model, got[1]).keys() == \
            set(jm._params)
    for bad in ([2], [7, 2], [0, 4, 7]):
        n = len(bad) + (2 if bad == [2] else 1)
        with pytest.raises(ValueError) as je:
            jax_partition(jm, n, bad)
        with pytest.raises(ValueError) as pe:
            pp_het.partition_sequential(model, n, bad)
        assert str(pe.value) == str(je.value)


def test_alexnet_cuts_match_jax():
    """AlexNetOWT (20 children, the card's het model) is cut where JAX
    cuts it: by parameter count, the classifier's weights deciding."""
    import jax.numpy as jnp

    from bigdl_tpu.models.alexnet import AlexNetOWT as JaxAlexNetOWT
    from bigdl_tpu_torch.models.alexnet import AlexNetOWT

    jm = JaxAlexNetOWT(1000, has_dropout=False)
    jm.build(jax.ShapeDtypeStruct((1, 224, 224, 3), jnp.float32))
    model = AlexNetOWT(1000, has_dropout=False, device="cpu")
    assert len(model._modules) == len(jm.modules) == 20
    for n in (2, 4):
        assert pp_het.partition_sequential(model, n)[0] == \
            jax_partition(jm, n)[0]


def _facade(model, x, y, mesh=None, batch=8, **kw):
    ds = array_dataset(x, y) >> SampleToMiniBatch(batch,
                                                  drop_remainder=False)
    return optim.Optimizer(model, ds, nn.CrossEntropyCriterion(),
                           optim.SGD(learning_rate=0.1), strategy="pp",
                           mesh=mesh or Engine.build_mesh((1, 1), AXES,
                                                          device="cpu"),
                           device="cpu", **kw)


def test_refusals_take_jax_types(base, world_of_one):
    """JAX's refusals, with JAX's exception types: floating module state
    and ``freeze()`` (NotImplementedError, pp_het.py:123-133), 1F1B and
    tensor parallelism on a Sequential (the UnsupportedFeatureError JAX
    raises, a NotImplementedError, strategy_optimizer.py:136-144), and a
    batch other than the compiled one (ValueError, :222-232)."""
    from bigdl_tpu.utils.errors import \
        UnsupportedFeatureError as JaxUnsupported
    from bigdl_tpu_torch.utils.errors import UnsupportedFeatureError

    assert issubclass(JaxUnsupported, NotImplementedError)
    assert issubclass(UnsupportedFeatureError, NotImplementedError)
    case = base[0]
    mesh = Engine.build_mesh((1, 1), AXES, device="cpu")
    spec = torch.empty((4, 16, 16, 3), device="meta")
    bn = (nn.Sequential()
          .add(nn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1))
          .add(nn.SpatialBatchNormalization(4))
          .add(nn.Flatten()).add(nn.Linear(4 * 16 * 16, 10)))
    with pytest.raises(NotImplementedError, match="floating module state"):
        pp_het.make_het_pp_train_step(bn, nn.CrossEntropyCriterion(),
                                      optim.SGD(), mesh, 2, spec)
    frozen = _port_seq(CNN, case["params"])
    frozen._modules["0"].freeze()
    with pytest.raises(NotImplementedError, match="freeze"):
        pp_het.make_het_pp_train_step(frozen, nn.CrossEntropyCriterion(),
                                      optim.SGD(), mesh, 2, spec)
    model = _port_seq(CNN, case["params"])
    for bad in ({"schedule": "1f1b"}, {"tensor_parallel": True}):
        with pytest.raises(UnsupportedFeatureError, match="heterogeneous"):
            _facade(model, case["x"], case["y"], mesh, **bad)
    # a batch of 4 where the step was built for 8: the facade's batch
    # selection and the step itself refuse it
    want = ("batch 4 != the compiled pipeline batch 8 (2 microbatches x 1 "
            "data shards x microbatch 4); use SampleToMiniBatch(..., "
            "drop_remainder=True) or a batch-preserving dataset")
    x4, y4 = (torch.from_numpy(a[:4]) for a in (case["x"], case["y"]))
    with pytest.raises(ValueError) as e:
        pp_het.het_rows((x4, y4), 2, 4)
    assert str(e.value) == want
    method = optim.SGD(learning_rate=0.1)
    step = pp_het.make_het_pp_train_step(model, nn.CrossEntropyCriterion(),
                                         method, mesh, 2, spec)
    state = method.init_state(dict(step.stage.named_parameters()))
    with pytest.raises(ValueError) as e:
        step(state, x4, y4)
    assert str(e.value) == want


def test_world_one_matches_jax_single_device(base, world_of_one):
    from _torch_strategy_worker import KINDS

    case, ref = base
    res = KINDS["het"](dict(case, mesh=(1, 1)))
    _held(res, ref)
    np.testing.assert_allclose(res["val_loss"], ref[2], rtol=REL)
    assert res["slices"] == [(0, 9)]


# --------------------------------------------------------------------------- #
# The spawned worlds and JAX's child
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ["base", "b147", "auto22"])
def test_worlds_match_jax_single_device(worlds, base, name):
    """(1, 2) auto, (1, 4) at boundaries [1, 4, 7] and (2, 2) auto: every
    rank's losses and gathered parameters against JAX's single-device
    run, and (1, 2)'s validation loss against JAX's single-device
    validation."""
    out, _, _ = worlds
    ref = base[1]
    ranks = out[name]
    for res in ranks:
        assert res["losses"] == ranks[0]["losses"]
        _held(res, ref)
        assert res["route"] == "eager"
    if name == "base":
        for res in ranks:
            np.testing.assert_allclose(res["val_loss"], ref[2], rtol=REL)
        assert ranks[0]["slices"] == [(0, 8), (8, 9)]
    if name == "b147":
        assert ranks[0]["slices"] == [(0, 1), (1, 4), (4, 7), (7, 9)]


def test_jax_het_step_matches_the_port(worlds, jax_child):
    """JAX's ``make_het_pp_train_step`` at pipe 2 against the port's first
    step at (1, 2): the loss and the updated parameters."""
    out, _, _ = worlds
    want = jax_child["het"]
    for res in out["one"]:
        np.testing.assert_allclose(res["losses"][0], want["loss"], rtol=REL)
        for a, b in zip(jax.tree.leaves(want["params"]),
                        jax.tree.leaves(res["params"])):
            np.testing.assert_allclose(b, a, rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL)


def test_bf16_tracks_fp32_with_fp32_masters(worlds):
    out, _, _ = worlds
    for res in out["bf16"]:
        assert np.all(step_rel(res["losses"], out["base"][0]["losses"][:2])
                      < BF16_REL), res["losses"]
        assert res["boundary_dtypes"] == ["torch.bfloat16"] * 2
        assert all(np.asarray(a).dtype == np.float32
                   for a in jax.tree.leaves(res["params"]))


def test_token_ids_cross_a_boundary_exact_in_bf16(worlds):
    """A Sequential whose stage 1 starts with a ``LookupTable``
    (``boundaries=[1]``: stage 0 is ``Identity``), ids 257-1023 in bf16:
    the boundary stays int32, so the bf16 run sees the fp32 run's ids
    and tracks it within bf16's tolerance.  JAX's ring would carry the
    ids in bf16, which rounds every one of these above 256 (checked
    here on the data), so its loss would embed other rows."""
    out, _, _ = worlds
    ids = torch.from_numpy(_ids()[0])
    assert (ids.to(torch.bfloat16).to(torch.int32) != ids).float().mean() \
        > 0.5
    for res, ref in zip(out["ids_bf16"], out["ids_fp32"]):
        assert res["boundary_dtypes"] == ["torch.int32", "torch.int32"]
        assert ref["boundary_dtypes"] == ["torch.int32", "torch.int32"]
        assert np.all(step_rel(res["losses"], ref["losses"]) < BF16_REL), \
            (res["losses"], ref["losses"])


def test_checkpoints_cross_between_the_packages(worlds, base, jax_child):
    """The port's (1, 2) checkpoint after step 1 is JAX's pickle (the
    ``partition_sequential`` tree with its ``()`` entries, the het
    layout) and JAX's facade resumes it to step 3 (the port's straight
    run); JAX's het checkpoint resumed by the port at (1, 2) gives steps
    2-3 of JAX's single-device run."""
    from _torch_strategy_worker import jax_model

    out, ck, jax_layout = worlds
    straight = out["base"][0]
    intact, _ = jax_file_io.scan_checkpoints(ck["port"])
    snap = jax_file_io.load(intact[0])
    assert out["ck"][0]["manifest"]["layout"] == jax_layout
    jm = jax_model(CNN, base[0]["x"], seed=5)
    _, tree = jax_partition(jm, 2)
    assert jax.tree.structure(snap["model_params"]) == \
        jax.tree.structure(tree)
    assert jax.tree.structure(snap["opt_state"]["velocity"]) == \
        jax.tree.structure(tree)
    got = jax_child["het_resume"]
    assert got["neval"] == 4
    np.testing.assert_allclose(got["losses"], straight["losses"][1:],
                               rtol=RESUME_RTOL)
    for a, b in zip(jax.tree.leaves(straight["params"]),
                    jax.tree.leaves(got["params"])):
        np.testing.assert_allclose(b, a, rtol=RESUME_RTOL, atol=RESUME_ATOL)
    ref = base[1]
    for res in out["from_jax"]:
        assert res["neval"] == 4
        _held(res, (ref[0][1:], ref[1]))


def test_same_layout_resume_continues_and_cross_layout_refuses(worlds):
    out, _, jax_layout = worlds
    straight = out["base"][0]
    for res in out["same"]:
        assert res["neval"] == 4
        np.testing.assert_allclose(res["losses"], straight["losses"][1:],
                                   rtol=RESUME_RTOL)
        for a, b in zip(jax.tree.leaves(straight["params"]),
                        jax.tree.leaves(res["params"])):
            np.testing.assert_allclose(b, a, rtol=RESUME_RTOL,
                                       atol=RESUME_ATOL)
    for res in out["cross"]:
        assert res["error"] == "UnsupportedFeatureError"
        assert "pp[data=1,pipe=2]/stages=2" in res["message"]
        assert "pp[data=2,pipe=1]/stages=1" in res["message"]
        assert "cannot be re-cut; resume on the original mesh" in \
            res["message"]
