"""The port's data-parallel training (``bigdl_tpu_torch/optim/
distri_optimizer.py``) against the JAX package's ``DistriOptimizer`` on
the CPU.

The port's side runs in spawned gloo worlds of 2 and 4 ranks
(``tests/_torch_dist_worker.py``: one process a rank, ``file://``
rendezvous, one thread each, joined under the parent's own time limit);
the JAX side on meshes of the same size over ``tests/conftest.py``'s 8
CPU devices.  Both start from the same weights (the JAX model's, loaded
through ``interop``) and the same data.  One world per (size, family)
runs every port case of that family:

- ``cnn``: LeNet-5 with ``ClassNLLCriterion`` (SGD momentum, as
  ``tests/test_training.py:118-170``); the ``_dryrun_dp_zero1`` setting
  (``__graft_entry__.py:103``: ``ResNetCifar(8)``, SGD momentum, L2-norm
  clip 5.0) with per-rank BatchNorm and with SyncBN (as
  ``tests/test_parallel_equivalence.py:288, 306``); the port's DP against
  its own ``LocalOptimizer`` at the same global batch; the ranks'
  dataset orders.
- ``lm``: a 2-layer TransformerLM (d 64) with
  ``TimeDistributedCriterion(FusedSoftmaxCrossEntropyCriterion())``; the
  wires on JAX's MLP setting (``tests/test_quant_collectives.py:230``):
  fp32 against JAX, bf16 and int8 with error feedback (and the
  compressed weight gather) held to JAX's own bounds against the fp32
  trajectory (:313, 336, 362), and bf16 to JAX's bf16 run at the fp32
  parity limit; checkpoints both ways, JAX writes and the
  port resumes and the other way round, at the same and at the other
  world size, with the error-feedback plane.

Losses and parameters of the fp32 runs are held to 1e-5 relative
(per-step losses; parameters and running statistics by relative L2 over
the whole tree): fp32 reductions in another order drift about 1e-7 a
step (ROADMAP C's CPU caveat).  The two red JAX resume tests
(``test_quant_collectives.py:593, 607``) are not used as oracles.
"""

import numpy as np
import pytest

import jax
import torch

from _torch_dist_worker import spawn_world

import bigdl_tpu.nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import SampleToMiniBatch as JBatch
from bigdl_tpu.dataset import array_dataset as jarray
from bigdl_tpu.ops.quantization import CompressionSpec as JSpec
from bigdl_tpu.utils.random_generator import RNG as JRNG
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
from bigdl_tpu_torch.utils.engine import Engine
from bigdl_tpu_torch.utils.errors import UnsupportedFeatureError

#: fp32 parity with JAX, relative (module docstring)
REL = 1e-5


def rel_l2(a, b):
    a = np.concatenate([np.ravel(np.asarray(v, np.float64)) for v in a])
    b = np.concatenate([np.ravel(np.asarray(v, np.float64)) for v in b])
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def leaves(tree):
    return [np.asarray(v) for v in jax.tree.leaves(tree)]


def step_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got, want)
    return np.abs(got - want) / np.maximum(np.abs(want), 1e-6)


def mesh(n):
    return jax.sharding.Mesh(np.asarray(jax.devices()[:n]).reshape(n),
                             ("data",))


class _Losses:
    def __init__(self):
        self.losses = []

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.losses.append(float(value))


def jax_model(kind, x, seed=0):
    from bigdl_tpu.models.lenet import LeNet5
    from bigdl_tpu.models.resnet import ResNetCifar

    JRNG.set_seed(seed)
    model = {"lenet": lambda: LeNet5(),
             "resnet8": lambda: ResNetCifar(depth=8, class_num=10),
             "lm": lambda: jnn.TransformerLM(64, 64, 2, 2, max_len=16),
             "mlp": lambda: (jnn.Sequential().add(jnn.Linear(12, 32))
                             .add(jnn.ReLU()).add(jnn.Linear(32, 5)))}[kind]()
    model.build(jax.ShapeDtypeStruct(x.shape, x.dtype))
    return model


def jax_criterion(kind):
    return {"nll": jnn.ClassNLLCriterion, "ce": jnn.CrossEntropyCriterion,
            "lm": lambda: jnn.TimeDistributedCriterion(
                jnn.FusedSoftmaxCrossEntropyCriterion())}[kind]()


def jax_method(spec):
    name, kw = spec
    return {"sgd": joptim.SGD, "adam": joptim.Adam}[name](**kw)


def jax_fit(case, n, steps=None, ckpt=None, ckpt_every=None, resume=None,
            wire="same"):
    """JAX's ``DistriOptimizer`` on a mesh of ``n`` CPU devices from the
    case's initial weights; returns (losses, params, state, neval)."""
    model = jax_model(case["model"], case["x"][:case["batch"]],
                      case.get("seed", 0))
    JRNG.set_seed(case.get("seed", 0))
    ds = jarray(case["x"], case["y"]) >> JBatch(case["batch"])
    spec = case.get("wire") if wire == "same" else wire
    if isinstance(spec, dict):
        spec = JSpec(**spec)
    opt = joptim.DistriOptimizer(
        model, ds, jax_criterion(case["criterion"]),
        jax_method(case["method"]), mesh=mesh(n), grad_compression=spec,
        sync_bn=case.get("sync_bn", False))
    if case.get("clip_norm") is not None:
        opt.set_gradient_clipping_by_l2_norm(case["clip_norm"])
    opt.set_end_when(joptim.Trigger.max_iteration(steps or case["steps"]))
    if ckpt:
        opt.set_checkpoint(ckpt, joptim.Trigger.several_iteration(ckpt_every))
    if resume:
        opt.resume_from_checkpoint(resume)
    summary = _Losses()
    opt.set_train_summary(summary)
    opt.optimize()
    return (summary.losses, jax.tree.map(np.asarray, model.parameters()[0]),
            jax.tree.map(np.asarray, model.state()),
            opt.driver_state["neval"])


def port_case(name, kind, x, y, batch, method, criterion, steps, **kw):
    """A worker ``train`` case starting from the JAX model's weights."""
    jm = jax_model(kind, x[:batch], kw.get("seed", 0))
    return dict(kind="train", name=name, model=kind, x=x, y=y, batch=batch,
                method=method, criterion=criterion, steps=steps,
                params=jax.tree.map(np.asarray, jm.parameters()[0]),
                state=jax.tree.map(np.asarray, jm.state()), **kw)


def assert_ranks_agree(results):
    """Every rank ends on the same weights and saw the same batches."""
    first = results[0]
    for r in results[1:]:
        assert r["losses"] == first["losses"]
        for a, b in zip(leaves(r["params"]), leaves(first["params"])):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(r["seen"], first["seen"]):
            np.testing.assert_array_equal(a, b)


def assert_matches(port, want, rel=REL):
    losses, params, state = want[:3]
    assert np.all(step_rel(port["losses"], losses) < rel), \
        (port["losses"], losses)
    assert rel_l2(leaves(port["params"]), leaves(params)) < rel
    if leaves(state):
        assert rel_l2(leaves(port["state"]), leaves(state)) < rel


# --------------------------------------------------------------------------- #
# CNNs: LeNet-5, ResNetCifar(8) per-rank BatchNorm and SyncBN
# --------------------------------------------------------------------------- #

def _cnn_cases():
    from bigdl_tpu.dataset.mnist import synthetic_mnist

    # two global batches an epoch: the third step follows a reshuffle,
    # which every rank must draw alike
    xm, ym = synthetic_mnist(32)
    rng = np.random.default_rng(0)
    xr = rng.standard_normal((32, 16, 16, 3)).astype(np.float32)
    yr = rng.integers(0, 10, 32).astype(np.int32)
    sgd = ("sgd", dict(learning_rate=0.1, momentum=0.9, dampening=0.0))
    lenet = port_case("lenet", "lenet", xm, ym, 16, sgd, "nll", 3)
    resnet = dict(x=xr, y=yr, batch=16, method=sgd, criterion="ce",
                  steps=2, clip_norm=5.0)
    shard = port_case("resnet_shard", "resnet8", **resnet)
    sync = port_case("resnet_sync", "resnet8", sync_bn=True, **resnet)
    return [lenet, dict(lenet, name="lenet_local", local=True), shard, sync,
            dict(sync, name="resnet_local", local=True, sync_bn=False)]


@pytest.mark.parametrize("n", [2, 4])
def test_cnn_worlds_match_jax(tmp_path, n):
    cases = _cnn_cases()
    got = spawn_world(tmp_path, n, cases)
    by = {c["name"]: c for c in cases}
    for name in ("lenet", "resnet_shard", "resnet_sync"):
        assert len(got[name]) == n
        assert_ranks_agree(got[name])
        assert_matches(got[name][0], jax_fit(by[name], n))
        assert got[name][0]["route"] == "eager"        # gloo: not captured
    # the port's DP against its own LocalOptimizer on the global batch:
    # LeNet has no batch statistics, SyncBN pools them over the world
    assert_matches(got["lenet"][0], _port_result(got["lenet_local"][0]))
    assert_matches(got["resnet_sync"][0],
                   _port_result(got["resnet_local"][0]), rel=1e-4)
    # per-rank statistics normalise other rows: the trajectory differs
    assert rel_l2(leaves(got["resnet_shard"][0]["state"]),
                  leaves(got["resnet_local"][0]["state"])) > 1e-3
    # the rows of a rank are its slice of the global batch: every rank
    # fetched the same global batches, in the dataset's order
    seen = got["lenet"][0]["seen"]
    np.testing.assert_array_equal(seen[0], by["lenet"]["y"][:16])
    assert not np.array_equal(seen[2], seen[0])      # reshuffled epoch


def _port_result(r):
    return r["losses"], r["params"], r["state"]


# --------------------------------------------------------------------------- #
# TransformerLM, the wires, and checkpoints both ways
# --------------------------------------------------------------------------- #

MLP_STEPS = 30
EF = dict(wire="int8", block_size=64, error_feedback=True)


def _mlp_data(steps=MLP_STEPS, batch=64):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((steps * batch, 12)).astype(np.float32)
    y = rng.integers(0, 5, steps * batch).astype(np.int32)
    return x, y


def _lm_cases(tmp_path, n, m):
    from bigdl_tpu.models.transformer import synthetic_corpus

    x, y = synthetic_corpus(32, 16, 64)
    # SGD with momentum: Adam's first step moves an element by the rate
    # times the sign of its gradient, so a gradient of fp32 noise's size
    # would move it by the full rate either way in the two packages
    # (Adam's flat-chunk update is held against LocalOptimizer's below)
    lm = port_case("lm", "lm", x.astype(np.int32), y.astype(np.int32), 8,
                   ("sgd", dict(learning_rate=0.1, momentum=0.9,
                                dampening=0.0)), "lm", 3)
    xm, ym = _mlp_data()
    sgd = ("sgd", dict(learning_rate=0.1))
    mlp = port_case("mlp_fp32", "mlp", xm, ym, 64, sgd, "ce", MLP_STEPS)
    wires = [dict(mlp, name="mlp_bf16", wire="bf16"),
             dict(mlp, name="mlp_int8_ef", wire=EF),
             dict(mlp, name="mlp_int8_ef_gather", steps=20,
                  wire=dict(EF, compress_weight_gather=True))]
    ck = dict(mlp, steps=4, wire=EF)
    ckpts = [
        # the port's straight run, writing checkpoint.3 (after 2 steps)
        dict(ck, name="ck_write", ckpt=str(tmp_path / "port_ck"),
             ckpt_every=3),
        # resumes of JAX's checkpoints written at n and at m ranks
        dict(ck, name="ck_resume_same", resume=str(tmp_path / f"jax_ck{n}")),
        dict(ck, name="ck_resume_other",
             resume=str(tmp_path / f"jax_ck{m}")),
    ]
    return lm, [lm, mlp, *wires, *ckpts]


@pytest.mark.parametrize("n", [2, 4])
def test_lm_wires_checkpoints_match_jax(tmp_path, n):
    m = 6 - n
    lm, cases = _lm_cases(tmp_path, n, m)
    by = {c["name"]: c for c in cases}
    ck = by["ck_write"]
    # JAX's straight int8-EF runs at n and m ranks, each writing
    # checkpoint.3 after its second step
    straight = {k: jax_fit(ck, k, ckpt=str(tmp_path / f"jax_ck{k}"),
                           ckpt_every=3) for k in (n, m)}
    got = spawn_world(tmp_path, n, cases)

    # TransformerLM, fp32 wire
    assert_ranks_agree(got["lm"])
    assert_matches(got["lm"][0], jax_fit(lm, n))

    # the wires on JAX's MLP: fp32 against JAX, the others against fp32
    # within the bounds JAX's own tests hold its wires to
    base = jax_fit(by["mlp_fp32"], n)
    assert_matches(got["mlp_fp32"][0], base)
    b = np.asarray(base[0])
    bf16 = got["mlp_bf16"][0]["losses"]
    assert np.isfinite(bf16).all() and step_rel(bf16, b).max() < 1e-2
    # and to JAX's own bf16 wire at the fp32 parity limit: readings
    # 1.4e-7 (losses) and 8e-9 (parameters) at 2 and 4 ranks, where the
    # fp32 trajectory lies 1.7e-5 to 3.2e-5 and 2.7e-4 to 3.0e-4 away
    assert_matches(got["mlp_bf16"][0], jax_fit(by["mlp_bf16"], n))
    assert rel_l2(leaves(got["mlp_bf16"][0]["params"]),
                  leaves(base[1])) > REL               # the wire did cast
    q = got["mlp_int8_ef"][0]["losses"]
    assert np.isfinite(q).all()
    assert abs(q[-1] - b[-1]) / abs(b[-1]) < 5e-3
    assert step_rel(q, b).max() < 2e-2
    qg = got["mlp_int8_ef_gather"][0]["losses"]
    assert np.isfinite(qg).all() and step_rel(qg, b[:20]).max() < 5e-2
    for name in ("mlp_bf16", "mlp_int8_ef", "mlp_int8_ef_gather"):
        assert_ranks_agree(got[name])
    # the wire's bytes, counted as JAX counts them (fp32 weight gather:
    # four bytes an element of the padded plane)
    summary = got["mlp_int8_ef"][0]["wire_summary"]
    assert summary == JSpec(**EF).wire_summary(
        summary["weight_wire_bytes"] // 4)
    assert summary["grad_compression_ratio"] >= 3.5

    # checkpoints: the port's straight run tracks JAX's, and its
    # checkpoint holds JAX's keys, layout and residual plane
    _check_checkpoints(tmp_path, got, straight, n, m, ck)


#: an int8 wire rounds each element to 1/127 of its block's absmax; two
#: packages' gradients differ in the last bits, which moves a rounding
#: now and then: the EF trajectories are held to this
INT8_REL = 1e-3


def _check_checkpoints(tmp_path, got, straight, n, m, ck):
    from bigdl_tpu.utils import file_io as jfile_io

    s_losses = straight[n][0]
    write = got["ck_write"][0]
    assert np.all(step_rel(write["losses"], s_losses) < INT8_REL)
    port_ck = str(tmp_path / "port_ck" / "checkpoint.3.pkl")
    jax_ck = str(tmp_path / f"jax_ck{n}" / "checkpoint.3.pkl")
    mine, theirs = jfile_io.load(port_ck), jfile_io.load(jax_ck)
    assert set(mine) == set(theirs)
    assert set(mine["model_params"]) == {"model_params_flat", "ef_residual"}
    assert jax.tree.structure(mine["opt_state"]) == \
        jax.tree.structure(theirs["opt_state"])
    for key in ("model_params_flat", "ef_residual"):
        a, b = mine["model_params"][key], theirs["model_params"][key]
        assert a.shape == b.shape and a.dtype == b.dtype
    assert rel_l2([mine["model_params"]["model_params_flat"]],
                  [theirs["model_params"]["model_params_flat"]]) < INT8_REL
    assert np.abs(mine["model_params"]["ef_residual"]).max() > 0
    assert jfile_io.read_manifest(port_ck)["layout"] == \
        jfile_io.read_manifest(jax_ck)["layout"]

    # the port resumes JAX's checkpoints: written at n ranks (the same
    # layout) and at m (the n -> m refit and the residual's repartition)
    same = got["ck_resume_same"][0]
    assert same["neval"] == 5 and len(same["losses"]) == 2
    assert np.all(step_rel(same["losses"], s_losses[2:]) < INT8_REL)
    assert rel_l2(leaves(same["params"]), leaves(straight[n][1])) < INT8_REL
    other = got["ck_resume_other"][0]
    assert other["neval"] == 5
    assert np.all(step_rel(other["losses"], straight[m][0][2:]) < 2e-2)
    # and JAX resumes the port's, at n ranks and at m
    for k in (n, m):
        losses, params, _, neval = jax_fit(ck, k, resume=str(
            tmp_path / "port_ck"))
        assert neval == 5
        tol = INT8_REL if k == n else 2e-2
        assert np.all(step_rel(losses, straight[k][0][2:]) < tol)
        assert rel_l2(leaves(params), leaves(straight[k][1])) < tol


# --------------------------------------------------------------------------- #
# One process: the factory, the refusals, the world of one
# --------------------------------------------------------------------------- #

@pytest.fixture
def world_of_one():
    yield
    Engine.reset()


def _tiny_lm():
    m = nn.TransformerLM(64, 32, 2, 1, max_len=8, device="cpu")
    ds = array_dataset(np.zeros((8, 8), np.int32),
                       np.zeros((8, 8), np.int32)) >> SampleToMiniBatch(4)
    return m, ds


def test_refusals(world_of_one, tmp_path):
    m, ds = _tiny_lm()
    crit = nn.CrossEntropyCriterion()
    opt = optim.DistriOptimizer(m, ds, crit, device="cpu")
    with pytest.raises(UnsupportedFeatureError, match="orbax"):
        opt.set_sharded_checkpoint(str(tmp_path), optim.Trigger.every_epoch())
    with pytest.raises(ValueError):
        optim.DistriOptimizer(m, ds, crit, grad_compression="int4",
                              device="cpu")
    opt.set_grad_transform(lambda g: g)
    with pytest.raises(UnsupportedFeatureError, match="grad_transform"):
        opt.optimize()
    opt = optim.DistriOptimizer(m, ds, crit, device="cpu")
    opt.set_optim_methods({"block0": optim.SGD()})
    with pytest.raises(UnsupportedFeatureError, match="set_optim_methods"):
        opt.optimize()
    with pytest.raises(NotImplementedError, match="A8"):
        from bigdl_tpu_torch.optim.distri_optimizer import \
            make_distri_train_step

        make_distri_train_step(m, crit, optim.SGD(), None, None, None, None,
                               health_stats=True)
    assert issubclass(optim.ParallelOptimizer, optim.DistriOptimizer)
    assert optim.DistriOptimizer(m, ds, crit, device="cpu") \
        .set_gradient_compression().grad_compression is torch.bfloat16


def test_world_of_one_matches_local_optimizer(world_of_one):
    """No group initialized: ``Optimizer(distributed=True)`` starts a gloo
    world of one, whose reduce is an identity; its run equals the
    LocalOptimizer's on the same weights and batches."""
    x = np.random.default_rng(0).integers(0, 64, (16, 9)).astype(np.int32)
    runs = {}
    for dist in (False, True):
        m = nn.TransformerLM(64, 32, 2, 2, max_len=8, device="cpu", seed=1)
        ds = array_dataset(x[:, :-1], x[:, 1:]) >> SampleToMiniBatch(8)
        opt = optim.Optimizer(m, ds, nn.TimeDistributedCriterion(
            nn.FusedSoftmaxCrossEntropyCriterion()),
            optim.Adam(learning_rate=1e-3), distributed=dist, device="cpu")
        opt.set_end_when(optim.Trigger.max_iteration(3))
        summary = _Losses()
        opt.set_train_summary(summary)
        opt.optimize()
        runs[dist] = (summary.losses,
                      [p.detach().numpy().copy() for p in m.parameters()],
                      opt)
    assert isinstance(runs[True][2], optim.DistriOptimizer)
    assert runs[True][2].compiled_stats["captured"] == 1
    assert runs[True][0] == runs[False][0]
    assert rel_l2(runs[True][1], runs[False][1]) < REL
    assert torch.distributed.is_initialized()
    assert Engine.node_number() == Engine.device_count() == 1


def _mlp(seed):
    torch.manual_seed(seed)
    return (nn.Sequential().add(nn.Linear(12, 32)).add(nn.ReLU())
            .add(nn.Linear(32, 5)))


def test_serving_refreshes_from_a_flat_plane(world_of_one, tmp_path):
    """``ServingEngine.refresh_from_snapshot`` takes a data-parallel
    checkpoint: the flat plane unravels through the served model's tree
    (JAX ``reshard.to_model_layout``), the padding dropped."""
    from bigdl_tpu_torch.serving import ServingEngine

    x, y = _mlp_data(steps=2, batch=8)
    trained = _mlp(0)
    opt = optim.DistriOptimizer(
        trained, array_dataset(x, y) >> SampleToMiniBatch(8),
        nn.CrossEntropyCriterion(), optim.SGD(learning_rate=0.1),
        grad_compression=EF, device="cpu")
    opt.set_end_when(optim.Trigger.max_iteration(1))
    opt.set_checkpoint(str(tmp_path), optim.Trigger.several_iteration(1))
    opt.optimize()
    served = _mlp(1)
    with ServingEngine(served, max_batch_size=2, device="cpu") as eng:
        before = eng.predict(x[:4], timeout=60)
        eng.refresh_from_snapshot(str(tmp_path))
        after = eng.predict(x[:4], timeout=60)
    for a, b in zip(served.parameters(), trained.parameters()):
        assert torch.equal(a, b)
    with torch.no_grad():
        want = trained(torch.from_numpy(x[:4])).numpy()
    np.testing.assert_allclose(after, want, rtol=1e-6, atol=1e-6)
    assert not np.allclose(before, after)


@pytest.mark.parametrize("wire", [None, "bf16", EF])
@pytest.mark.parametrize("case", ["frozen", "norm"])
def test_world_of_one_freezing_regularizers_clipping(world_of_one, case,
                                                     wire):
    """At a world of one, against LocalOptimizer's step: a frozen module
    with a regularizer on another and clipping by value (``frozen``), and
    clipping by global norm (``norm``), under each wire (which only casts
    or rounds the gradient: held to JAX's cast bound there, to 1e-5 on
    fp32).  The two are apart because the JAX DP step masks the frozen
    positions after clipping (its norm counts their gradients,
    ``distri_optimizer.py:202-220``) where the local step zeroes them
    first."""
    x, y = _mlp_data(steps=4, batch=16)
    runs = {}
    for dist in (False, True):
        m = _mlp(0)
        first, second = m.get_submodule("0"), m.get_submodule("2")
        ds = array_dataset(x, y) >> SampleToMiniBatch(16)
        opt = optim.Optimizer(m, ds, nn.CrossEntropyCriterion(),
                              optim.SGD(learning_rate=0.1, momentum=0.9,
                                        weight_decay=1e-3),
                              distributed=dist, device="cpu")
        if case == "frozen":
            first.freeze()
            second.set_regularizer(w=optim.L2Regularizer(1e-2))
            opt.set_gradient_clipping_by_value(-0.05, 0.05)
        else:
            opt.set_gradient_clipping_by_l2_norm(0.1)
        if dist and wire is not None:
            opt.set_gradient_compression(wire)
        opt.set_end_when(optim.Trigger.max_iteration(4))
        summary = _Losses()
        opt.set_train_summary(summary)
        frozen = first.weight.detach().clone()
        opt.optimize()
        assert torch.equal(first.weight.detach(), frozen) == \
            (case == "frozen")
        runs[dist] = (summary.losses,
                      [p.detach().numpy().copy() for p in m.parameters()])
    tol = REL if wire is None else 1e-2
    assert np.all(step_rel(runs[True][0], runs[False][0]) < tol)
    assert rel_l2(runs[True][1], runs[False][1]) < tol
