"""The port's serving engine, worker, deploy controller and fleet taking
checkpoints of other layouts (``src_layout=``,
``refresh_from_snapshot``), the counterparts of JAX's
``tests/test_reshard.py`` ``TestServingLayoutAware``, on the CPU.

- Snapshots written by the port's ``Optimizer(strategy=...)`` at a world
  of one (tp ``(1, 1)``, pp ``(1, 1)``, pp+tp ``(1, 1, 1)``) and the
  pp+tp one re-written as the ``(1, 2, 2)`` and pp ``(1, 2)`` trees a
  4- and a 2-rank run write (``redistribute`` onto those layouts, as
  the optimizer's checkpoint does) hot-swap into a gated int8 engine:
  the fp32 model then holds the trained weights bit for bit, ``predict``
  equals an engine built on them, the gate ran, and the refresh built
  no step (on the card: captured no graph).
- ``refresh_params(src_layout=)`` takes pp-stacked, dp flat and
  scan-stacked trees, and ``src_layout`` without ``params`` is JAX's
  ``ValueError``.
- A data-parallel checkpoint directory refreshes an engine.
- A mismatch names the first path, as JAX's message does.
- A heterogeneous-pipeline snapshot is refused by name; JAX's engine
  rejects the same snapshot (its ``to_model_layout`` passes the list of
  per-stage subtrees through, and its contract check refuses it).
- The worker's ``stage`` op, the deploy controller's ``_load`` and the
  fleet's ``stage_weights(path=)`` stage a pp+tp snapshot by path.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as jnn
from bigdl_tpu.serving import ServingEngine as JaxEngine
from bigdl_tpu.utils.random_generator import RNG as JaxRNG
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
from bigdl_tpu_torch.interop import load_jax_params, to_jax_params
from bigdl_tpu_torch.interop.jax_params import stack_block_params
from bigdl_tpu_torch.optim.validation import AccuracyDeltaGate
from bigdl_tpu_torch.parallel.reshard import (LayoutSpec, blocks_to_pp_tree,
                                              redistribute)
from bigdl_tpu_torch.parallel.zero import FlatParamSpace
from bigdl_tpu_torch.serving import ServingEngine
from bigdl_tpu_torch.utils import file_io
from bigdl_tpu_torch.utils.engine import Engine

HOST = "127.0.0.1"
CRIT = nn.TimeDistributedCriterion(nn.CrossEntropyCriterion())


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _lm(seed=5):
    return nn.TransformerLM(64, 32, 4, 2, max_len=32, device="cpu",
                            seed=seed)


def _data(n=8, t=16):
    r = np.random.default_rng(0)
    return (r.integers(0, 64, (n, t)).astype(np.int32),
            r.integers(0, 64, (n, t)).astype(np.int32))


def _train(path, strategy, mesh_shape, axes, **kw):
    """Two SGD steps of ``_lm()`` through ``strategy`` at a world of one,
    a checkpoint after each; returns the trained model's tree (JAX
    keys)."""
    x, y = _data()
    model = _lm()
    mesh = Engine.build_mesh(mesh_shape, axes, device="cpu")
    opt = optim.Optimizer(model, array_dataset(x, y) >> SampleToMiniBatch(8),
                          CRIT, optim.SGD(learning_rate=0.5, momentum=0.9),
                          strategy=strategy, mesh=mesh, device="cpu", **kw)
    opt.set_end_when(optim.Trigger.max_iteration(2))
    opt.set_checkpoint(str(path), optim.Trigger.several_iteration(1))
    opt.optimize()
    return to_jax_params(model)


def _relayout(src_dir, dst_dir, layout):
    """The newest snapshot under ``src_dir`` re-written under ``layout``
    (its trees through ``redistribute``, the manifest's layout block
    replaced): what a run on that mesh writes for the same weights."""
    intact, _ = file_io.scan_checkpoints(str(src_dir))
    snap = file_io.load(intact[0])
    src = LayoutSpec.from_manifest(file_io.read_manifest(intact[0])["layout"])
    tree = redistribute({"params": snap["model_params"],
                         "opt_state": snap["opt_state"]}, src, layout)
    file_io.save_checkpoint(
        str(dst_dir), snap["driver_state"]["neval"], tree["params"],
        snap["model_state"], tree["opt_state"], snap["driver_state"],
        manifest_meta={"layout": layout.to_manifest()})
    return str(dst_dir)


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """``{name: (checkpoint dir, the trained tree)}`` for tp, pp, pp+tp
    at a world of one, and the pp+tp weights as (1, 2) pp and (1, 2, 2)
    pp+tp trees."""
    root = tmp_path_factory.mktemp("snaps")
    out = {}
    try:
        out["tp"] = (root / "tp", _train(root / "tp", "tp", (1, 1),
                                         ("data", "model")))
        Engine.reset()
        out["pp"] = (root / "pp", _train(root / "pp", "pp", (1, 1),
                                         ("data", "pipe"),
                                         n_microbatches=2))
        Engine.reset()
        out["pptp"] = (root / "pptp", _train(
            root / "pptp", "pp", (1, 1, 1), ("data", "pipe", "model"),
            n_microbatches=2, tensor_parallel=True))
    finally:
        Engine.reset()
    trained = out["pptp"][1]
    out["pp2"] = (_relayout(root / "pptp", root / "pp2", LayoutSpec.pp(
        {"data": 1, "pipe": 2}, 2)), trained)
    out["pptp4"] = (_relayout(root / "pptp", root / "pptp4", LayoutSpec.pp(
        {"data": 1, "pipe": 2, "model": 2}, 2, "pipe", True)), trained)
    return out


def _tree_equal(model, tree):
    got = to_jax_params(model)
    assert jax.tree.structure(got) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def _gated(model, x):
    gate = AccuracyDeltaGate(x[:4], min_top1_agreement=None,
                             max_top1_accuracy_drop=None,
                             max_logit_rmse=1.0)
    return ServingEngine(model, max_batch_size=4, max_wait_ms=1.0,
                         quantize=True, accuracy_gate=gate, device="cpu")


def test_strategy_snapshots_into_gated_replicated_engine(snapshots):
    """tp, pp and pp+tp snapshots (and the pp (1, 2) and pp+tp (1, 2, 2)
    trees) hot-swap into a gated int8 engine: the trained weights, the
    gate run on them, the answers of an engine built on them, no step
    built by the swap."""
    x, _ = _data()
    with _gated(_lm(seed=9), x) as eng:
        eng.precompile(example_feature=x[0])
        before = np.asarray(eng.predict(x[0]))
        steps0 = eng.executables()
        for name in ("tp", "pp", "pptp", "pp2", "pptp4"):
            path, trained = snapshots[name]
            eng._gate_detail = None
            eng.refresh_from_snapshot(str(path))
            _tree_equal(eng.model, trained)
            assert "logit_rmse" in str(eng._gate_detail), name
            after = np.asarray(eng.predict(x[0]))
            eng.predict(x[1])
            assert not np.array_equal(before, after)
            assert eng.executables() - steps0 == 0, name
            with _gated(load_jax_params(_lm(seed=9), trained), x) as ref:
                np.testing.assert_array_equal(
                    after, np.asarray(ref.predict(x[0])))


def test_pp_dp_and_scan_trees_accepted():
    """``refresh_params(src_layout=)`` redistributes pp-stacked, dp flat
    and scan-stacked trees onto the serving tree before the contract
    check (JAX's ``test_pp_and_dp_and_scan_trees_accepted``)."""
    model = _lm(seed=9)
    params = {k: np.asarray(v) for k, v in
              _named(to_jax_params(model)).items()}
    tree = to_jax_params(model)
    with ServingEngine(model, max_batch_size=4, max_wait_ms=1.0,
                       device="cpu") as eng:
        scaled = jax.tree.map(lambda a: np.asarray(a) * 0.5, tree)
        eng.refresh_params(blocks_to_pp_tree(scaled, 2),
                           src_layout=LayoutSpec.pp({"pipe": 2}, 2))
        _tree_equal(model, scaled)
        space = FlatParamSpace({k: torch.from_numpy(v)
                                for k, v in params.items()}, 4)
        quarter = {k: torch.from_numpy(v * 0.25) for k, v in params.items()}
        eng.refresh_params(space.flatten(quarter).numpy(),
                           src_layout=LayoutSpec.dp(
                               4, space.padded_size, space.true_size))
        _tree_equal(model, jax.tree.map(lambda a: np.asarray(a) * 0.25,
                                        tree))
        eng.refresh_params(stack_block_params(scaled),
                           src_layout=LayoutSpec.tp({"model": 2},
                                                    block_layout="scan"))
        _tree_equal(model, scaled)
        with pytest.raises(ValueError, match="pass params="):
            eng.refresh_params(src_layout=LayoutSpec.tp({"model": 2}))


def _named(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_refresh_from_pickle_checkpoint_dir(tmp_path):
    """A dp (flat-plane) pickle checkpoint directory refreshes an engine:
    the newest intact snapshot, its plane unravelled through the
    model's tree."""
    r = np.random.default_rng(3)
    x = r.standard_normal((64, 12)).astype(np.float32)
    y = r.integers(0, 5, 64).astype(np.int32)

    def seq():
        g = torch.Generator().manual_seed(7)
        return (nn.Sequential().add(nn.Linear(12, 16, generator=g))
                .add(nn.ReLU()).add(nn.Linear(16, 5, generator=g)))

    model = seq()
    try:
        opt = optim.DistriOptimizer(
            model, array_dataset(x, y) >> SampleToMiniBatch(32),
            nn.CrossEntropyCriterion(), optim.SGD(learning_rate=0.1),
            device="cpu")
        opt.set_end_when(optim.Trigger.max_iteration(2))
        opt.set_checkpoint(str(tmp_path), optim.Trigger.several_iteration(1))
        opt.optimize()
    finally:
        Engine.reset()
    with ServingEngine(seq(), max_batch_size=4, max_wait_ms=1.0,
                       device="cpu") as eng:
        before = np.asarray(eng.predict(x[0]))
        eng.refresh_from_snapshot(str(tmp_path))
        assert not np.array_equal(before, np.asarray(eng.predict(x[0])))
        _tree_equal(eng.model, to_jax_params(model))


def test_mismatch_error_names_first_path():
    """A structure or shape failure names the first mismatched path and
    both shapes and dtypes, in JAX's words."""
    JaxRNG.set_seed(1)
    jm = jnn.Sequential().add(jnn.Linear(4, 3)).add(jnn.Linear(3, 2))
    jm.build(jax.ShapeDtypeStruct((1, 4), jnp.float32))
    good = jax.tree.map(np.asarray, jm.parameters()[0])
    model = load_jax_params(nn.Sequential().add(nn.Linear(4, 3))
                            .add(nn.Linear(3, 2)), good)
    last = sorted(good)[-1]
    missing = {k: v for k, v in good.items() if k != last}
    reshaped = dict(good)
    reshaped[last] = jax.tree.map(lambda a: np.zeros((9,) + a.shape, a.dtype),
                                  good[last])
    messages = {}
    for name, eng in (("jax", JaxEngine(jm, max_batch_size=2,
                                        max_wait_ms=1.0)),
                      ("port", ServingEngine(model, max_batch_size=2,
                                             max_wait_ms=1.0,
                                             device="cpu"))):
        with eng:
            for bad in (missing, reshaped):
                with pytest.raises(ValueError) as e:
                    eng.refresh_params(bad)
                messages.setdefault(name, []).append(str(e.value))
    assert messages["port"] == messages["jax"]
    assert f"['{last}']" in messages["port"][0] and \
        "missing from the incoming" in messages["port"][0] and \
        "float32" in messages["port"][0]
    assert "expected shape" in messages["port"][1] and \
        "got shape" in messages["port"][1]


def test_het_snapshot_refused_by_name(tmp_path):
    """A heterogeneous-pipeline snapshot (a Sequential trained with
    ``strategy="pp"``): the port refuses it naming the het layout; JAX's
    engine rejects the same snapshot with a ValueError too (its
    ``to_model_layout`` returns the list of per-stage subtrees and its
    contract check refuses it)."""
    r = np.random.default_rng(5)
    x = r.standard_normal((8, 6)).astype(np.float32)
    y = r.integers(0, 3, 8).astype(np.int32)
    JaxRNG.set_seed(2)
    jm = (jnn.Sequential().add(jnn.Linear(6, 5)).add(jnn.ReLU())
          .add(jnn.Linear(5, 3)))
    jm.build(jax.ShapeDtypeStruct((1, 6), jnp.float32))
    params = jax.tree.map(np.asarray, jm.parameters()[0])

    def seq():
        return load_jax_params(nn.Sequential().add(nn.Linear(6, 5))
                               .add(nn.ReLU()).add(nn.Linear(5, 3)), params)

    try:
        opt = optim.Optimizer(
            seq(), array_dataset(x, y) >> SampleToMiniBatch(8),
            nn.CrossEntropyCriterion(), optim.SGD(learning_rate=0.1),
            strategy="pp", mesh=Engine.build_mesh((1, 1), ("data", "pipe"),
                                                  device="cpu"),
            device="cpu", n_microbatches=2)
        opt.set_end_when(optim.Trigger.max_iteration(1))
        opt.set_checkpoint(str(tmp_path), optim.Trigger.several_iteration(1))
        opt.optimize()
    finally:
        Engine.reset()
    with ServingEngine(seq(), max_batch_size=2, max_wait_ms=1.0,
                       device="cpu") as eng:
        with pytest.raises(ValueError, match=r"\(het\)"):
            eng.refresh_from_snapshot(str(tmp_path))
        _tree_equal(eng.model, params)
    with JaxEngine(jm, max_batch_size=2, max_wait_ms=1.0) as jeng:
        with pytest.raises(ValueError, match="rejected the incoming"):
            jeng.refresh_from_snapshot(str(tmp_path))


def test_worker_deploy_and_fleet_stage_by_path(snapshots, tmp_path):
    """The pp+tp (1, 2, 2) snapshot staged by path: the worker's ``stage``
    op (then ``commit``), the deploy controller's ``_load`` (the stacked
    tree and its layout, JAX deploy.py:635-641) and the fleet's
    ``stage_weights(path=)`` (JAX fleet.py:296-308) serve the trained
    weights; ``stage(params=, src_layout=)`` on a worker replica is
    JAX's ValueError."""
    from bigdl_tpu_torch.serving import deploy as td
    from bigdl_tpu_torch.serving import fleet as tf
    from bigdl_tpu_torch.serving import worker as tw

    x, _ = _data()
    path, trained = snapshots["pptp4"]
    with ServingEngine(load_jax_params(_lm(seed=9), trained),
                       max_batch_size=4, max_wait_ms=1.0,
                       device="cpu") as ref:
        want = np.asarray(ref.predict(x[0]))
    eng = ServingEngine(_lm(seed=9), max_batch_size=4, max_wait_ms=1.0,
                        device="cpu")
    srv = tw.ReplicaServer(eng, port=0).start()
    try:
        tok = tw.call(HOST, srv.port, "stage", path=str(path))
        tw.call(HOST, srv.port, "commit", token=tok, version=2)
        got = tw.call(HOST, srv.port, "predict", feature=x[0], timeout=20.0)
        np.testing.assert_array_equal(got, want)
        _tree_equal(eng.model, trained)
    finally:
        srv.close()
        eng.close()

    with ServingEngine(_lm(seed=9), max_batch_size=4, max_wait_ms=1.0,
                       device="cpu") as eng:
        ctl = td.RolloutController(eng, td.ModelRegistry(), str(path))
        params, _, src = ctl._load(str(path))
        assert src == LayoutSpec.pp({"data": 1, "pipe": 2, "model": 2}, 2,
                                    "pipe", True)
        assert set(params) == {"embed", "stages", "tail"}

    fleet = tf.ServingFleet([tf.InProcessReplica(
        ServingEngine(_lm(seed=9), max_batch_size=4, max_wait_ms=1.0,
                      device="cpu"), rid=0)])
    try:
        handle = fleet.stage_weights(path=str(path))
        fleet.commit_staged(handle, version=2)
        np.testing.assert_array_equal(
            np.asarray(fleet.replicas[0].engine.predict(x[0])), want)
        rep = tf.SubprocessReplica.__new__(tf.SubprocessReplica)
        rep.transport = "binary"
        with pytest.raises(ValueError, match="resharding snapshots cross "
                                             "as a PATH"):
            rep.stage(params={"a": np.zeros(1)}, src_layout={"kind": "tp"})
    finally:
        fleet.close()
