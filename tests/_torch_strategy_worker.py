"""One rank of a spawned gloo world for the port's model-parallel tests
(tests/test_torch_tp.py, test_torch_sequence.py, test_torch_moe_ep.py,
test_torch_strategy_facade.py, test_torch_pp.py).

    python tests/_torch_strategy_worker.py RANK WORLD INIT_FILE JOBS OUT_DIR

Joins the world through a ``file://`` rendezvous on one thread (the
rules of ``_torch_dist_worker.py``, whose ``spawn_world`` starts it:
``spawn_world`` here), runs every case of the pickled ``JOBS`` list in
order on a mesh of the case's shape over the whole world
(``Engine.build_mesh``), and writes each case's result to
``OUT_DIR/<name>.rank<RANK>.pkl``.  Imports torch and the port only.

Case kinds:

- ``train``: a model of the port loaded with the JAX parameters the
  case carries, trained through ``Optimizer(strategy=...)``; the result
  holds the per-step losses, the final parameters in the JAX keys, the
  step count, the route and the manifest of a checkpoint written;
- ``attention``: ring or Ulysses attention of this rank's sequence
  block of global q, k, v, its output and the gradients of
  ``sum(out * w)``;
- ``vocab_ce``: the vocabulary-parallel cross-entropy of this rank's
  shard of global logits: losses, lse and the shard's gradient;
- ``moe``: an expert-parallel ``MoE`` layer's output on this rank's rows
  and its aux loss;
- ``shard``: ``tp.shard_params`` / ``gather_params`` of a logical tree;
- ``recipe``: ``models.run transformer-train`` with the case's flags;
- ``pp``: a ``train`` case under ``strategy="pp"`` (attention dropout
  and a compute dtype when the case names them, ``tensor_parallel``
  on a ``("data", "pipe", "model")`` mesh), its result also holding
  the logical optimizer state in the JAX keys and the loss of
  ``parallel.pp.make_pp_loss_fn`` on the first batch before training;
  or, with ``"uneven": True``, the error each pp entry point raises for
  a model whose blocks do not divide over the pipe;
- ``het``: a ``Sequential`` (``build_model``'s ``"cnn"`` or ``"ids"``)
  trained through the heterogeneous pipeline; its result also holds
  the stages' child ranges and boundary dtypes; with ``"expect_error"``
  the error the run raises instead.
"""

import os
import pickle
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
for _p in (REPO, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from _torch_dist_worker import spawn_world as _spawn_world  # noqa: E402


def spawn_world(tmp_path, world, cases, timeout=240):
    """``_torch_dist_worker.spawn_world`` running this file's ranks."""
    return _spawn_world(tmp_path, world, cases, timeout,
                        script=os.path.abspath(__file__))


class _Losses:
    def __init__(self):
        self.losses = []

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.losses.append(float(value))


def build_model(spec):
    """A model of the port from a spec dict (``kind`` "lm" or "moe", or
    the Sequentials "cnn" -- JAX's ``tests/test_pp.py`` ``_cnn``, input
    (N, 16, 16, 3) -- and "ids": token ids through ``Identity`` and a
    ``LookupTable`` of ``vocab`` rows, input (N, T))."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.nn.moe import MoETransformerLM

    s = dict(spec)
    kind = s.pop("kind")
    if kind in ("cnn", "ids"):
        return seq_model(nn, spec, device="cpu")
    if kind == "lm":
        return nn.TransformerLM(s["vocab"], s["hidden"], s["heads"],
                                s["layers"], max_len=s["max_len"],
                                device="cpu",
                                seq_axis_name=s.get("seq_axis_name"),
                                seq_mode=s.get("seq_mode", "ring"))
    return MoETransformerLM(s["vocab"], s["hidden"], s["heads"],
                            s["layers"], s["experts"], k=s.get("k", 2),
                            max_len=s["max_len"],
                            capacity_factor=s.get("capacity_factor", 1.25),
                            device="cpu")


def seq_model(nn, spec, device=None):
    """The ``"cnn"`` / ``"ids"`` Sequential of ``spec`` in the package
    ``nn`` (the port's, with ``device``, or the JAX package's)."""
    kw = {} if device is None else {"device": device}
    if spec["kind"] == "cnn":
        conv = nn.SpatialConvolution
        m = (nn.Sequential()
             .add(conv(3, 8, 3, 3, 1, 1, 1, 1))
             .add(nn.ReLU())
             .add(conv(8, 16, 3, 3, 1, 1, 1, 1))
             .add(nn.ReLU())
             .add(nn.SpatialMaxPooling(2, 2, 2, 2))
             .add(conv(16, 16, 3, 3, 1, 1, 1, 1))
             .add(nn.ReLU())
             .add(nn.Flatten())
             .add(nn.Linear(16 * 8 * 8, 10)))
    else:
        m = (nn.Sequential()
             .add(nn.Identity())
             .add(nn.LookupTable(spec["vocab"], 8))
             .add(nn.Flatten())
             .add(nn.Linear(spec["t"] * 8, 10)))
    if kw:
        m.to(kw["device"])
    return m


def build_criterion(kind):
    from bigdl_tpu_torch import nn

    if kind == "class":
        return nn.CrossEntropyCriterion()
    inner = {"fused": nn.FusedSoftmaxCrossEntropyCriterion,
             "ce": nn.CrossEntropyCriterion}[kind]()
    return nn.TimeDistributedCriterion(inner)


def build_method(spec):
    from bigdl_tpu_torch import optim

    name, kw = spec
    return {"sgd": optim.SGD, "adam": optim.Adam}[name](**kw)


def train(case):
    from bigdl_tpu_torch.interop import load_jax_params

    model = build_model(case["model"])
    load_jax_params(model, case["params"])
    return _fit(case, model)[0]


def _fit(case, model):
    """``(result, optimizer)`` of a ``train`` case on ``model``."""
    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
    from bigdl_tpu_torch.interop import to_jax_params
    from bigdl_tpu_torch.utils import file_io
    from bigdl_tpu_torch.utils.engine import Engine
    from bigdl_tpu_torch.utils.random_generator import RNG

    RNG.set_seed(case.get("seed", 0))
    mesh = Engine.build_mesh(case["mesh"], case["axes"], device="cpu")
    ds = array_dataset(case["x"], case["y"]) >> SampleToMiniBatch(
        case["batch"])
    opt = optim.Optimizer(model, ds, build_criterion(case["criterion"]),
                          build_method(case["method"]),
                          strategy=case["strategy"], mesh=mesh,
                          device="cpu", **case.get("kw", {}))
    if case.get("clip_norm") is not None:
        opt.set_gradient_clipping_by_l2_norm(case["clip_norm"])
    if case.get("compute_dtype"):
        import torch

        opt.set_compute_dtype(getattr(torch, case["compute_dtype"]))
    opt.set_end_when(optim.Trigger.max_iteration(case["steps"]))
    if case.get("ckpt"):
        opt.set_checkpoint(case["ckpt"], optim.Trigger.several_iteration(
            case.get("ckpt_every", 2)))
    if case.get("resume"):
        opt.resume_from_checkpoint(case["resume"])
    if case.get("val_every"):
        opt.set_validation(optim.Trigger.several_iteration(case["val_every"]),
                           ds, [optim.Loss(build_criterion(
                               case["criterion"]))])
    summary = _Losses()
    opt.set_train_summary(summary)
    opt.optimize()
    manifest = None
    if case.get("ckpt"):
        intact, _ = file_io.scan_checkpoints(case["ckpt"])
        manifest = file_io.read_manifest(intact[0]) if intact else None
    return {"losses": summary.losses, "params": to_jax_params(model),
            "neval": opt.driver_state["neval"], "route": opt.captured_route,
            "manifest": manifest, "val_loss": opt.driver_state.get("Loss")}, \
        opt


def attention(case):
    import torch

    from bigdl_tpu_torch.parallel.ring_attention import \
        sequence_shard_attention
    from bigdl_tpu_torch.parallel.ulysses import ulysses_self_attention
    from bigdl_tpu_torch.utils.engine import Engine

    mesh = Engine.build_mesh(case["mesh"], case["axes"], device="cpu")
    coll = mesh.collectives("seq")
    t = case["q"].shape[1] // coll.world
    sl = slice(coll.rank * t, (coll.rank + 1) * t)
    w = torch.from_numpy(case["w"][:, sl].copy())
    if case["mode"] == "ring":
        # the whole sequence on every rank; the helper takes this rank's
        # block of it, so the gradient lands in that block alone
        q, k, v = (torch.from_numpy(case[n]).requires_grad_(True)
                   for n in ("q", "k", "v"))
        out = sequence_shard_attention(q, k, v, mesh, "seq",
                                       causal=case["causal"])
    else:
        q, k, v = (torch.from_numpy(case[n][:, sl].copy())
                   .requires_grad_(True) for n in ("q", "k", "v"))
        out = ulysses_self_attention(q, k, v, coll, causal=case["causal"])
    (out * w).sum().backward()
    block = sl if case["mode"] == "ring" else slice(None)
    return {"out": out.detach().numpy(), "dq": q.grad[:, block].numpy(),
            "dk": k.grad[:, block].numpy(), "dv": v.grad[:, block].numpy()}


def vocab_ce(case):
    import torch

    from bigdl_tpu_torch.ops.cross_entropy import (
        combine_shard_stats, fused_softmax_cross_entropy_shard_fwd,
        shard_labels, vocab_parallel_cross_entropy)
    from bigdl_tpu_torch.utils.engine import Engine

    mesh = Engine.build_mesh(case["mesh"], case["axes"], device="cpu")
    coll = mesh.collectives("model")
    v = case["logits"].shape[1] // coll.world
    off = coll.rank * v
    x = torch.from_numpy(case["logits"][:, off:off + v].copy())
    labels = torch.from_numpy(case["labels"])
    local = shard_labels(labels, off, v)
    lse, picked = combine_shard_stats(
        *fused_softmax_cross_entropy_shard_fwd(x, local), coll)
    x.requires_grad_(True)
    loss = vocab_parallel_cross_entropy(x, labels, off, coll)
    (loss * torch.from_numpy(case["g"])).sum().backward()
    return {"loss": loss.detach().numpy(), "lse": lse.numpy(),
            "picked": picked.numpy(), "local": local.numpy(),
            "grad": x.grad.numpy(), "offset": off}


def moe(case):
    import torch

    from bigdl_tpu_torch.nn.moe import MoETransformerLM
    from bigdl_tpu_torch.interop import load_jax_params
    from bigdl_tpu_torch.parallel.ep import ep_local_model
    from bigdl_tpu_torch.parallel.zero import rank_rows
    from bigdl_tpu_torch.utils.engine import Engine

    mesh = Engine.build_mesh(case["mesh"], case["axes"], device="cpu")
    model = build_model(case["model"])
    assert isinstance(model, MoETransformerLM)
    load_jax_params(model, case["params"])
    local = ep_local_model(model, mesh, "data")
    x = torch.from_numpy(rank_rows(case["x"], mesh.axis_index("data"),
                                   mesh.axis_size("data")).copy())
    with torch.no_grad(), mesh.bound():
        logits, aux = local(x, return_aux=True)
    return {"logits": logits.numpy(), "aux": float(aux)}


def shard(case):
    import torch

    from bigdl_tpu_torch.parallel.tp import gather_params, shard_params
    from bigdl_tpu_torch.utils.engine import Engine

    mesh = Engine.build_mesh(case["mesh"], case["axes"], device="cpu")
    local = shard_params(case["params"], mesh)
    back = gather_params(local, case["params"], mesh)

    def numpy(tree):
        return {k: numpy(v) if isinstance(v, dict)
                else (v.numpy() if isinstance(v, torch.Tensor) else v)
                for k, v in tree.items()}

    return {"local": numpy(local), "back": numpy(back)}


def recipe(case):
    from bigdl_tpu_torch.interop import to_jax_params
    from bigdl_tpu_torch.models import run

    summary = _Losses()
    import bigdl_tpu_torch.models.run as run_mod

    base = run_mod._build_optimizer

    def build(*a, **kw):
        opt = base(*a, **kw)
        opt.set_train_summary(summary)
        return opt

    run_mod._build_optimizer = build
    try:
        opt = run.main(case["argv"])
    finally:
        run_mod._build_optimizer = base
    return {"losses": summary.losses, "params": to_jax_params(opt.model),
            "strategy": getattr(opt, "strategy", None),
            "mesh": dict(opt.mesh.shape)}


def pp(case):
    import torch

    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
    from bigdl_tpu_torch.interop import load_jax_params, to_jax_opt_state
    from bigdl_tpu_torch.parallel import pp as ppm
    from bigdl_tpu_torch.utils.engine import Engine

    mesh = Engine.build_mesh(case["mesh"], case["axes"], device="cpu")
    model = build_model(case["model"])
    crit = build_criterion(case["criterion"])
    if case.get("uneven"):
        errors = {}
        calls = {
            "stack_stage_params": lambda: ppm.stack_stage_params(
                model, mesh.axis_size("pipe")),
            "make_pp_loss_fn": lambda: ppm.make_pp_loss_fn(
                model, crit, mesh, 2, data_axis="data"),
            "make_pp_1f1b_train_step": lambda: ppm.make_pp_1f1b_train_step(
                model, crit, optim.SGD(), mesh, 2, data_axis="data"),
            "Optimizer": lambda: optim.Optimizer(
                model, array_dataset(case["x"], case["y"])
                >> SampleToMiniBatch(case["batch"]), crit, optim.SGD(),
                strategy="pp", mesh=mesh, device="cpu")}
        for name, call in calls.items():
            try:
                call()
                errors[name] = None
            except ValueError as e:
                errors[name] = str(e)
        return errors
    load_jax_params(model, case["params"])
    loss_fn = ppm.make_pp_loss_fn(
        model, crit, mesh, case["kw"]["n_microbatches"], data_axis="data",
        model_axis="model" if case["kw"].get("tensor_parallel") else None)
    d = mesh.axis_index("data"), mesh.axis_size("data")
    rows = ppm.pp_rows(case["x"][:case["batch"]],
                       case["kw"]["n_microbatches"], *d)
    target = ppm.pp_rows(case["y"][:case["batch"]],
                         case["kw"]["n_microbatches"], *d)
    first_loss = float(loss_fn(torch.from_numpy(rows.copy()),
                               torch.from_numpy(target.copy())))
    for b in model.blocks:
        b.attn.dropout = case.get("dropout", 0.0)
    result, opt = _fit(case, model)
    plan = opt.plan
    result["opt_state"] = to_jax_opt_state(
        build_method(case["method"]), plan.logical_opt(plan.opt_state),
        model)
    result["first_loss"] = first_loss
    return result


def het(case):
    """A ``het`` case (module docstring)."""
    from bigdl_tpu_torch.interop import load_jax_params, to_jax_opt_state

    model = build_model(case["model"])
    load_jax_params(model, case["params"])
    try:
        result, opt = _fit(case, model)
    except Exception as e:         # noqa: BLE001 -- the case asks for it
        if not case.get("expect_error"):
            raise
        return {"error": type(e).__name__, "message": str(e)}
    plan = opt.plan
    result["opt_state"] = to_jax_opt_state(
        build_method(case["method"]), plan.logical_opt(plan.opt_state),
        model)
    result["slices"] = plan.slices
    result["boundary_dtypes"] = [str(dt) for _, dt in plan.step.specs]
    return result


KINDS = {"train": train, "attention": attention, "vocab_ce": vocab_ce,
         "moe": moe, "shard": shard, "recipe": recipe, "pp": pp,
         "het": het}


def main(rank, world, init_file, jobs, out_dir):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        with open(jobs, "rb") as f:
            cases = pickle.load(f)
        for case in cases:
            result = KINDS[case["kind"]](case)
            out = os.path.join(out_dir, f"{case['name']}.rank{rank}.pkl")
            with open(out + ".tmp", "wb") as f:
                pickle.dump(result, f)
            os.replace(out + ".tmp", out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5])


# --------------------------------------------------------------------------- #
# The JAX side: helpers of the parent test process (never called by a rank)
# --------------------------------------------------------------------------- #

REL = 1e-5


def rel_l2(a, b):
    """Relative L2 distance of two trees' leaves (in JAX's leaf order)."""
    import jax
    import numpy as np

    a = np.concatenate([np.ravel(np.asarray(v, np.float64))
                        for v in jax.tree.leaves(a)])
    b = np.concatenate([np.ravel(np.asarray(v, np.float64))
                        for v in jax.tree.leaves(b)])
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def step_rel(got, want):
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got, want)
    return np.abs(got - want) / np.maximum(np.abs(want), 1e-6)


def jax_mesh(shape, names):
    import jax
    import numpy as np

    n = int(np.prod(shape))
    return jax.sharding.Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                             tuple(names))


def jax_model(spec, x, seed=0):
    """The JAX package's model of a spec, built from ``seed``."""
    import jax
    import jax.numpy as jnp

    import bigdl_tpu.nn as jnn
    from bigdl_tpu.nn.moe import MoETransformerLM
    from bigdl_tpu.utils.random_generator import RNG

    RNG.set_seed(seed)
    if spec["kind"] in ("cnn", "ids"):
        model = seq_model(jnn, spec)
        model.build(jax.ShapeDtypeStruct((2, *x.shape[1:]),
                                          jnp.asarray(x[:1]).dtype))
        return model
    s = dict(spec)
    if s.pop("kind") == "lm":
        model = jnn.TransformerLM(s["vocab"], s["hidden"], s["heads"],
                                  s["layers"], max_len=s["max_len"],
                                  seq_axis_name=s.get("seq_axis_name"),
                                  seq_mode=s.get("seq_mode", "ring"))
    else:
        model = MoETransformerLM(
            s["vocab"], s["hidden"], s["heads"], s["layers"], s["experts"],
            k=s.get("k", 2), max_len=s["max_len"],
            capacity_factor=s.get("capacity_factor", 1.25))
    model.build(jax.ShapeDtypeStruct((2, x.shape[1]), jnp.int32))
    return model


def jax_params(spec, x, seed=0):
    import jax
    import numpy as np

    return jax.tree.map(np.asarray, jax_model(spec, x, seed).parameters()[0])


def jax_fit(case, steps=None, ckpt=None, ckpt_every=2, resume=None,
            strategy="same"):
    """JAX's ``Optimizer`` on the case's mesh (or, with ``strategy=None``,
    its ``LocalOptimizer`` on one device) from the case's seed; returns
    (losses, params, neval, manifest of the newest checkpoint)."""
    import jax
    import numpy as np

    import bigdl_tpu.nn as jnn
    from bigdl_tpu import optim as joptim
    from bigdl_tpu.dataset import SampleToMiniBatch, array_dataset
    from bigdl_tpu.utils import file_io
    from bigdl_tpu.utils.random_generator import RNG

    model = jax_model(case["model"], case["x"], case.get("seed", 0))
    RNG.set_seed(case.get("seed", 0))
    ds = array_dataset(case["x"], case["y"]) >> SampleToMiniBatch(
        case["batch"])
    if case["criterion"] == "class":
        crit = jnn.CrossEntropyCriterion()
    else:
        inner = {"fused": jnn.FusedSoftmaxCrossEntropyCriterion,
                 "ce": jnn.CrossEntropyCriterion}[case["criterion"]]()
        crit = jnn.TimeDistributedCriterion(inner)
    name, kw = case["method"]
    method = {"sgd": joptim.SGD, "adam": joptim.Adam}[name](**kw)
    strategy = case["strategy"] if strategy == "same" else strategy
    if strategy is None:
        opt = joptim.Optimizer(model, ds, crit, method)
    else:
        opt = joptim.Optimizer(model, ds, crit, method, strategy=strategy,
                               mesh=jax_mesh(case["mesh"], case["axes"]),
                               **case.get("kw", {}))
    if case.get("clip_norm") is not None:
        opt.set_gradient_clipping_by_l2_norm(case["clip_norm"])
    opt.set_end_when(joptim.Trigger.max_iteration(steps or case["steps"]))
    if ckpt:
        opt.set_checkpoint(ckpt, joptim.Trigger.several_iteration(ckpt_every))
    if resume:
        opt.resume_from_checkpoint(resume)
    if case.get("val_every"):
        opt.set_validation(joptim.Trigger.several_iteration(
            case["val_every"]), ds, [joptim.Loss(crit)])
    summary = _Losses()
    opt.set_train_summary(summary)
    opt.optimize()
    manifest = None
    if ckpt:
        intact, _ = file_io.scan_checkpoints(ckpt)
        manifest = file_io.read_manifest(intact[0]) if intact else None
    jax_fit.last = opt            # its driver state, for the caller
    return (summary.losses, jax.tree.map(np.asarray, model.parameters()[0]),
            opt.driver_state["neval"], manifest)


def lm_data(n, t, vocab, seed=0):
    import numpy as np

    r = np.random.default_rng(seed)
    return (r.integers(0, vocab, (n, t)).astype(np.int32),
            r.integers(0, vocab, (n, t)).astype(np.int32))


def train_case(name, spec, strategy, mesh, axes, n=8, t=16, batch=4,
               steps=3, method=("sgd", {"learning_rate": 0.1,
                                         "momentum": 0.9,
                                         "dampening": 0.0}),
               criterion="fused", seed=0, **extra):
    """A ``train`` case with the JAX model's initial parameters."""
    x, y = lm_data(n, t, spec["vocab"], seed)
    case = {"kind": "train", "name": name, "model": spec,
            "strategy": strategy, "mesh": tuple(mesh), "axes": tuple(axes),
            "x": x, "y": y, "batch": batch, "steps": steps,
            "method": method, "criterion": criterion, "seed": seed}
    case.update(extra)
    case["params"] = jax_params(spec, x, seed)
    return case
