"""One rank of a spawned gloo world for the port's data-parallel tests
(tests/test_torch_distri_optimizer.py, test_torch_quant_collectives.py).

    python tests/_torch_dist_worker.py RANK WORLD INIT_FILE JOBS OUT_DIR

Joins the world through a ``file://`` rendezvous (never a fixed port:
several test workers run at once), on one thread, runs every case of
the pickled ``JOBS`` list in order and writes each case's result to
``OUT_DIR/<name>.rank<RANK>.pkl``.  Imports torch and the port only.

A ``train`` case builds a model of the port, loads the JAX parameters
and state it carries (``interop``), and trains it through
``DistriOptimizer`` (or, with ``"local": True`` on rank 0 only,
``LocalOptimizer`` on the global batch); its result holds the per-step
losses, the final parameter and state trees in the JAX keys, and the
labels of the global batches the rank fetched.  A ``reduce`` case runs
``ops.quantization.quantized_reduce_chunks`` (or, for a cast wire,
``cast_reduce_chunks``) on its inputs, a
``collectives`` case each collective of ``parallel.collectives``.

``spawn_world`` (the parent's side) starts the ranks, joins them under
its own time limit, kills them and fails on a hang, and returns each
case's results by rank.
"""

import os
import pickle
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def build_model(kind):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.models.resnet import ResNetCifar

    if kind == "lenet":
        return LeNet5(device="cpu")
    if kind == "resnet8":
        return ResNetCifar(depth=8, class_num=10, device="cpu")
    if kind == "lm":
        return nn.TransformerLM(64, 64, 2, 2, max_len=16, device="cpu")
    if kind == "mlp":
        return (nn.Sequential().add(nn.Linear(12, 32)).add(nn.ReLU())
                .add(nn.Linear(32, 5)))
    raise ValueError(kind)


def build_criterion(kind):
    from bigdl_tpu_torch import nn

    return {"nll": nn.ClassNLLCriterion,
            "ce": nn.CrossEntropyCriterion,
            "lm": lambda: nn.TimeDistributedCriterion(
                nn.FusedSoftmaxCrossEntropyCriterion())}[kind]()


def build_method(spec):
    from bigdl_tpu_torch import optim

    name, kw = spec
    return {"sgd": optim.SGD, "adam": optim.Adam}[name](**kw)


class _Losses:
    def __init__(self):
        self.losses = []

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.losses.append(float(value))


def train(case, coll):
    import numpy as np

    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
    from bigdl_tpu_torch.interop import (load_jax_params, load_jax_state,
                                         to_jax_params, to_jax_state)
    from bigdl_tpu_torch.utils.random_generator import RNG

    RNG.set_seed(case.get("seed", 0))
    model = build_model(case["model"])
    load_jax_params(model, case["params"])
    if case.get("state") is not None:
        load_jax_state(model, case["state"])
    ds = array_dataset(case["x"], case["y"]) >> SampleToMiniBatch(
        case["batch"])
    # the labels of the global batches this rank fetches: the ranks'
    # shuffles must agree, or their rows would not form the global batch
    seen = []
    base_data = ds.data

    def data(train):
        it = base_data(train)
        for b in it:
            if train:
                seen.append(np.asarray(b.get_target()).copy())
            yield b

    ds.data = data
    crit = build_criterion(case["criterion"])
    method = build_method(case["method"])
    if case.get("local"):
        opt = optim.LocalOptimizer(model, ds, crit, method, device="cpu")
    else:
        opt = optim.DistriOptimizer(model, ds, crit, method, mesh=coll.group,
                                    grad_compression=case.get("wire"),
                                    sync_bn=case.get("sync_bn", False),
                                    device="cpu")
    if case.get("clip_norm") is not None:
        opt.set_gradient_clipping_by_l2_norm(case["clip_norm"])
    opt.set_end_when(optim.Trigger.max_iteration(case["steps"]))
    if case.get("ckpt"):
        opt.set_checkpoint(case["ckpt"], optim.Trigger.several_iteration(
            case.get("ckpt_every", 2)))
    if case.get("resume"):
        opt.resume_from_checkpoint(case["resume"])
    summary = _Losses()
    opt.set_train_summary(summary)
    opt.optimize()
    return {"losses": summary.losses, "params": to_jax_params(model),
            "state": to_jax_state(model), "seen": seen,
            "neval": opt.driver_state["neval"],
            "wire_summary": getattr(opt, "wire_summary", None),
            "route": getattr(opt, "captured_route", None)}


def reduce(case, coll):
    import torch

    from bigdl_tpu_torch.ops.quantization import (CompressionSpec,
                                                  cast_reduce_chunks,
                                                  quantized_reduce_chunks)

    g = torch.from_numpy(case["grads"][coll.rank])
    spec = CompressionSpec.parse(case["spec"])
    if not spec.quantized:
        return {"chunk": cast_reduce_chunks(g, coll.world, coll,
                                            spec.wire_dtype).numpy()}
    chunk, err = quantized_reduce_chunks(g, coll.world, coll, spec)
    return {"chunk": chunk.numpy(), "err": err.numpy()}


def collectives(case, coll):
    """Each collective of ``parallel.collectives`` on rank-distinct
    inputs, and ``PMean``'s forward and gradient."""
    import torch

    from bigdl_tpu_torch.parallel import PMean

    n, r = coll.world, coll.rank
    x = torch.arange(4 * n, dtype=torch.float32) * (r + 1)
    out = {"psum_scatter": coll.psum_scatter(x).numpy(),
           "psum": coll.psum(x).numpy(),
           "pmean": coll.pmean(x).numpy()}
    flat = torch.zeros(4 * n)
    flat[4 * r:4 * (r + 1)] = torch.arange(4) + 10 * r
    out["all_gather"] = coll.all_gather(flat[4 * r:4 * (r + 1)],
                                        out=flat).numpy()
    q = (torch.arange(2 * n, dtype=torch.int8) + 16 * r).reshape(n, 2)
    out["all_to_all"] = coll.all_to_all(q).numpy()
    v = torch.full((3,), float(r + 1), requires_grad=True)
    y = PMean.apply(v, coll)
    (y * (r + 1)).sum().backward()
    out["pmean_fwd"] = y.detach().numpy()
    out["pmean_grad"] = v.grad.numpy()
    out["backend"] = coll.backend
    return out


def spawn_world(tmp_path, world, cases, timeout=240):
    """Run ``cases`` in a fresh gloo world of ``world`` ranks under
    ``tmp_path``; returns ``{name: [result of rank 0, rank 1, ...]}``
    (a rank that skipped a case has no entry)."""
    tmp_path = str(tmp_path)
    jobs = os.path.join(tmp_path, "jobs.pkl")
    with open(jobs, "wb") as f:
        pickle.dump(cases, f)
    init = os.path.join(tmp_path, "rendezvous")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    logs = [open(os.path.join(tmp_path, f"rank{r}.log"), "w")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         init, jobs, tmp_path], env=env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                raise TimeoutError(f"gloo world of {world} hung past "
                                   f"{timeout} s")
            if any(p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        with open(os.path.join(tmp_path, f"rank{bad[0]}.log")) as f:
            tail = f.read()[-4000:]
        raise RuntimeError(f"ranks {bad} of a world of {world} failed:\n"
                           f"{tail}")
    out = {}
    for case in cases:
        out[case["name"]] = []
        for r in range(world):
            path = os.path.join(tmp_path, f"{case['name']}.rank{r}.pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    out[case["name"]].append(pickle.load(f))
    return out


def main(rank, world, init_file, jobs, out_dir):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from bigdl_tpu_torch.parallel import Collectives

    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        coll = Collectives()
        with open(jobs, "rb") as f:
            cases = pickle.load(f)
        for case in cases:
            if case.get("local") and rank != 0:
                continue
            result = {"train": train, "reduce": reduce,
                      "collectives": collectives}[case["kind"]](
                case, coll)
            out = os.path.join(out_dir, f"{case['name']}.rank{rank}.pkl")
            with open(out + ".tmp", "wb") as f:
                pickle.dump(result, f)
            os.replace(out + ".tmp", out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5])
