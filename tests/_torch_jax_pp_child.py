"""JAX's own pipeline steps in a process of their own, for
tests/test_torch_pp.py and tests/test_torch_pp_het.py (JAX's
shard_map'd pp step has aborted XLA inside test workers, so it never
runs in one).

    python tests/_torch_jax_pp_child.py JOB_PKL OUT_PKL

The job's ``tasks`` (default ``["pp"]``) name what runs, each on CPU
devices the caller provides through ``XLA_FLAGS`` (four for
``pp_tp``), each writing ``OUT_PKL[task]``:

- ``pp``: ``make_pp_train_step`` (GPipe) and ``make_pp_1f1b_train_step``
  for one step on a ``(1, 2)`` ``("data", "pipe")`` mesh, from the
  job's TransformerLM parameters, batch and SGD settings: each
  schedule's loss and updated parameters (the model's own tree);
- ``pp_tp``: the same two steps with tensor parallelism on a ``(1, 2,
  2)`` ``("data", "pipe", "model")`` mesh (``pp_tp_shardings``,
  ``manual_axes=("data", "pipe")``, the facade's wiring);
- ``het``: ``make_het_pp_train_step`` for one step of the job's
  Sequential (``het_model`` spec, ``het_params``, ``het_x``,
  ``het_y``) on a ``(1, 2)`` mesh: its loss and merged parameters;
- ``het_resume``: JAX's ``Optimizer(strategy="pp")`` on that
  Sequential at ``(1, 2)`` resumed from the checkpoint directory
  ``het_resume`` and trained to ``het_steps`` iterations: its losses,
  parameters and step count.
"""

import os
import pickle
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _lm(job):
    import jax
    import jax.numpy as jnp

    from bigdl_tpu.nn.attention import TransformerLM

    spec = job["model"]
    model = TransformerLM(spec["vocab"], spec["hidden"], spec["heads"],
                          spec["layers"], max_len=spec["max_len"])
    model.build(jax.ShapeDtypeStruct(job["x"].shape, jnp.int32))
    model.set_parameters(jax.tree.map(jnp.asarray, job["params"]))
    return model


def _pp(job, tensor_parallel):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    import bigdl_tpu.nn as nn
    from bigdl_tpu import optim
    from bigdl_tpu.parallel.pp import (init_pp_opt_state,
                                       make_pp_1f1b_train_step,
                                       make_pp_train_step, pp_shardings,
                                       pp_tp_shardings, stack_stage_params,
                                       unstack_stage_params)
    from bigdl_tpu.parallel.zero import shard_opt_state

    if tensor_parallel:
        mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(1, 2, 2),
                    ("data", "pipe", "model"))
    else:
        mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2),
                    ("data", "pipe"))
    out = {}
    for name, make in (("gpipe", make_pp_train_step),
                       ("1f1b", make_pp_1f1b_train_step)):
        model = _lm(job)
        crit = nn.TimeDistributedCriterion(
            nn.FusedSoftmaxCrossEntropyCriterion())
        method = optim.SGD(**job["sgd"])
        pp = stack_stage_params(model, 2)
        sh = pp_tp_shardings(pp, mesh) if tensor_parallel \
            else pp_shardings(pp, mesh)
        pp = jax.tree.map(jax.device_put, pp, sh)
        opt = shard_opt_state(method, pp, sh, mesh) if tensor_parallel \
            else init_pp_opt_state(method, pp, mesh)
        kw = {"manual_axes": ("data", "pipe")} if tensor_parallel else {}
        step = make(model, crit, method, mesh,
                    n_microbatches=job["n_microbatches"], data_axis="data",
                    **kw)
        new, _, loss = step(pp, opt, jnp.asarray(job["x"]),
                            jnp.asarray(job["y"]), jax.random.key(0))
        out[name] = {"loss": float(loss), "params": jax.tree.map(
            np.asarray, unstack_stage_params(model, new))}
    return out


def _seq(job):
    import jax
    import jax.numpy as jnp

    import bigdl_tpu.nn as nn
    from _torch_strategy_worker import jax_model

    model = jax_model(job["het_model"], job["het_x"])
    model.set_parameters(jax.tree.map(jnp.asarray, job["het_params"]))
    return model, nn.CrossEntropyCriterion()


def _pipe2():
    import jax
    import numpy as np
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2),
                ("data", "pipe"))


def _het(job):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bigdl_tpu import optim
    from bigdl_tpu.parallel.pp_het import (make_het_pp_train_step,
                                           merge_stage_params)

    model, crit = _seq(job)
    method = optim.SGD(**job["sgd"])
    x, y = job["het_x"], job["het_y"]
    m = job["n_microbatches"]
    spec = jax.ShapeDtypeStruct((x.shape[0] // m, *x.shape[1:]),
                                jnp.asarray(x[:1]).dtype)
    step, sp = make_het_pp_train_step(model, crit, method, _pipe2(), m,
                                      spec, data_axis="data")
    new, _, loss = step(sp, method.init_state(sp), jnp.asarray(x),
                        jnp.asarray(y), jax.random.key(0))
    return {"loss": float(loss), "params": jax.tree.map(
        np.asarray, merge_stage_params(model, new))}


def _het_resume(job):
    import jax
    import numpy as np

    from bigdl_tpu import optim
    from bigdl_tpu.dataset import SampleToMiniBatch, array_dataset
    from _torch_strategy_worker import _Losses

    model, crit = _seq(job)
    ds = array_dataset(job["het_x"], job["het_y"]) >> SampleToMiniBatch(
        job["het_x"].shape[0])
    opt = optim.Optimizer(model, ds, crit, optim.SGD(**job["sgd"]),
                          strategy="pp", mesh=_pipe2(),
                          n_microbatches=job["n_microbatches"])
    opt.set_end_when(optim.Trigger.max_iteration(job["het_steps"]))
    opt.resume_from_checkpoint(job["het_resume"])
    summary = _Losses()
    opt.set_train_summary(summary)
    opt.optimize()
    return {"losses": summary.losses, "neval": opt.driver_state["neval"],
            "params": jax.tree.map(np.asarray, model.parameters()[0])}


def main(job_path, out_path):
    for p in (REPO, HERE):
        if p not in sys.path:
            sys.path.insert(0, p)
    import jax

    jax.config.update("jax_platforms", "cpu")

    with open(job_path, "rb") as f:
        job = pickle.load(f)
    tasks = {"pp": lambda: _pp(job, False), "pp_tp": lambda: _pp(job, True),
             "het": lambda: _het(job), "het_resume": lambda: _het_resume(job)}
    out = {name: tasks[name]() for name in job.get("tasks", ["pp"])}
    with open(out_path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(out_path + ".tmp", out_path)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
