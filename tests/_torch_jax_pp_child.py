"""JAX's own pipeline steps in a process of their own, for
tests/test_torch_pp.py (JAX's shard_map'd pp step has aborted XLA inside
test workers, so it never runs in one).

    python tests/_torch_jax_pp_child.py JOB_PKL OUT_PKL

Runs ``make_pp_train_step`` (GPipe) and ``make_pp_1f1b_train_step`` of
the JAX package for one step on a ``(1, 2)`` ``("data", "pipe")`` mesh
of two CPU devices (the caller sets ``XLA_FLAGS``), from the job's
TransformerLM parameters, batch and SGD settings, and writes each
schedule's loss and updated parameters (the model's own tree, numpy) to
``OUT_PKL``.
"""

import os
import pickle
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def main(job_path, out_path):
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    import bigdl_tpu.nn as nn
    from bigdl_tpu import optim
    from bigdl_tpu.nn.attention import TransformerLM
    from bigdl_tpu.parallel.pp import (init_pp_opt_state,
                                       make_pp_1f1b_train_step,
                                       make_pp_train_step, pp_shardings,
                                       stack_stage_params,
                                       unstack_stage_params)

    with open(job_path, "rb") as f:
        job = pickle.load(f)
    spec = job["model"]
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2),
                ("data", "pipe"))
    out = {}
    for name, make in (("gpipe", make_pp_train_step),
                       ("1f1b", make_pp_1f1b_train_step)):
        model = TransformerLM(spec["vocab"], spec["hidden"], spec["heads"],
                              spec["layers"], max_len=spec["max_len"])
        model.build(jax.ShapeDtypeStruct(job["x"].shape, jnp.int32))
        model.set_parameters(jax.tree.map(jnp.asarray, job["params"]))
        crit = nn.TimeDistributedCriterion(
            nn.FusedSoftmaxCrossEntropyCriterion())
        method = optim.SGD(**job["sgd"])
        pp = stack_stage_params(model, 2)
        pp = jax.tree.map(jax.device_put, pp, pp_shardings(pp, mesh))
        opt = init_pp_opt_state(method, pp, mesh)
        step = make(model, crit, method, mesh,
                    n_microbatches=job["n_microbatches"], data_axis="data")
        new, _, loss = step(pp, opt, jnp.asarray(job["x"]),
                            jnp.asarray(job["y"]), jax.random.key(0))
        out[name] = {"loss": float(loss), "params": jax.tree.map(
            np.asarray, unstack_stage_params(model, new))}
    with open(out_path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(out_path + ".tmp", out_path)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
