"""Model-parallel training strategies behind the Optimizer facade
(counterpart of ``bigdl_tpu/optim/strategy_optimizer.py``:
``STRATEGIES`` :46, ``_STRATEGY_KW`` :50, ``_ClippingMethod`` :59,
``StrategyOptimizer`` :89).

``Optimizer(model, dataset, criterion, method, strategy="tp", mesh=mesh)``
trains through the same setters as the local and data-parallel
paths -- triggers, validation, ``Plateau``'s feed, summaries,
checkpoints, resume and the retry loop -- over a named mesh
(``Engine.build_mesh``, ``parallel/mesh.py``):

- ``tp``: tensor parallelism over ``"model"`` (``parallel/tp.py``),
  optionally with a ``"data"`` axis;
- ``sp``: ring or Ulysses sequence parallelism over ``"seq"``
  (``parallel/sequence.py``; the model's ``seq_mode`` picks the
  pattern), optionally with ``"data"``;
- ``ep``: expert parallelism for MoE models over ``"expert"``
  (``parallel/ep.py``), optionally with ``"data"``;
- ``pp``: pipeline parallelism over ``"pipe"``, optionally with
  ``"data"``: for TransformerLM the stage-stacked pipeline
  (``parallel/pp.py``: GPipe or 1F1B, ``n_microbatches=``,
  ``schedule=``), with ``tensor_parallel=True`` also Megatron
  tensor parallelism inside each stage over ``"model"`` (a 3-D
  ``("data", "pipe", "model")`` mesh); for any stateless
  ``Sequential`` the heterogeneous GPipe pipeline
  (``parallel/pp_het.py``: stages cut by parameter count or at
  ``boundaries=``).

Every rank builds the same model and iterates the same seeded dataset;
the driver loop stages this rank's block of each global batch (its
``"data"`` rows; under sp also its ``"seq"`` columns; under pp its rows
of every microbatch).  The step runs
through ``optim/graphs.py``'s ``CompiledTrainStep``: on NCCL one CUDA
graph per batch shape, the collectives captured inside it, as
``DistriOptimizer``'s step (warm-up steps launch them eagerly first);
on gloo eagerly.

Checkpoints are JAX's pickle: the parameter and optimizer trees in
the strategy's native layout and JAX's keys (tp, sp, ep: the logical
trees, each sharded leaf gathered first; pp: stage-stacked, each
stage's blocks gathered over the model axis and the pipe; the
heterogeneous pipeline: JAX's list of per-stage subtrees), ``()``
module state, and the
manifest's ``layout`` block (``_layout_spec``, JAX's
``LayoutSpec.to_manifest()``), so a checkpoint resumes in either
package.  A resume under another layout is redistributed onto the run's
first (``parallel/reshard.redistribute``, as JAX :475-489), except
to or from the heterogeneous pipeline's, which is refused with JAX's
message (:234-240).  Validation
runs on the gathered logical parameters in the model itself (tp, ep,
pp), or under the mesh with the blocks' logits gathered (sp); the model
holds the logical parameters after ``optimize()``.

Not ported: orbax sharded snapshots (A4), the health probe (A8).
"""

import logging

import torch
import torch.distributed as dist

from bigdl_tpu_torch.optim.graphs import CompiledTrainStep
from bigdl_tpu_torch.optim.local_optimizer import BaseOptimizer, validate
from bigdl_tpu_torch.optim.optim_method import (CompositeOptimMethod, Fused,
                                                clip_by_global_norm,
                                                clip_by_value)
from bigdl_tpu_torch.parallel.reshard import (LayoutSpec,
                                              detect_block_layout,
                                              detect_num_experts,
                                              redistribute)
from bigdl_tpu_torch.utils import file_io
from bigdl_tpu_torch.utils.engine import Engine
from bigdl_tpu_torch.utils.errors import UnsupportedFeatureError
from bigdl_tpu_torch.utils.random_generator import RNG

log = logging.getLogger("bigdl_tpu_torch.optim")

STRATEGIES = ("tp", "pp", "sp", "ep")

#: strategy -> keyword arguments its step factory understands; anything
#: else is a configuration error, not a silent no-op
_STRATEGY_KW = {
    "tp": {"rules"},
    "ep": {"rules", "aux_weight"},
    "sp": {"seq_axis"},
    "pp": {"pipe_axis", "n_microbatches", "tensor_parallel", "boundaries",
           "schedule"},
}

#: the mesh axis each strategy shards over
_AXIS = {"tp": "model", "ep": "expert"}


class _ClippingMethod:
    """OptimMethod proxy that clips gradients before the base update:
    by value elementwise, and by global norm with the norm summed over
    the logical tree (``sq_norm(grads)``: a sharded leaf's squares are
    summed over its axis, a replicated one counted once) -- the
    semantics of the clipping in ``make_train_step``."""

    def __init__(self, base, clip_value, clip_norm, sq_norm=None):
        self._base = base
        self._clip_value = clip_value
        self._clip_norm = clip_norm
        self._sq_norm = sq_norm

    def init_state(self, params):
        return self._base.init_state(params)

    def update(self, grads, opt_state, params):
        if self._clip_value is not None:
            clip_by_value(grads, *self._clip_value)
        if self._clip_norm is not None:
            clip_by_global_norm(
                grads, self._clip_norm,
                sq_norm=None if self._sq_norm is None
                else self._sq_norm(grads))
        return self._base.update(grads, opt_state, params)

    def __getattr__(self, name):   # schedule, get_learning_rate, ...
        return getattr(self._base, name)


class _Plan:
    """One strategy's wiring for a run: the rank's model (``local``),
    the step, the optimizer state, the batch selection, and the maps
    between the rank's trees and the logical ones."""

    def __init__(self, local, step, opt_state, select, specs=None,
                 collectives=None, axis=None):
        self.local = local
        self.step = step
        self.opt_state = opt_state
        self.select = select
        self.specs = specs or {}
        self.collectives = collectives
        self.axis = axis

    @property
    def sharded(self):
        return self.collectives is not None and self.collectives.world > 1

    def _piece(self, name, t):
        from bigdl_tpu_torch.parallel.tp import _shard_leaf

        c = self.collectives
        return _shard_leaf(tuple(name.split(".")), t, self.specs[name],
                           self.axis, c.rank, c.world)

    def _whole(self, name, t):
        from bigdl_tpu_torch.parallel.tp import _gather_leaf

        return _gather_leaf(tuple(name.split(".")), t, self.specs[name],
                            self.collectives, self.axis)

    def logical_params(self):
        """``{name: logical tensor}`` (sharded leaves gathered; every
        rank takes part)."""
        return {k: self._whole(k, p.detach()) if self.sharded else p.detach()
                for k, p in self.local.named_parameters()}

    def logical_opt(self, state):
        """The optimizer state with every per-parameter leaf gathered."""
        if not self.sharded:
            return state
        return {k: {n: self._whole(n, t) for n, t in v.items()}
                if isinstance(v, dict) else v for k, v in state.items()}

    @torch.no_grad()
    def load_logical(self, params, opt_state):
        """Copy logical parameters (``{name: tensor}``) and a logical
        optimizer state into the rank's pieces, in place."""
        from bigdl_tpu_torch.optim.local_optimizer import _copy_into

        for k, p in self.local.named_parameters():
            p.copy_(self._piece(k, params[k]) if self.sharded
                    else params[k])
        if not self.sharded:
            _copy_into(self.opt_state, opt_state)
            return
        for k, v in opt_state.items():
            if isinstance(v, dict):
                for n, t in v.items():
                    self.opt_state[k][n].copy_(self._piece(n, t))
            else:
                self.opt_state[k].copy_(v)

    def to_native(self, tree):
        """Model-layout trees (``{"params", "opt_state"}`` in JAX's keys)
        -> the strategy's checkpoint layout: the same trees here."""
        return tree

    def from_native(self, tree):
        return tree


class _PipePlan(_Plan):
    """The pp wiring: ``local`` is this rank's ``PipelineStage``; the
    logical trees gather every stage's blocks over ``collectives`` (the
    pipe); checkpoints hold JAX's stage-stacked trees (``layout``)."""

    def __init__(self, stage, step, opt_state, select, collectives, layout):
        super().__init__(stage, step, opt_state, select,
                         collectives=collectives)
        self.layout = layout

    def logical_params(self):
        from bigdl_tpu_torch.parallel.pp import gather_logical

        return gather_logical(self.local, {
            k: p.detach() for k, p in self.local.named_parameters()},
            self.collectives)

    def logical_opt(self, state):
        from bigdl_tpu_torch.parallel.pp import gather_logical

        return {k: gather_logical(self.local, v, self.collectives)
                if isinstance(v, dict) else v for k, v in state.items()}

    @torch.no_grad()
    def load_logical(self, params, opt_state):
        from bigdl_tpu_torch.parallel.pp import local_of

        own = dict(self.local.named_parameters())
        for k, t in local_of(self.local, params).items():
            own[k].copy_(t)
        for k, v in opt_state.items():
            if isinstance(v, dict):
                for n, t in local_of(self.local, v).items():
                    self.opt_state[k][n].copy_(t)
            else:
                self.opt_state[k].copy_(v)

    def to_native(self, tree):
        return redistribute(tree, LayoutSpec.replicated("unrolled"),
                            self.layout, what="pp-checkpoint")

    def from_native(self, tree):
        return redistribute(tree, self.layout,
                            LayoutSpec.replicated("unrolled"),
                            what="pp-resume")


class _HetPlan(_Plan):
    """The heterogeneous pipeline's wiring: ``local`` is this rank's
    ``HetStage``; the logical trees gather every stage's children over
    ``collectives`` (the pipe); checkpoints hold JAX's list of
    per-stage subtrees (``slices``)."""

    def __init__(self, stage, step, opt_state, select, collectives, model):
        super().__init__(stage, step, opt_state, select,
                         collectives=collectives)
        self.template = dict(model.named_parameters())
        self.slices = step.slices

    def logical_params(self):
        from bigdl_tpu_torch.parallel.pp_het import het_gather

        return het_gather({k: p.detach()
                           for k, p in self.local.named_parameters()},
                          self.collectives, self.template)

    def logical_opt(self, state):
        from bigdl_tpu_torch.parallel.pp_het import het_gather

        return {k: het_gather(v, self.collectives, self.template)
                if isinstance(v, dict) else v for k, v in state.items()}

    @torch.no_grad()
    def load_logical(self, params, opt_state):
        for k, p in self.local.named_parameters():
            p.copy_(params[k])
        for k, v in opt_state.items():
            if isinstance(v, dict):
                for n, t in self.opt_state[k].items():
                    t.copy_(v[n])
            else:
                self.opt_state[k].copy_(v)

    def to_native(self, tree):
        from bigdl_tpu_torch.parallel.pp_het import to_stage_trees

        return to_stage_trees(tree, self.slices)

    def from_native(self, tree):
        from bigdl_tpu_torch.parallel.pp_het import from_stage_trees

        return from_stage_trees(tree)


class StrategyOptimizer(BaseOptimizer):
    """Driver loop for the model-parallel strategies (module docstring).
    ``mesh``: a ``parallel.mesh.Mesh`` (None: ``Engine.build_mesh()``, a
    1-D ``"data"`` mesh over the world); ``data_axis``: the mesh axis
    whose ranks see different rows (the ``"data"`` default degrades to
    None when the mesh has no such axis; another name must exist).
    Extra keyword arguments go to the strategy (``rules``,
    ``aux_weight``, ``seq_axis``); an unknown one raises."""

    #: ``CompiledTrainStep.stats()`` of the last ``optimize()`` and
    #: whether its step was captured (NCCL) or ran eagerly (gloo)
    compiled_stats = None
    captured_route = None
    #: the last ``optimize()``'s ``_Plan``: ``plan.local`` is this rank's
    #: model (its shards under tp and ep), ``plan.opt_state`` its state
    plan = None

    def __init__(self, model, dataset, criterion, optim_method=None,
                 strategy="tp", mesh=None, data_axis="data", device=None,
                 **strategy_kw):
        super().__init__(model, dataset, criterion, optim_method,
                         device=device)
        if strategy not in STRATEGIES:
            raise ValueError(
                f"unknown parallel strategy {strategy!r}; expected one of "
                f"{STRATEGIES} (data parallelism is the default Optimizer "
                f"path, not a strategy= value)")
        self.strategy = strategy
        self.mesh = mesh if mesh is not None \
            else Engine.build_mesh(device=self.device)
        if data_axis is None or data_axis in self.mesh.axis_names:
            self.data_axis = data_axis
        elif data_axis == "data":
            self.data_axis = None
        else:
            raise ValueError(
                f"data_axis={data_axis!r} is not an axis of the mesh "
                f"{tuple(self.mesh.axis_names)}")
        unknown = set(strategy_kw) - _STRATEGY_KW[strategy]
        if unknown:
            raise TypeError(
                f"strategy={strategy!r} does not understand "
                f"{sorted(unknown)}; accepted options: "
                f"{sorted(_STRATEGY_KW[strategy])}")
        self.strategy_kw = dict(strategy_kw)
        if strategy == "pp":
            self._check_pp(model, strategy_kw)

    def _check_pp(self, model, kw):
        """pp's configuration checks, at construction (JAX :127-150),
        and the uneven cut, which JAX does not check."""
        from bigdl_tpu_torch.nn.attention import TransformerLM
        from bigdl_tpu_torch.nn.containers import Sequential
        from bigdl_tpu_torch.parallel.pp import layers_per_stage

        schedule = kw.get("schedule", "gpipe")
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"unknown pp schedule {schedule!r}; "
                             "expected 'gpipe' or '1f1b'")
        is_sequential = isinstance(model, Sequential)
        if is_sequential and (schedule != "gpipe"
                              or kw.get("tensor_parallel", False)):
            raise UnsupportedFeatureError(
                "pipelined Sequential models run the heterogeneous "
                "GPipe engine; schedule='1f1b' and tensor_parallel "
                "are only available for stage-stacked transformer "
                "models")
        if not is_sequential and kw.get("boundaries") is not None:
            raise TypeError(
                "boundaries= applies to Sequential (heterogeneous) "
                "pipelining; stage-stacked transformer models split "
                "evenly by block count")
        if kw.get("tensor_parallel", False) and \
                "model" not in self.mesh.shape:
            raise ValueError(
                f"tensor_parallel=True shards each stage over a 'model' "
                f"axis; the mesh {tuple(self.mesh.axis_names)} has none")
        pipe_axis = kw.get("pipe_axis", "pipe")
        if pipe_axis not in self.mesh.shape:
            raise ValueError(f"pipe_axis={pipe_axis!r} is not an axis of "
                             f"the mesh {tuple(self.mesh.axis_names)}")
        if isinstance(model, TransformerLM):
            layers_per_stage(len(model.blocks),
                             self.mesh.axis_size(pipe_axis))

    def set_sharded_checkpoint(self, path, trigger):
        """Refused: orbax sharded snapshots are not ported (ROADMAP A4:
        orbax is not available to the port); ``set_checkpoint`` writes
        JAX's pickle, which either package resumes."""
        raise UnsupportedFeatureError(
            "set_sharded_checkpoint: orbax sharded snapshots are not "
            "ported (ROADMAP A4: orbax is not available to the port); use "
            "set_checkpoint")

    # ----- layout ----------------------------------------------------------- #
    def _layout_spec(self):
        """The ``LayoutSpec`` of this run's strategy, stamped into every
        checkpoint's manifest (JAX :157)."""
        mesh_axes = {a: int(self.mesh.shape[a])
                     for a in self.mesh.axis_names}
        kw = self.strategy_kw
        if self.strategy == "pp":
            from bigdl_tpu_torch.nn.containers import Sequential

            pipe_axis = kw.get("pipe_axis", "pipe")
            spec = LayoutSpec.pp(mesh_axes, self.mesh.axis_size(pipe_axis),
                                 pipe_axis, kw.get("tensor_parallel", False))
            if isinstance(self.model, Sequential):
                # the heterogeneous pipeline's per-stage subtrees (JAX
                # :171-176): a cross-layout resume refuses them by name
                spec.plane["het"] = True
            return spec
        tree = self.model.parameters_tree()
        if self.strategy == "tp":
            from bigdl_tpu_torch.parallel.tp import TRANSFORMER_TP_RULES
            return LayoutSpec.tp(
                mesh_axes, rules=kw.get("rules", TRANSFORMER_TP_RULES),
                block_layout=detect_block_layout(tree))
        if self.strategy == "ep":
            from bigdl_tpu_torch.parallel.ep import MOE_EP_RULES
            return LayoutSpec.ep(mesh_axes,
                                 rules=kw.get("rules", MOE_EP_RULES),
                                 num_experts=detect_num_experts(tree))
        return LayoutSpec.sp(mesh_axes, kw.get("seq_axis", "seq"),
                             block_layout=detect_block_layout(tree))

    # ----- strategy wiring -------------------------------------------------- #
    def _check_stateless(self):
        """tp/sp/ep steps run the model with empty mutable state; a
        model carrying running statistics (BatchNorm) must train on the
        dp path, which averages that state across shards."""
        if any(b.is_floating_point() for b in self.model.buffers()):
            raise UnsupportedFeatureError(
                f"strategy={self.strategy!r} trains with empty module "
                "state, but this model carries floating state (e.g. "
                "BatchNorm running stats); train it data-parallel "
                "(DistriOptimizer) instead")

    def _rows(self, tree):
        from bigdl_tpu_torch.parallel.zero import rank_rows

        if self.data_axis is None:
            return tree
        return rank_rows(tree, self.mesh.axis_index(self.data_axis),
                         self.mesh.axis_size(self.data_axis))

    def _clipping(self, sq_norm):
        if self.clip_value is None and self.clip_norm is None:
            return self.optim_method
        return _ClippingMethod(self.optim_method, self.clip_value,
                               self.clip_norm, sq_norm)

    def _prepare(self, first_batch=None):
        """-> the run's ``_Plan`` (the heterogeneous pipeline builds its
        step for ``first_batch``'s size)."""
        from bigdl_tpu_torch.parallel.strategy_step import logical_sq_norm

        mesh, kw, cdt = self.mesh, self.strategy_kw, self.compute_dtype
        if self.strategy in ("tp", "ep", "pp"):
            if isinstance(self.optim_method, (Fused, CompositeOptimMethod)):
                raise UnsupportedFeatureError(
                    f"strategy={self.strategy!r} shards each parameter's "
                    f"optimizer state with the parameter; "
                    f"{type(self.optim_method).__name__} keeps its state "
                    f"over the whole tree -- use a per-parameter method")
        if self.strategy == "pp":
            return self._prepare_pp(first_batch)
        if self.strategy in ("tp", "ep"):
            axis = _AXIS[self.strategy]
            if self.strategy == "tp":
                from bigdl_tpu_torch.parallel.tp import (
                    TRANSFORMER_TP_RULES, init_opt_state_sharded,
                    make_tp_train_step, sharded_collectives, tp_local_model)
                local = tp_local_model(self.model, mesh,
                                       kw.get("rules", TRANSFORMER_TP_RULES))
                init = init_opt_state_sharded
            else:
                from bigdl_tpu_torch.parallel.ep import (
                    MOE_EP_RULES, ep_local_model, init_ep_opt_state,
                    make_ep_train_step)
                from bigdl_tpu_torch.parallel.tp import sharded_collectives
                local = ep_local_model(self.model, mesh, self.data_axis,
                                       kw.get("rules", MOE_EP_RULES))
                init = init_ep_opt_state
            sharded = sharded_collectives(local.tp_specs, mesh, axis)
            method = self._clipping(
                lambda g: logical_sq_norm(g, sharded))
            if self.strategy == "tp":
                step = make_tp_train_step(local, self.criterion, method,
                                          mesh, self.data_axis, cdt)
            else:
                step = make_ep_train_step(
                    local, self.criterion, method, mesh, self.data_axis,
                    aux_weight=kw.get("aux_weight", 0.01), compute_dtype=cdt)
            opt_state = init(self.optim_method,
                             dict(local.named_parameters()))
            return _Plan(local, step, opt_state, self._rows,
                         local.tp_specs, mesh.collectives(axis), axis)

        from bigdl_tpu_torch.nn.attention import MultiHeadAttention
        from bigdl_tpu_torch.parallel.sequence import (make_sp_train_step,
                                                       shard_tokens)
        seq_axis = kw.get("seq_axis", "seq")
        if seq_axis not in mesh.shape:
            raise ValueError(f"seq_axis={seq_axis!r} is not an axis of the "
                             f"mesh {tuple(mesh.axis_names)}")
        attns = [m for m in self.model.modules()
                 if isinstance(m, MultiHeadAttention)]
        if any(m.seq_axis_name != seq_axis for m in attns):
            raise ValueError(
                f"strategy='sp' over {seq_axis!r}: build the model with "
                f"seq_axis_name={seq_axis!r} so its attention spans the "
                f"sharded sequence")
        method = self._clipping(None)
        step = make_sp_train_step(self.model, self.criterion, method, mesh,
                                  seq_axis=seq_axis,
                                  data_axis=self.data_axis,
                                  compute_dtype=cdt)
        params = dict(self.model.named_parameters())
        opt_state = self.optim_method.init_state(params)
        return _Plan(self.model, step, opt_state,
                     lambda tree: shard_tokens(tree, mesh, seq_axis,
                                               self.data_axis))

    def _prepare_pp(self, first_batch):
        from bigdl_tpu_torch.nn.containers import Sequential
        from bigdl_tpu_torch.parallel.pp import (init_pp_opt_state,
                                                 make_pp_1f1b_train_step,
                                                 make_pp_train_step,
                                                 pp_rows, pp_sq_norm)

        kw = self.strategy_kw
        pipe_axis = kw.get("pipe_axis", "pipe")
        pipe = self.mesh.collectives(pipe_axis)
        n_micro = int(kw.get("n_microbatches", pipe.world))
        d = self.data_axis
        index = self.mesh.axis_index(d) if d is not None else 0
        size = self.mesh.axis_size(d) if d is not None else 1
        if isinstance(self.model, Sequential):
            return self._prepare_het(first_batch, pipe, n_micro, index, size)
        make = make_pp_1f1b_train_step if kw.get("schedule") == "1f1b" \
            else make_pp_train_step
        built = []
        step = make(self.model, self.criterion,
                    self._clipping(lambda g: pp_sq_norm(g, pipe,
                                                        built[0].stage)),
                    self.mesh, n_micro, pipe_axis=pipe_axis,
                    data_axis=self.data_axis,
                    compute_dtype=self.compute_dtype,
                    model_axis="model" if kw.get("tensor_parallel", False)
                    else None)
        built.append(step)
        return _PipePlan(step.stage, step,
                         init_pp_opt_state(self.optim_method, step.stage),
                         lambda tree: pp_rows(tree, n_micro, index, size),
                         pipe, self._layout_spec())

    def _prepare_het(self, first_batch, pipe, n_micro, index, size):
        """The heterogeneous pipeline's plan (JAX :355-387): the step is
        built for the first batch's microbatch shape."""
        from bigdl_tpu_torch.parallel.pp_het import (het_rows,
                                                     make_het_pp_train_step)
        from bigdl_tpu_torch.parallel.strategy_step import logical_sq_norm

        x0 = torch.as_tensor(first_batch.get_input())
        if x0.shape[0] % (n_micro * size):
            raise ValueError(
                f"batch {x0.shape[0]} not divisible by {n_micro} "
                f"microbatches x {size} data shards")
        mb = x0.shape[0] // n_micro // size
        spec = torch.empty((mb, *x0.shape[1:]), dtype=x0.dtype,
                           device="meta")
        step = make_het_pp_train_step(
            self.model, self.criterion,
            self._clipping(lambda g: logical_sq_norm(
                g, {k: pipe for k in g} if pipe.world > 1 else {})),
            self.mesh, n_micro, spec,
            boundaries=self.strategy_kw.get("boundaries"),
            pipe_axis=self.strategy_kw.get("pipe_axis", "pipe"),
            data_axis=self.data_axis, compute_dtype=self.compute_dtype)
        opt_state = self.optim_method.init_state(
            dict(step.stage.named_parameters()))
        return _HetPlan(step.stage, step, opt_state,
                        lambda tree: het_rows(tree, n_micro, mb, index,
                                              size),
                        pipe, self.model)

    @torch.no_grad()
    def _sync_model(self, plan):
        """The logical parameters copied into ``self.model`` (every rank
        takes part in the gathers); the model trains itself under sp."""
        if plan.local is self.model:
            return
        logical = plan.logical_params()
        for k, p in self.model.named_parameters():
            p.copy_(logical[k])

    def _load_snapshot(self, plan):
        """A snapshot into the model, the rank's pieces and the optimizer
        state: one of another layout is first redistributed onto this
        run's (JAX :475-489; a legacy one without a layout is taken as
        this run's)."""
        from bigdl_tpu_torch.interop.jax_params import (from_jax_opt_state,
                                                        load_jax_params)

        snap = self._resume
        saved = {"params": snap["model_params"],
                 "opt_state": snap["opt_state"]}
        src = LayoutSpec.from_manifest(
            (file_io.read_manifest(self._resume_path) or {}).get("layout"))
        dst = self._layout_spec()
        if src is not None and src != dst:
            if src.plane.get("het") or dst.plane.get("het"):
                raise UnsupportedFeatureError(
                    f"snapshot {self._resume_path} was written under "
                    f"layout {src.describe()} and this run uses "
                    f"{dst.describe()}: the heterogeneous Sequential "
                    "pipeline's per-stage subtrees cannot be re-cut; "
                    "resume on the original mesh")
            saved = redistribute(saved, src, dst,
                                 what=f"{self.strategy}-resume")
            log.info("resumed %s across layouts: %s -> %s",
                     self._resume_path, src.describe(), dst.describe())
        saved = plan.from_native(saved)
        load_jax_params(self.model, saved["params"])
        opt = from_jax_opt_state(self.optim_method, saved["opt_state"],
                                 self.device,
                                 jax_params=saved["params"],
                                 model=self.model)
        plan.load_logical(dict(self.model.named_parameters()), opt)
        self._apply_driver_state(snap["driver_state"])

    def _checkpoint(self, plan):
        """Rank 0 writes JAX's pickle of the logical trees with the
        layout block; every rank takes part in the gathers and waits
        until it is written."""
        from bigdl_tpu_torch.interop.jax_params import (to_jax_opt_state,
                                                        to_jax_params,
                                                        to_jax_state)

        self._sync_model(plan)
        opt = plan.logical_opt(plan.opt_state)
        if self.mesh.rank == 0:
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            native = plan.to_native({
                "params": to_jax_params(self.model),
                "opt_state": to_jax_opt_state(self.optim_method, opt,
                                              self.model)})
            file_io.save_checkpoint(
                self.checkpoint_path, self.driver_state["neval"],
                native["params"], to_jax_state(self.model),
                native["opt_state"], self.driver_state,
                manifest_meta={"layout": self._layout_spec().to_manifest()})
        self._barrier()

    def _barrier(self):
        if self.mesh.size > 1:
            self.mesh.collectives(*self.mesh.axis_names).barrier(
                self.device)

    def _validate_sp(self):
        """Validation for sequence parallelism: the forward of each
        rank's block under the mesh, metrics on the gathered logits."""
        from bigdl_tpu_torch.optim.local_optimizer import _to_device
        from bigdl_tpu_torch.parallel.sequence import (make_sp_eval_step,
                                                       shard_tokens)

        seq_axis = self.strategy_kw.get("seq_axis", "seq")
        fwd = make_sp_eval_step(self.model, self.mesh, seq_axis=seq_axis,
                                data_axis=self.data_axis,
                                compute_dtype=self.compute_dtype)
        totals = [None] * len(self.validation_methods)
        for batch in self.validation_dataset.data(train=False):
            x = shard_tokens(batch.get_input(), self.mesh, seq_axis,
                             self.data_axis)
            out = fwd(_to_device(x, self.device))
            target = _to_device(batch.get_target(), self.device)
            for i, m in enumerate(self.validation_methods):
                r = m(out, target)
                totals[i] = r if totals[i] is None else totals[i] + r
        return totals

    def _validate(self, plan):
        if self.strategy == "sp":
            return self._validate_sp()
        self._sync_model(plan)
        return validate(self.model, self.validation_dataset,
                        self.validation_methods, self.compute_dtype)

    def _summaries(self, plan, opt_state, state):
        self._log_learning_rates(opt_state, state)
        getter = getattr(self.train_summary, "get_summary_trigger", None)
        trig = getter("Parameters") if getter is not None else None
        if trig is not None and trig(state):
            self._sync_model(plan)
        self._histograms(state)

    # ----- driver loop ------------------------------------------------------ #
    def _optimize_impl(self):
        if self.grad_transform is not None:
            raise UnsupportedFeatureError(
                "set_grad_transform operates on the model's gradient "
                "TREE; the strategy engines restructure/shard it -- use "
                "LocalOptimizer for gradient transforms")
        train_iter = self.dataset.data(train=True)
        first_batch = next(train_iter)
        self._check_stateless()
        if self._optim_methods_map:
            if self.strategy == "pp":
                raise UnsupportedFeatureError(
                    "set_optim_methods addresses the model's own tree; "
                    "pipeline layouts restructure it (stage-stacked / "
                    "per-stage subtrees) -- use sp or the local path "
                    "for per-submodule methods")
            if self.strategy in ("tp", "ep"):
                raise UnsupportedFeatureError(
                    "set_optim_methods on the tp/ep paths would fall "
                    "back to REPLICATED optimizer state (the sharded "
                    "init matches the single-method state layout only), "
                    "multiplying optimizer HBM by the mesh size; use sp "
                    "or the local path for per-submodule methods")
            self._resolve_optim_methods(dict(self.model.named_parameters()))
        if self.data_axis is not None and \
                first_batch.size() % self.mesh.axis_size(self.data_axis):
            raise ValueError(
                f"global batch {first_batch.size()} not divisible by "
                f"{self.mesh.axis_size(self.data_axis)} ranks on axis "
                f"{self.data_axis!r}")
        plan = self.plan = self._prepare(first_batch)
        if self._resume is not None:
            self._load_snapshot(plan)
        train_iter, first_batch = self._resume_data_stream(
            train_iter, first_batch)
        native = str(dist.get_backend()) == "nccl"
        self.captured_route = "nccl-graph" if native and \
            self.device.type == "cuda" else "eager"
        opt_state = plan.opt_state
        step = CompiledTrainStep(plan.local, self.criterion,
                                 self.optim_method, opt_state, self.device,
                                 step_fn=plan.step, capture=native)

        def dispatch(staged):
            x, target = staged
            RNG.next_generator()          # the step's stream position
            return step.run(x, target)

        try:
            self._run_driver_loop(
                train_iter, first_batch, dispatch,
                extra_summaries=lambda state: self._summaries(
                    plan, opt_state, state),
                validate_cb=lambda: self._validate(plan),
                feed_plateau=lambda state: self._feed_plateau(
                    state, opt_state),
                checkpoint_cb=lambda state: self._checkpoint(plan),
                select=plan.select)
        finally:
            self.compiled_stats = step.stats()
        self._sync_model(plan)
        return self.model
