"""Synchronous data-parallel training with ZeRO-1 optimizer state
(counterpart of ``bigdl_tpu/optim/distri_optimizer.py``:
``make_distri_train_step`` :53, ``DistriOptimizer`` :315,
``ParallelOptimizer`` :893).

A world of ``n`` processes (``torch.distributed``, one device each;
``utils.engine.Engine``) stands for the JAX process's mesh of ``n``
devices on the ``"data"`` axis.  Every rank builds the same model and
iterates the same seeded dataset; rank ``r`` takes rows ``r * B / n`` to
``(r + 1) * B / n`` of each global batch.  One step, in the JAX step's
order (:140-254):

1. forward and backward on the rank's rows (compute dtype, regularizers,
   frozen modules), the gradient accumulated into the flat gradient
   plane (``parallel.zero.FlatParamSpace.bind``);
2. the reduce of the flat gradient -- a reduce-scatter in fp32, or the
   cast wire (``ops.quantization.cast_reduce_chunks``: bf16/fp16 on the
   wire, summed as XLA sums them), or the int8 wire (``ops.quantization.
   quantized_reduce_chunks``, the error-feedback residual added first) --
   and the division by ``n``: each rank holds the mean gradient of its
   chunk;
3. clipping by value, and by global norm through a ``psum`` of the
   chunks' squares;
4. the method's update on the chunk alone (ZeRO-1: the state covers this
   rank's chunk);
5. the frozen positions restored;
6. the all-gather of the updated chunks into the flat parameters, in
   place, or with ``compress_weight_gather`` the gather of the update's
   int8 delta added to the replicated fp32 masters;
7. ``pmean`` of the floating model state (BatchNorm's running
   statistics) and of the loss.

The step is compiled as ``LocalOptimizer``'s is (``optim/graphs.py``,
one CUDA graph per batch shape on the card).  On NCCL the collectives
are inside the graph: the warm-up steps launch them eagerly first (a
collective never launched cannot be captured).  The gloo route
(``parallel/collectives.py``: every collective composed from
``all_reduce``, the CPU and ranks sharing one card) cannot be captured
and runs eagerly, by design.

The random streams: a dropout or stochastic-rounding key is drawn from
the port's stream and offset by the rank (JAX folds the rank into the
step's key); it cannot match JAX's bits.

Checkpoints are the JAX package's non-sharded pickle: rank 0 writes
``model_params_flat`` (the flat plane), ``ef_residual`` (one row per
rank) under ``model_params``, the optimizer state's chunks gathered
into full flat vectors, and the manifest's ``layout`` block
(``LayoutSpec.dp``'s keys).  A resume takes the same layout, or another
rank count by refitting the padding (``refit_flat_plane``) and
re-partitioning the residual (``repartition_ef_residual``); a layout of
another kind is refused (ROADMAP A7).

Not ported: orbax sharded snapshots (ROADMAP A4; the card's machine has
no orbax), the step's ``health_stats`` (ROADMAP A8), multi-host
``PartitionedDataSet`` (A9).
"""

import contextlib
import logging

import numpy as np
import torch

from bigdl_tpu_torch.nn import dropout as _dropout
from bigdl_tpu_torch.nn.module import frozen_param_mask, has_frozen
from bigdl_tpu_torch.nn.normalization import sync_batchnorm
from bigdl_tpu_torch.ops.quantization import (CompressionSpec,
                                              cast_reduce_chunks,
                                              dequantize_blockwise,
                                              quantize_blockwise,
                                              quantized_reduce_chunks,
                                              uncompressed_wire_summary)
from bigdl_tpu_torch.optim.graphs import CompiledTrainStep
from bigdl_tpu_torch.optim.local_optimizer import (BaseOptimizer, _copy_into,
                                                   validate)
from bigdl_tpu_torch.optim.optim_method import clip_by_global_norm
from bigdl_tpu_torch.optim.regularizer import (has_regularizers,
                                               regularization_loss)
from bigdl_tpu_torch.optim.train_step import _forward
from bigdl_tpu_torch.parallel.collectives import Collectives
from bigdl_tpu_torch.parallel.zero import (FlatParamSpace, rank_rows,
                                           refit_flat_plane,
                                           repartition_ef_residual)
from bigdl_tpu_torch.utils import file_io
from bigdl_tpu_torch.utils.engine import Engine
from bigdl_tpu_torch.utils.errors import (ConfigurationError,
                                          UnsupportedFeatureError)
from bigdl_tpu_torch.utils.random_generator import RNG

log = logging.getLogger("bigdl_tpu_torch.optim")

#: offset of rank r's random key: r times this odd constant
_RANK_KEY_STRIDE = 0x9E3779B1


def layout_manifest(num_chunks, padded_size, true_size, block_size=1,
                    ef_shape=None, axis="data"):
    """The manifest ``layout`` block of a flat-plane snapshot: JAX's
    ``LayoutSpec.dp(...).to_manifest()`` (``bigdl_tpu/parallel/
    reshard.py:120-129, 173``)."""
    return {"kind": "dp", "mesh_axes": {axis: int(num_chunks)},
            "padded_size": int(padded_size), "true_size": int(true_size),
            "num_chunks": int(num_chunks), "block_size": int(block_size),
            "ef_shape": None if ef_shape is None
            else [int(s) for s in ef_shape]}


def make_distri_train_step(model, criterion, optim_method, flat_space,
                           collectives, params_flat, grad_flat,
                           compute_dtype=None, clip_value=None,
                           clip_norm=None, grad_compression=None,
                           sync_bn=False, ef_residual=None,
                           health_stats=False):
    """``step(opt_state, input, target) -> (opt_state, loss)``: one
    data-parallel step on this rank's rows (module docstring).
    ``model``'s parameters are views into ``params_flat`` and their
    gradients into ``grad_flat`` (``flat_space.bind``); ``opt_state``
    covers this rank's chunk; ``ef_residual`` (the int8 wire with error
    feedback) is this rank's full-length residual row, updated in place.
    ``loss`` is the mean of the ranks' losses, a 0-d device tensor.
    ``step.live`` lists the tensors it writes beyond the model's and the
    state's; ``step.dropout_key`` is its random key (or None)."""
    if health_stats:
        raise NotImplementedError(
            "health_stats: observability/health.py is not ported yet "
            "(ROADMAP A8)")
    spec = CompressionSpec.parse(grad_compression)
    use_ef = spec is not None and spec.error_feedback
    if use_ef and ef_residual is None:
        raise ValueError("error feedback needs the residual row "
                         "(ef_residual=)")
    n, rank = collectives.world, collectives.rank
    if spec is not None and spec.quantized \
            and flat_space.chunk_size % spec.block_size != 0:
        raise ValueError(
            f"ZeRO-1 chunk size {flat_space.chunk_size} is not a "
            f"multiple of the quantization block "
            f"({spec.block_size}); build the FlatParamSpace with "
            f"block_size={spec.block_size}")
    params = dict(model.named_parameters())
    use_reg = has_regularizers(model)
    mchunk = None
    if has_frozen(model):
        keep = frozen_param_mask(model)
        mask_flat = flat_space.flatten(
            {k: torch.full_like(p, 1.0 if keep[k] else 0.0)
             for k, p in params.items()})
        mchunk = flat_space.chunk(mask_flat, rank)
    stochastic = spec is not None and spec.stochastic
    key = None
    if _dropout.uses_dropout(model) or stochastic:
        _dropout.salt_by_path(model)
        key = _dropout.new_step_key(RNG.next_generator(), params_flat.device)
        key.add_(rank * _RANK_KEY_STRIDE)
    pchunk = flat_space.chunk(params_flat, rank)
    state_bufs = [b for b in model.buffers() if b.is_floating_point()]
    keep_old = mchunk is not None or (spec is not None
                                      and spec.compress_weight_gather)

    def step(opt_state, input, target):
        model.train()
        flat_space.bind_grads()
        grad_flat.zero_()
        sync = sync_batchnorm(collectives) if sync_bn \
            else contextlib.nullcontext()
        with _dropout.step_key(key), sync:
            loss = criterion.apply(
                _forward(model, params, input, compute_dtype), target)
            total = loss + regularization_loss(model, params) if use_reg \
                else loss
            total.backward()
        with torch.no_grad():
            if spec is None:
                gchunk = collectives.psum_scatter(grad_flat)
            elif spec.quantized:
                g = grad_flat + ef_residual if use_ef else grad_flat
                gchunk, err = quantized_reduce_chunks(g, n, collectives,
                                                      spec, key)
                if use_ef:
                    ef_residual.copy_(err)
            else:
                gchunk = cast_reduce_chunks(grad_flat, n, collectives,
                                            spec.wire_dtype)
            gchunk.div_(n)              # a fresh tensor on every route
            if clip_value is not None:
                gchunk.clamp_(*clip_value)
            if clip_norm is not None:
                clip_by_global_norm(
                    {"": gchunk}, clip_norm,
                    sq_norm=collectives.psum(gchunk.square().sum()))
            if mchunk is not None:
                gchunk.mul_(mchunk)
            old = pchunk.clone() if keep_old else None
        optim_method.update(gchunk, opt_state, pchunk)
        with torch.no_grad():
            if mchunk is not None:
                pchunk.copy_(mchunk * pchunk + (1.0 - mchunk) * old)
            if spec is not None and spec.compress_weight_gather:
                dq, ds = quantize_blockwise(
                    pchunk - old, spec.block_size, spec.scale_dtype,
                    stochastic=stochastic, rng=key, salt=0x5157)
                dqf = collectives.all_gather(dq)
                dsf = collectives.all_gather(ds)
                pchunk.copy_(old)
                params_flat.add_(dequantize_blockwise(dqf, dsf,
                                                      spec.block_size))
            else:
                collectives.all_gather(pchunk, out=params_flat)
            for b in state_bufs:
                b.copy_(collectives.pmean(b))
            loss = collectives.pmean(loss.detach())
            if key is not None:
                key.add_(1)
        return opt_state, loss

    step.dropout_key = key
    step.live = [params_flat, *([ef_residual] if use_ef else [])]
    return step


class DistriOptimizer(BaseOptimizer):
    """Data-parallel optimizer with ZeRO-1 state sharding over a
    ``torch.distributed`` process group (reference:
    optim/DistriOptimizer.scala:52).  ``mesh``: the process group (None:
    ``Engine.mesh(device)``, which starts a world of one when no group
    is initialized); ``axis`` names it in the checkpoint's layout."""

    #: ``CompiledTrainStep.stats()`` of the last ``optimize()`` and
    #: whether its step was captured (NCCL) or ran eagerly (gloo)
    compiled_stats = None
    captured_route = None

    def __init__(self, model, dataset, criterion, optim_method=None,
                 mesh=None, axis="data", grad_compression=None,
                 sync_bn=False, device=None):
        super().__init__(model, dataset, criterion, optim_method,
                         device=device)
        self.mesh = mesh
        self.axis = axis
        CompressionSpec.parse(grad_compression)   # a bad spec fails here
        self.grad_compression = grad_compression
        self.sync_bn = sync_bn

    def set_sync_batchnorm(self, enabled=True):
        """BatchNorm statistics pooled over the ranks (SyncBN), so the
        step normalizes as one device would over the global batch.  Off
        by default: each rank normalizes its own rows, as the
        reference's workers do."""
        self.sync_bn = enabled
        return self

    def set_gradient_compression(self, spec=torch.bfloat16):
        """The wire format of the gradient reduction (and, with
        ``compress_weight_gather``, of the weight gather): any spelling
        ``CompressionSpec.parse`` takes -- ``torch.bfloat16`` (the
        default), ``"bf16"``, ``"fp16"``, ``"int8"``, or a
        ``CompressionSpec``."""
        CompressionSpec.parse(spec)
        self.grad_compression = spec
        return self

    def set_sharded_checkpoint(self, path, trigger):
        """Refused: the flat plane's orbax snapshots are not ported
        (ROADMAP A4; the card's machine has no orbax).  Use
        ``set_checkpoint``, whose pickle either package resumes."""
        raise UnsupportedFeatureError(
            "set_sharded_checkpoint: the flat plane's orbax sharded "
            "snapshots are not ported (ROADMAP A4: orbax is not "
            "available to the port); use set_checkpoint")

    def _refuse(self):
        if self.grad_transform is not None:
            raise UnsupportedFeatureError(
                "set_grad_transform operates on the model's gradient "
                "TREE; the dp+ZeRO-1 step reduces into per-rank chunks "
                "of the flat plane -- use LocalOptimizer for gradient "
                "transforms")
        if self._optim_methods_map:
            raise UnsupportedFeatureError(
                "set_optim_methods is incompatible with the dp+ZeRO-1 "
                "step: its chunks slice the FLAT parameter vector across "
                "ranks, not per-submodule subtrees; train with "
                "LocalOptimizer")

    def _load_snapshot(self, snap, flat_space, params_flat, opt_state, ef,
                       coll):
        """Copy a flat-plane snapshot into the flat parameters, this
        rank's state chunk, its residual row and the model state, after
        refitting an n -> m layout."""
        from bigdl_tpu_torch.interop.jax_params import (from_jax_opt_state,
                                                        load_jax_state)

        layout = (file_io.read_manifest(self._resume_path) or {}) \
            .get("layout") or {}
        if layout.get("kind", "dp") != "dp":
            raise UnsupportedFeatureError(
                f"{self._resume_path} was written under a "
                f"{layout['kind']!r} layout: resuming across layouts "
                f"(parallel/reshard) is not ported (ROADMAP A7)")
        mp = snap["model_params"]
        if not (isinstance(mp, dict) and "model_params_flat" in mp):
            raise ConfigurationError(
                f"{self._resume_path} holds a parameter tree, not a "
                f"data-parallel flat plane: resume it with LocalOptimizer")
        old = np.asarray(mp["model_params_flat"])
        old_padded = old.shape[-1]
        padded, true = flat_space.padded_size, flat_space.true_size
        with torch.no_grad():
            params_flat.copy_(torch.from_numpy(np.ascontiguousarray(
                refit_flat_plane(old, padded, true))))
            chunk = {}
            for k, v in snap["opt_state"].items():
                a = np.asarray(v)
                if a.ndim >= 1 and a.shape[-1] == old_padded:
                    a = flat_space.chunk(refit_flat_plane(a, padded, true),
                                         coll.rank)
                chunk[k] = a
            _copy_into(opt_state, from_jax_opt_state(
                self.optim_method, chunk, self.device))
            if ef is not None:
                saved = mp.get("ef_residual")
                if saved is None:
                    log.warning("checkpoint snapshot has no ef_residual "
                                "plane; starting error feedback from a "
                                "zero residual")
                else:
                    ef.copy_(torch.from_numpy(self._ef_rows(
                        saved, flat_space, coll.world)[coll.rank]))
        load_jax_state(self.model, snap.get("model_state", ()))
        self._apply_driver_state(snap["driver_state"])

    @staticmethod
    def _ef_rows(saved, flat_space, n):
        """The saved residual plane as ``n`` rows of the live layout: the
        same rank count keeps each row (padding refitted), another is
        re-partitioned by global offset."""
        rows = np.asarray(saved, np.float32)
        padded = flat_space.padded_size
        if rows.shape == (n, padded):
            return rows
        if rows.shape[0] == n:
            return refit_flat_plane(rows, padded, flat_space.true_size)
        log.info("re-partitioning the EF residual plane %s -> (%d, %d) "
                 "for the new rank count", rows.shape, n, padded)
        return repartition_ef_residual(rows, flat_space.true_size, n,
                                       padded)

    def _checkpoint(self, coll, flat_space, params_flat, opt_state, ef,
                    layout):
        """Rank 0 writes the JAX package's flat-plane snapshot; every
        rank takes part in gathering the state chunks and residual rows,
        and waits until it is written."""
        from bigdl_tpu_torch.interop.jax_params import (to_jax_opt_state,
                                                        to_jax_state)

        full = {k: coll.all_gather(v) if v.dim() >= 1 else v
                for k, v in opt_state.items()}
        rows = None if ef is None else \
            coll.all_gather(ef).reshape(coll.world, -1)
        if coll.rank == 0:
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            pdict = {"model_params_flat": params_flat}
            if rows is not None:
                pdict["ef_residual"] = rows
            file_io.save_checkpoint(
                self.checkpoint_path, self.driver_state["neval"], pdict,
                to_jax_state(self.model),
                to_jax_opt_state(self.optim_method, full), self.driver_state,
                manifest_meta={"layout": layout})
        coll.barrier(self.device)

    def _optimize_impl(self):
        self._refuse()
        coll = Collectives(self.mesh if self.mesh is not None
                           else Engine.mesh(self.device))
        n = coll.world
        train_iter = self.dataset.data(train=True)
        first_batch = next(train_iter)
        global_batch = first_batch.size()
        if global_batch % n != 0:
            raise ValueError(f"global batch {global_batch} not divisible "
                             f"by {n} ranks on axis '{self.axis}'")
        spec = CompressionSpec.parse(self.grad_compression)
        use_ef = spec is not None and spec.error_feedback
        # the chunk layout rounds to the quantization block, so a block
        # never straddles two ranks on the wire
        flat_space = FlatParamSpace(
            dict(self.model.named_parameters()), n,
            block_size=spec.block_size
            if spec is not None and spec.quantized else 1)
        params_flat, grad_flat = flat_space.bind(self.model)
        # every rank starts from rank 0's weights and model state
        coll.broadcast(params_flat)
        for b in self.model.buffers():
            coll.broadcast(b)
        opt_state = self.optim_method.init_state(
            torch.zeros(flat_space.chunk_size, device=self.device))
        ef = torch.zeros(flat_space.padded_size, device=self.device) \
            if use_ef else None
        if self._resume is not None:
            self._load_snapshot(self._resume, flat_space, params_flat,
                                opt_state, ef, coll)
        train_iter, first_batch = self._resume_data_stream(
            train_iter, first_batch)
        step_fn = make_distri_train_step(
            self.model, self.criterion, self.optim_method, flat_space, coll,
            params_flat, grad_flat, compute_dtype=self.compute_dtype,
            clip_value=self.clip_value, clip_norm=self.clip_norm,
            grad_compression=self.grad_compression, sync_bn=self.sync_bn,
            ef_residual=ef)
        # NCCL's collectives are captured in the step's graph; gloo's run
        # on the host and cannot be
        self.captured_route = "nccl-graph" if coll.native and \
            self.device.type == "cuda" else "eager"
        step = CompiledTrainStep(self.model, self.criterion,
                                 self.optim_method, opt_state, self.device,
                                 step_fn=step_fn, capture=coll.native)
        layout = layout_manifest(
            n, flat_space.padded_size, flat_space.true_size,
            flat_space.block_size,
            ef_shape=[n, flat_space.padded_size] if use_ef else None,
            axis=self.axis)
        #: per-step, per-rank wire bytes of the flat plane's collectives
        self.wire_summary = (
            uncompressed_wire_summary(flat_space.padded_size) if spec is None
            else spec.wire_summary(flat_space.padded_size))

        def dispatch(staged):
            x, target = staged
            RNG.next_generator()          # the step's stream position
            return step.run(x, target)

        try:
            self._run_driver_loop(
                train_iter, first_batch, dispatch,
                extra_summaries=lambda state: (
                    self._log_learning_rates(opt_state, state),
                    self._histograms(state)),
                validate_cb=lambda: validate(
                    self.model, self.validation_dataset,
                    self.validation_methods, self.compute_dtype),
                feed_plateau=lambda state: self._feed_plateau(
                    state, opt_state),
                checkpoint_cb=lambda state: self._checkpoint(
                    coll, flat_space, params_flat, opt_state, ef, layout),
                select=lambda tree: rank_rows(tree, coll.rank, n))
        finally:
            self.compiled_stats = step.stats()
            flat_space.unbind_grads()
        return self.model


class ParallelOptimizer(DistriOptimizer):
    """Reference: optim/ParallelOptimizer.scala:69 (per-layer
    asynchronous gradient sync).  As in the JAX package the step's
    schedule overlaps what it can and this name shares
    ``DistriOptimizer``'s implementation, so reference call sites
    resolve."""
