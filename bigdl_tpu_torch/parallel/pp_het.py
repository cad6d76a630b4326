"""Pipeline parallelism for any stateless ``Sequential`` -- CNNs,
uneven cuts, stages of different structure (counterpart of
``bigdl_tpu/parallel/pp_het.py``: ``partition_sequential`` :45,
``_boundary_specs`` :94, ``make_het_pp_train_step`` :108,
``merge_stage_params`` :247).

The children are cut into ``S`` contiguous stages, by parameter count
(JAX's greedy prefix split) or at ``boundaries=`` (the child indices
that start stages 1 to ``S - 1``).  Rank ``s`` of the pipe axis holds a
``HetStage``: copies of its stage's children under their own keys
(``"3"``, ``"4"`` ...), so its parameter names are the model's.  JAX
replicates every stage's parameters on every device and picks a stage
body by ``lax.switch``; each rank here holds and updates only its own
stage's, which changes no result: JAX's replicated update applies the
same full gradient everywhere.

The schedule is JAX's GPipe: ``M + S - 1`` forward ticks, stage ``s``
running microbatch ``t - s`` at tick ``t``; the loss on the last stage
over the concatenated microbatches, the logits cast to fp32 (JAX
:199-200); then the mirrored backward ticks, each a backward through one
microbatch's kept graph.  The loss is summed over the pipe and averaged
over the data axis, and so are the gradients over the data axis.

JAX moves every activation through one padded flat ring buffer in the
compute dtype, because ``ppermute`` needs one static shape on every hop.
Here each boundary crosses at its own static shape and dtype (no pad
bytes): point-to-point sends on NCCL (``batch_isend_irecv``, captured
in the step's CUDA graph), one ``all_reduce`` of a zero plane a
boundary on gloo (a sum with zeros is exact).  The shapes come from one
forward of a zero microbatch on the device in the compute dtype before
the step is built (JAX's ``_boundary_specs``).  Floating activations
travel in the compute dtype; the input reaches stage 0 at its own dtype
(floating inputs cast as ``make_train_step`` casts them), and an
integer boundary stays integer -- JAX's ``embed_input`` casts the raw
input to the compute dtype, so in bf16 it corrupts token ids above 256
(``ROADMAP.md`` queue C).

Refused as JAX refuses them: frozen modules, floating module state
(BatchNorm's running statistics), and a batch other than the one the
step was built for.
"""

import copy

import torch
import torch.distributed as dist
from torch.func import functional_call

from bigdl_tpu_torch.nn import dropout as _dropout
from bigdl_tpu_torch.nn.module import Container, has_frozen
from bigdl_tpu_torch.optim.train_step import _cast_params, _cast_tree
from bigdl_tpu_torch.parallel.pp import _MICRO_STRIDE, pp_rows
from bigdl_tpu_torch.parallel.strategy_step import (reduce_flat,
                                                    step_dropout_key)


def _children(model):
    return list(model._modules.items())


def _child_tree(child):
    """A child's parameter tree in JAX's form: ``()`` when it has none."""
    tree = child.parameters_tree()
    return tree if tree else ()


def partition_sequential(model, n_stages, boundaries=None):
    """Split a ``Sequential`` into pipeline stages.

    ``boundaries``: the child indices that START stages 1..n-1 (stage 0
    starts at child 0), ``n_stages - 1`` of them; omitted, the stages are
    balanced by parameter count (a greedy prefix split: a cut whenever
    the running stage reaches its fair share, leaving enough children
    for the stages after it).

    -> ``(slices, stage_params)``: each stage's ``(start, stop)`` child
    range, and each stage's ``{str(j): child j's parameter tree}`` for
    every child of it (``()`` for a child without parameters, as in
    JAX's tree)."""
    children = _children(model)
    n_children = len(children)
    if boundaries is None:
        sizes = [sum(p.numel() for p in c.parameters()) for _, c in children]
        total = sum(sizes)
        boundaries = []
        acc = 0
        for i, s in enumerate(sizes):
            acc += s
            left = n_stages - 1 - len(boundaries)
            if (left > 0 and acc >= total / n_stages
                    and n_children - (i + 1) >= left):
                boundaries.append(i + 1)
                acc = 0
        while len(boundaries) < n_stages - 1:   # param-less tails
            boundaries.append(n_children - (n_stages - 1 - len(boundaries)))
    boundaries = list(boundaries)
    if len(boundaries) != n_stages - 1:
        raise ValueError(
            f"need {n_stages - 1} boundaries for {n_stages} stages, got "
            f"{len(boundaries)}")
    cuts = [0] + boundaries + [n_children]
    if any(cuts[i] >= cuts[i + 1] for i in range(n_stages)):
        raise ValueError(f"empty stage in boundaries {boundaries} "
                         f"({n_children} children)")
    slices = [(cuts[i], cuts[i + 1]) for i in range(n_stages)]
    stage_params = [{children[j][0]: _child_tree(children[j][1])
                     for j in range(a, b)} for a, b in slices]
    return slices, stage_params


def merge_stage_params(model, stage_params_list):
    """Fold per-stage subtrees back into the Sequential's tree."""
    out = {}
    for sub in stage_params_list:
        out.update(sub)
    return out


def to_stage_trees(tree, slices):
    """A checkpoint's trees in the model's layout (``{"params": ...,
    "opt_state": ...}``) -> the heterogeneous pipeline's: every subtree
    keyed by the model's children (the parameters, Adam's moments, the
    velocity) split into JAX's list of per-stage subtrees."""
    keys = {str(j) for j in range(slices[-1][1])}

    def split(v):
        if isinstance(v, dict) and set(v) == keys:
            return [{str(j): v[str(j)] for j in range(a, b)}
                    for a, b in slices]
        if isinstance(v, dict):
            return {k: split(x) for k, x in v.items()}
        return v

    return split(tree)


def from_stage_trees(tree):
    """The inverse of ``to_stage_trees``: every list of per-stage
    subtrees merged into one tree keyed by the children."""
    if isinstance(tree, list) and all(isinstance(v, dict) for v in tree):
        return merge_stage_params(None, tree)
    if isinstance(tree, dict):
        return {k: from_stage_trees(v) for k, v in tree.items()}
    return tree


class HetStage(Container):
    """Children ``start`` to ``stop`` of a Sequential, copied under their
    own keys: what a rank of the heterogeneous pipeline holds."""

    def __init__(self, model, start, stop):
        super().__init__()
        self.start, self.stop = int(start), int(stop)
        for key, child in _children(model)[self.start:self.stop]:
            self.add(key, copy.deepcopy(child))

    def forward(self, x):
        for m in self._modules.values():
            x = m(x)
        return x


@torch.no_grad()
def _boundary_specs(model, slices, input_spec, compute_dtype=None):
    """``(shape, dtype)`` of the activation entering each stage (index 0:
    the model's input as stage 0 takes it) and of the output, from one
    forward of a zero microbatch on the model's device in the compute
    dtype (``input_spec``: anything with ``.shape`` and ``.dtype``)."""
    device = next(model.parameters()).device
    x = _cast_tree(torch.zeros(tuple(input_spec.shape),
                               dtype=input_spec.dtype, device=device),
                   compute_dtype)
    specs = [(tuple(x.shape), x.dtype)]
    starts = {a for a, _ in slices[1:]}
    was = model.training
    model.eval()
    try:
        for j, (_, child) in enumerate(_children(model)):
            cp = _cast_params(dict(child.named_parameters()), compute_dtype)
            x = functional_call(child, cp, (x,))
            if j + 1 in starts:
                specs.append((tuple(x.shape), x.dtype))
    finally:
        model.train(was)
    return specs, (tuple(x.shape), x.dtype)


def _hop(pipe, moves, x, device):
    """One tick's hops along the pipe.  ``moves`` lists ``(src, dst,
    (shape, dtype))`` of every pair that moves a tensor this tick, the
    same list on every rank; ``x`` is what this rank sends (None: zeros,
    a boundary whose gradient is not defined).  Returns what this rank
    receives, or None."""
    me, out = pipe.rank, None
    if pipe.native:
        ops = []
        for src, dst, (shape, dtype) in moves:
            if src == me:
                send = x.detach().contiguous() if x is not None else \
                    torch.zeros(shape, dtype=dtype, device=device)
                ops.append(dist.P2POp(dist.isend, send, pipe._peer(dst),
                                      pipe.group))
            if dst == me:
                out = torch.empty(shape, dtype=dtype, device=device)
                ops.append(dist.P2POp(dist.irecv, out, pipe._peer(src),
                                      pipe.group))
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
        return out
    for src, dst, (shape, dtype) in moves:
        plane = torch.zeros(shape, dtype=dtype, device=device)
        if src == me and x is not None:
            plane.copy_(x.detach())
        dist.all_reduce(plane, group=pipe.group)
        if dst == me:
            out = plane
    return out


def batch_mismatch(n, n_microbatches, data_size, mb):
    """JAX's error for a batch other than the compiled one (:222-232)."""
    expected = n_microbatches * data_size * mb
    return ValueError(
        f"batch {n} != the compiled pipeline batch {expected} "
        f"({n_microbatches} microbatches x {data_size} data "
        f"shards x microbatch {mb}); use SampleToMiniBatch"
        f"(..., drop_remainder=True) or a batch-preserving "
        f"dataset")


def refuse(model):
    """JAX's refusals (:123-133): frozen modules, floating module state."""
    if has_frozen(model):
        raise NotImplementedError(
            "freeze() is not honored by the pipeline engines; unfreeze() "
            "or train with LocalOptimizer/DistriOptimizer")
    if any(b.is_floating_point() for b in model.buffers()):
        raise NotImplementedError(
            "pipelined Sequential with floating module state (BatchNorm "
            "running stats) is not supported; swap BN for a stateless "
            "normalization or train data-parallel")


def make_het_pp_train_step(model, criterion, optim_method, mesh,
                           n_microbatches, input_spec, boundaries=None,
                           pipe_axis="pipe", data_axis=None,
                           compute_dtype=None):
    """The heterogeneous GPipe step: ``step(opt_state, input, target) ->
    (opt_state, loss)`` on this rank's ``HetStage`` of ``model``
    (``step.stage``, its parameters updated in place; ``step.slices``
    the stages' child ranges, ``step.specs`` the boundaries' shapes and
    dtypes).  ``input`` / ``target`` are this rank's rows of every
    microbatch, microbatch-major (``pp_rows``).  ``input_spec``: one
    microbatch of this rank (anything with ``.shape`` and ``.dtype``,
    e.g. a meta tensor); a batch of another size raises JAX's
    ``ValueError``.  ``step.live`` and ``step.dropout_key`` are what
    ``optim.graphs.CompiledTrainStep`` reads."""
    refuse(model)
    pipe = mesh.collectives(pipe_axis)
    data = mesh.collectives(data_axis) if data_axis is not None else None
    data_size = data.world if data is not None else 1
    S, s, M = pipe.world, pipe.rank, int(n_microbatches)
    slices, _ = partition_sequential(model, S, boundaries)
    specs, _ = _boundary_specs(model, slices, input_spec, compute_dtype)
    mb = int(input_spec.shape[0])
    stage = HetStage(model, *slices[s])
    params = dict(stage.named_parameters())
    device = next(model.parameters()).device
    key = step_dropout_key(stage, mesh.axis_index(data_axis)
                           if data_axis is not None else 0)
    last = s == S - 1
    n = M + S - 1
    fwd = [[(r, r + 1, specs[r + 1]) for r in range(S - 1)
            if 0 <= t - r < M] for t in range(n)]
    bwd = [[(r, r - 1, specs[r]) for r in range(1, S)
            if 0 <= u - (S - 1 - r) < M and specs[r][1].is_floating_point]
           for u in range(n)]

    def run(cp, x):
        if compute_dtype is None:
            return stage(x)
        return functional_call(stage, cp, (x,))

    def step(opt_state, input, target):
        if input.shape[0] != M * mb:
            raise batch_mismatch(input.shape[0] * data_size, M, data_size,
                                 mb)
        stage.train()
        stage.zero_grad(set_to_none=True)
        xs, ys = input.chunk(M), target.chunk(M)
        keys = [None] * M if key is None else \
            [key + m * _MICRO_STRIDE for m in range(M)]
        cp = _cast_params(params, compute_dtype)
        ins, outs, recv = {}, {}, None
        for t in range(n):
            m, out = t - s, None
            if 0 <= m < M:
                inp = _cast_tree(xs[m], compute_dtype) if s == 0 else recv
                if s > 0 and inp.is_floating_point():
                    inp.requires_grad_()
                with _dropout.step_key(keys[m]):
                    out = run(cp, inp)
                ins[m], outs[m] = inp, out
            if fwd[t]:
                recv = _hop(pipe, fwd[t], out, device)
        loss = torch.zeros((), device=device)
        if last:
            hs = [outs[m].detach().requires_grad_() for m in range(M)]
            loss = criterion.apply(_cast_tree(torch.cat(hs), torch.float32),
                                   torch.cat(ys))
            loss.backward()
            seeds = [h.grad for h in hs]
        grecv = None
        for u in range(n):
            m, dinp = u - (S - 1 - s), None
            if 0 <= m < M:
                out, inp = outs.pop(m), ins.pop(m)
                if out.requires_grad:
                    with _dropout.step_key(keys[m]):
                        torch.autograd.backward(
                            out, seeds[m] if last else grecv)
                dinp = inp.grad if s > 0 else None
            if bwd[u]:
                grecv = _hop(pipe, bwd[u], dinp, device)
        if key is not None:
            key.add_(1)
        grads = {k: p.grad.float() if p.grad is not None
                 else torch.zeros_like(p) for k, p in params.items()}
        with torch.no_grad():
            loss = loss.detach().float().reshape(1)
            if S > 1:
                loss = pipe.psum(loss)
            if data is not None and data.world > 1:
                out = dict(grads)
                out[None] = loss
                reduce_flat(out, data, mean=True)
                loss = out.pop(None)
                grads = out
        optim_method.update(grads, opt_state, params)
        return opt_state, loss.reshape(())

    step.stage = stage
    step.slices = slices
    step.specs = specs
    step.dropout_key = key
    step.live = []
    return step


def het_rows(tree, n_microbatches, mb, data_index=0, data_size=1):
    """``pp_rows`` of a global batch after JAX's check that it is the
    batch the step was built for."""
    first = tree
    while isinstance(first, (tuple, list)):
        first = first[0]
    n = first.shape[0]
    if n != n_microbatches * data_size * mb:
        raise batch_mismatch(n, n_microbatches, data_size, mb)
    return pp_rows(tree, n_microbatches, data_index, data_size)


def het_gather(local, collectives, template):
    """``{name: tensor}`` of every stage (``collectives`` over the pipe)
    -> the whole model's ``{name: tensor}`` on every rank, in the order,
    shapes, dtype and device of ``template`` (the model's
    ``{name: parameter}``): one all-reduce of the flat concatenation,
    each rank filling its own stage's part (a sum with zeros is exact)."""
    if collectives.world == 1:
        return dict(local)
    ref = next(iter(template.values()))
    total = sum(t.numel() for t in template.values())
    flat = torch.zeros(total, dtype=ref.dtype, device=ref.device)
    at, where = 0, {}
    for k, t in template.items():
        where[k] = (at, t.numel(), t.shape)
        if k in local:
            flat[at:at + t.numel()].copy_(local[k].reshape(-1))
        at += t.numel()
    flat = collectives.psum(flat)
    return {k: flat[a:a + size].view(shape)
            for k, (a, size, shape) in where.items()}
