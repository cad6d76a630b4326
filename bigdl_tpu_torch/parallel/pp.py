"""Pipeline parallelism for TransformerLM over a ``"pipe"`` mesh axis
(counterpart of ``bigdl_tpu/parallel/pp.py``: ``stack_stage_params`` :35,
``unstack_stage_params`` :59, ``pp_shardings`` :74, ``make_pp_loss_fn``
:123, ``make_pp_train_step`` :229, ``make_pp_1f1b_train_step`` :262,
``init_pp_opt_state`` :468).

The blocks are cut into ``S`` contiguous stages of ``L / S`` blocks
each (an uneven cut raises ``ValueError``: JAX's ``len(blocks) //
n_stages`` drops the trailing blocks).  Rank ``s`` of the pipe axis
holds a ``PipelineStage``: its own blocks, and the embedding and the
tail (``ln_f``, ``head``) replicated, as JAX's ``pp_shardings`` lays out
the stage-stacked tree ``{embed, stages, tail}``.  Activations move one
hop down the pipe a tick (``Collectives.ppermute``: ``batch_isend_irecv``
on NCCL, captured in the step's CUDA graph; composed from ``all_reduce``
on gloo); their gradients one hop up.

Two schedules, each one static list of ticks on every rank:

- ``"gpipe"`` (``make_pp_train_step``): ``M + S - 1`` forward ticks,
  stage ``s`` running microbatch ``t - s`` at tick ``t``; the tail on
  the last stage over the concatenated microbatches (JAX :188-192); then
  ``M + S - 1`` backward ticks in the mirrored order, each a backward
  through one microbatch's kept graph.  The graphs of all ``M``
  microbatches are alive at the tail, as in JAX's differentiated scan.
- ``"1f1b"`` (``make_pp_1f1b_train_step``): ``M + 2S - 1`` ticks, stage
  ``s`` running the forward of microbatch ``t - s`` (no graph kept; its
  input stashed) and the backward of microbatch ``t - (2S - 1 - s)``
  (its forward recomputed under autograd from the stash, JAX's per-stage
  ``jax.vjp``) in the same tick; the last stage runs the tail and its
  backward per microbatch.  At most ``2S - 1`` stage inputs are stashed:
  the activation memory does not grow with ``M``.  The gradients and
  the loss are summed over the microbatches and divided by ``M`` at the
  flush (JAX :416-429).

JAX computes every tick on every device and masks the bubbles away; here
a bubble computes nothing, and a hop runs only at the ticks where some
stage sends a microbatch.  Dropout draws its masks from a key per
microbatch (the step's key plus ``m * _MICRO_STRIDE``) and the global
block index, so both schedules, and 1F1B's recompute, draw the same
masks.

After the backward, the replicated embedding and tail gradients (real
on the first and the last stage, zero elsewhere) are summed over the
pipe, with the loss, in one all-reduce, and every gradient and the loss
averaged over the data axis in another: every rank then holds the
gradient of the global mean loss for its parameters and reports the
same loss (JAX's ``psum`` over ``"pipe"``, :193-194).

With tensor parallelism (``tp=``, the ``"model"`` axis of a 3-D
``("data", "pipe", "model")`` mesh; JAX's ``pp_tp_shardings`` :85 and
``manual_axes=("data", "pipe")``) a stage's blocks are its
``"model"`` rank's Megatron shards (``parallel/tp.py``'s
``_shard_leaf``: heads cut inside each of q, k and v, ``fc1`` by rows,
``out`` and ``fc2`` by columns) and run the tp collectives themselves;
the embedding and the tail stay whole on every rank, so the last
stage's loss is the plain one (not the vocabulary-parallel form: JAX
leaves ``head`` replicated here).  A hop pairs a stage's ``"model"``
rank with the same rank of the next stage: the pipe's groups are the
mesh's lines along ``"pipe"``.  The blocks' gradients come from the tp
collectives' transposes, the replicated ones from the pipe's sum, each
summed once.
"""

import copy

import torch
import torch.nn.functional as F
from torch.func import functional_call

from bigdl_tpu_torch.nn import dropout as _dropout
from bigdl_tpu_torch.nn.module import Container
from bigdl_tpu_torch.optim.train_step import _cast_params, _cast_tree
from bigdl_tpu_torch.parallel.reshard import (blocks_to_pp_tree,
                                              pp_tree_to_blocks)
from bigdl_tpu_torch.parallel.strategy_step import (reduce_flat,
                                                    refuse_frozen,
                                                    step_dropout_key)
from bigdl_tpu_torch.parallel.tp import (TRANSFORMER_TP_RULES, _gather_leaf,
                                         _shard_leaf, _sharded_dim,
                                         check_divisible, spec_for)
from bigdl_tpu_torch.utils.errors import (ConfigurationError,
                                          UnsupportedFeatureError)

#: offset of microbatch m's dropout key: ``m * _MICRO_STRIDE``
_MICRO_STRIDE = 1 << 20

#: the replicated parameters of every stage (embedding and tail)
_REPLICATED = ("wte", "wpe", "ln_f", "head")


def layers_per_stage(n_layers, n_stages):
    """``n_layers / n_stages``; a cut that leaves a remainder raises."""
    n_layers, n_stages = int(n_layers), int(n_stages)
    if n_stages < 1 or n_layers % n_stages:
        raise ValueError(
            f"cannot cut {n_layers} transformer blocks into {n_stages} "
            f"pipeline stages: the block count must divide evenly")
    return n_layers // n_stages


def _check_model(model):
    from bigdl_tpu_torch.nn.attention import TransformerLM

    if not isinstance(model, TransformerLM):
        raise UnsupportedFeatureError(
            f"the stage-stacked pipeline trains TransformerLM, not "
            f"{type(model).__name__}; a Sequential pipelines through "
            f"parallel/pp_het.py (Optimizer(strategy='pp') picks it)")
    if model.scan is not None:
        raise UnsupportedFeatureError(
            "strategy='pp' on the scan_layers layout: the pipeline stacks "
            "the blocks by stage; build the model unrolled "
            "(scan_layers=False)")
    if model.tp is not None:
        raise UnsupportedFeatureError(
            "the pipeline takes the plain TransformerLM; tensor_parallel="
            "True shards each stage's blocks itself")
    if model.seq_axis_name is not None:
        raise UnsupportedFeatureError(
            "pp with sequence parallelism: the JAX package has no such "
            "composition (pp composes with data and tensor parallelism)")


def stack_stage_params(model, n_stages):
    """A TransformerLM's parameters as the stage-stacked tree ``{embed:
    {wte, wpe}, stages: {layer{j}: block-params stacked on dim 0},
    tail: {ln_f, head}}`` (detached tensors)."""
    _check_model(model)
    layers_per_stage(len(model.blocks), n_stages)
    return blocks_to_pp_tree(model.parameters_tree(), n_stages)


def unstack_stage_params(model, pp_params):
    """Inverse of ``stack_stage_params``: the model's own tree."""
    return pp_tree_to_blocks(pp_params)


class PipelineStage(Container):
    """Stage ``stage`` of ``n_stages`` of a TransformerLM, what a rank of
    the pipe holds (JAX's ``pp_shardings``: the stacked leaves' slice
    ``stage``, embed and tail replicated): copies of its blocks as
    ``layer{j}`` (block ``stage * lps + j``), of ``wte``, ``wpe``,
    ``ln_f`` and ``head``.  With ``tp`` (the ``"model"`` axis's
    ``Collectives``) the blocks hold that rank's shards under ``rules``
    (JAX's ``pp_tp_shardings``) and run the tp collectives; ``tp_specs``
    maps each local parameter name to its spec.  ``forward(x, part)``
    runs one part: ``"embed"`` (token ids -> activations), ``"blocks"``
    or ``"tail"`` (activations -> logits)."""

    def __init__(self, model, stage, n_stages, tp=None,
                 rules=TRANSFORMER_TP_RULES):
        super().__init__()
        _check_model(model)
        self.lps = layers_per_stage(len(model.blocks), n_stages)
        self.first = int(stage) * self.lps
        for name in ("wte", "wpe", "head"):
            setattr(self, name, torch.nn.Parameter(
                getattr(model, name).detach().clone()))
        self.layers = [copy.deepcopy(model.blocks[self.first + j])
                       for j in range(self.lps)]
        for j, b in enumerate(self.layers):
            self.add(f"layer{j}", b)
        self.ln_f = copy.deepcopy(model.ln_f)
        self.tp = tp
        self.tp_specs = {}
        if tp is not None:
            self._shard_blocks(model, tp, rules)

    def _shard_blocks(self, model, tp, rules):
        n, r = tp.world, tp.rank
        heads = model.blocks[0].attn.num_heads
        if heads % n:
            raise ValueError(f"num_heads {heads} is not divisible by the "
                             f"'model' axis size {n}")
        check_divisible({f"block{self.first + j}": b.parameters_tree()
                         for j, b in enumerate(self.layers)}, rules, n)
        for j, b in enumerate(self.layers):
            for name, p in list(b.named_parameters()):
                path = (f"block{self.first + j}", *name.split("."))
                spec = spec_for(path, p.dim(), rules)
                self.tp_specs[f"layer{j}.{name}"] = spec
                owner, _, key = name.rpartition(".")
                b.get_submodule(owner)._parameters[key] = torch.nn.Parameter(
                    _shard_leaf(path, p.detach(), spec, "model", r,
                                n).clone())
            b.tp = b.attn.tp = tp
            b.attn.num_heads //= n

    def logical_name(self, name):
        """``layer{j}.<rest>`` -> ``block{first + j}.<rest>``; the
        replicated parameters keep their names."""
        head, _, rest = name.partition(".")
        if head.startswith("layer"):
            return f"block{self.first + int(head[5:])}.{rest}"
        return name

    def sharded(self, name):
        """Whether the local parameter ``name`` is a ``"model"`` shard."""
        spec = self.tp_specs.get(name)
        return spec is not None and self.tp.world > 1 and \
            _sharded_dim(spec, "model") is not None

    def forward(self, x, part="blocks"):
        if part == "embed":
            return self.wte[x.long()] + self.wpe[:x.shape[1]][None]
        if part == "tail":
            return F.linear(self.ln_f(x), self.head.to(x.dtype))
        for b in self.layers:
            x = b(x)
        return x


def gather_logical(stage, local, collectives):
    """``{local name: tensor}`` of every stage (``collectives`` over the
    pipe) -> ``{logical name: tensor}`` on every rank: the ``"model"``
    shards of a tensor-parallel stage gathered first (over
    ``stage.tp``), then the replicated tensors as they are and each
    stage's blocks from one all-gather of their concatenation."""
    local = {k: _gather_leaf(tuple(stage.logical_name(k).split(".")), v,
                             stage.tp_specs[k], stage.tp, "model")
             if stage.sharded(k) else v for k, v in local.items()}
    out = {stage.logical_name(k): v for k, v in local.items()
           if k.split(".")[0] in _REPLICATED}
    names = [k for k in local if k.split(".")[0] not in _REPLICATED]
    if collectives.world == 1:
        out.update({stage.logical_name(k): local[k] for k in names})
        return out
    flat = torch.cat([local[k].reshape(-1) for k in names])
    parts = collectives.all_gather(flat).reshape(collectives.world, -1)
    for s in range(collectives.world):
        at = 0
        for k in names:
            n = local[k].numel()
            head, _, rest = k.partition(".")
            idx = s * stage.lps + int(head[5:])
            out[f"block{idx}.{rest}"] = parts[s, at:at + n].view_as(local[k])
            at += n
    return out


def local_of(stage, logical):
    """The stage's ``{local name: tensor}`` out of a logical dict (a
    tensor-parallel stage's shards cut from the logical leaves)."""
    out = {}
    for k, _ in stage.named_parameters():
        v = logical[stage.logical_name(k)]
        if stage.sharded(k):
            v = _shard_leaf(tuple(stage.logical_name(k).split(".")), v,
                            stage.tp_specs[k], "model", stage.tp.rank,
                            stage.tp.world)
        out[k] = v
    return out


def pp_sq_norm(grads, collectives, stage=None):
    """The squared norm of the logical gradient tree from a stage's
    gradients: the ``"model"`` shards' squares summed over the model
    axis (``stage.tp``), the blocks' summed over the pipe
    (``collectives``), the replicated ones counted once."""
    rep, blocks, shards = [], [], []
    for k, g in grads.items():
        sq = g.float().square().sum()
        if k.split(".")[0] in _REPLICATED:
            rep.append(sq)
        elif stage is not None and stage.sharded(k):
            shards.append(sq)
        else:
            blocks.append(sq)
    total = torch.stack(blocks).sum() if blocks else \
        torch.zeros((), device=next(iter(grads.values())).device)
    if shards:
        total = total + stage.tp.psum(torch.stack(shards).sum())
    if collectives.world > 1:
        total = collectives.psum(total)
    return total + torch.stack(rep).sum() if rep else total


def _hops(n_ticks, senders, valid):
    """Per tick, whether any sending stage has a valid microbatch then
    (every rank computes the same list)."""
    return [any(valid(t, s) for s in senders) for t in range(n_ticks)]


class _Schedule:
    """The pieces both schedules and the loss function share, on this
    rank: its ``PipelineStage``, the pipe's and the data axis's
    collectives, the forward of a part (in the compute dtype through
    ``functional_call``), the tail's loss and a hop."""

    def __init__(self, model, criterion, mesh, n_microbatches, pipe_axis,
                 data_axis, compute_dtype, model_axis=None):
        self.pipe = mesh.collectives(pipe_axis)
        self.data = mesh.collectives(data_axis) \
            if data_axis is not None else None
        self.S, self.s = self.pipe.world, self.pipe.rank
        self.M = int(n_microbatches)
        self.last = self.s == self.S - 1
        self.stage = PipelineStage(
            model, self.s, self.S, tp=mesh.collectives(model_axis)
            if model_axis is not None else None)
        self.params = dict(self.stage.named_parameters())
        self.criterion = criterion
        self.cdt = compute_dtype
        self.device = self.stage.wte.device
        self.fwd_perm = [(i, i + 1) for i in range(self.S - 1)]
        self.bwd_perm = [(i + 1, i) for i in range(self.S - 1)]

    def run(self, cp, x, part):
        if self.cdt is None:
            return self.stage(x, part=part)
        return functional_call(self.stage, cp, (x,), {"part": part})

    def tail_loss(self, cp, h, y):
        return self.criterion.apply(
            _cast_tree(self.run(cp, h, "tail"), torch.float32), y)

    def hop(self, x, shape, perm):
        """One ``ppermute`` of ``x`` (zeros where this rank sends
        nothing) along ``perm``."""
        if x is None:
            x = torch.zeros(shape, dtype=self.cdt or torch.float32,
                            device=self.device)
        return self.pipe.ppermute(x.detach(), perm)

    def gpipe_forward(self, cp, xs, keys, shape):
        """GPipe's ``M + S - 1`` forward ticks: ``(ins, outs)`` of this
        stage's microbatches."""
        S, s, M = self.S, self.s, self.M
        n = M + S - 1
        hops = _hops(n, range(S - 1), lambda t, r: 0 <= t - r < M)
        ins, outs, recv = {}, {}, None
        for t in range(n):
            m, out = t - s, None
            if 0 <= m < M:
                inp = self.run(cp, xs[m], "embed") if s == 0 \
                    else recv.requires_grad_(torch.is_grad_enabled())
                with _dropout.step_key(keys[m]):
                    out = self.run(cp, inp, "blocks")
                ins[m], outs[m] = inp, out
            if hops[t]:
                recv = self.hop(out if not self.last else None, shape,
                                self.fwd_perm)
        return ins, outs

    def gpipe(self, cp, xs, ys, keys, shape):
        """One GPipe step's gradients (accumulated in the parameters'
        ``.grad``) and this rank's loss (the last stage's; 0 elsewhere)."""
        S, s, M = self.S, self.s, self.M
        ins, outs = self.gpipe_forward(cp, xs, keys, shape)
        loss = torch.zeros((), device=self.device)
        if self.last:
            hs = [outs[m].detach().requires_grad_() for m in range(M)]
            loss = self.tail_loss(cp, torch.cat(hs), torch.cat(ys))
            loss.backward()
            seeds = [h.grad for h in hs]
        n = M + S - 1
        hops = _hops(n, range(1, S), lambda u, r: 0 <= u - (S - 1 - r) < M)
        grecv = None
        for u in range(n):
            m, dinp = u - (S - 1 - s), None
            if 0 <= m < M:
                with _dropout.step_key(keys[m]):
                    torch.autograd.backward(
                        outs.pop(m), seeds[m] if self.last else grecv)
                inp = ins.pop(m)
                dinp = inp.grad if s > 0 else None
            if hops[u]:
                grecv = self.hop(dinp, shape, self.bwd_perm)
        return loss.detach()

    def one_f_one_b(self, cp, xs, ys, keys, shape):
        """One 1F1B step's gradients and loss, both summed over the
        microbatches (the flush divides them by ``M``)."""
        S, s, M = self.S, self.s, self.M
        n = M + 2 * S - 1
        fwd_hops = _hops(n, range(S - 1), lambda t, r: 0 <= t - r < M)
        bwd_hops = _hops(n, range(1, S),
                         lambda t, r: 0 <= t - (2 * S - 1 - r) < M)
        stash, seeds, recv_f, recv_b = {}, {}, None, None
        loss = torch.zeros((), device=self.device)
        for t in range(n):
            mf, out = t - s, None
            if 0 <= mf < M:
                with torch.no_grad(), _dropout.step_key(keys[mf]):
                    inp = self.run(cp, xs[mf], "embed") if s == 0 \
                        else recv_f
                    out = self.run(cp, inp, "blocks")
                if s > 0:
                    stash[mf] = inp
                if self.last:
                    o = out.requires_grad_()
                    loss_m = self.tail_loss(cp, o, ys[mf])
                    loss_m.backward()
                    seeds[mf] = o.grad
                    loss = loss + loss_m.detach()
            mb, dx = t - (2 * S - 1 - s), None
            if 0 <= mb < M:
                with _dropout.step_key(keys[mb]):
                    xin = self.run(cp, xs[mb], "embed") if s == 0 \
                        else stash.pop(mb).requires_grad_()
                    torch.autograd.backward(
                        self.run(cp, xin, "blocks"),
                        seeds.pop(mb) if self.last else recv_b)
                dx = xin.grad if s > 0 else None
            if fwd_hops[t]:
                recv_f = self.hop(out if not self.last else None, shape,
                                  self.fwd_perm)
            if bwd_hops[t]:
                recv_b = self.hop(dx, shape, self.bwd_perm)
        return loss

    def reduce(self, grads, loss):
        """``(grads, loss)`` reduced: the replicated parameters' gradients
        and the loss summed over the pipe, then every gradient and the
        loss averaged over the data axis (each in one all-reduce)."""
        out = dict(grads)
        out[None] = loss
        if self.S > 1:
            rep = {k: out[k] for k in out
                   if k is None or k.split(".")[0] in _REPLICATED}
            reduce_flat(rep, self.pipe)
            out.update(rep)
        if self.data is not None and self.data.world > 1:
            reduce_flat(out, self.data, mean=True)
        return out, out.pop(None)

    def microbatches(self, input, target, key):
        xs = input.chunk(self.M)
        ys = None if target is None else target.chunk(self.M)
        shape = (xs[0].shape[0], xs[0].shape[1], self.stage.wte.shape[1])
        keys = [None] * self.M if key is None else \
            [key + m * _MICRO_STRIDE for m in range(self.M)]
        return xs, ys, keys, shape


def _make_step(model, criterion, optim_method, mesh, n_microbatches,
               pipe_axis, data_axis, compute_dtype, schedule, model_axis):
    refuse_frozen(model)
    sch = _Schedule(model, criterion, mesh, n_microbatches, pipe_axis,
                    data_axis, compute_dtype, model_axis)
    stage, params, M = sch.stage, sch.params, sch.M
    key = step_dropout_key(stage, mesh.axis_index(data_axis)
                           if data_axis is not None else 0)
    body = sch.gpipe if schedule == "gpipe" else sch.one_f_one_b

    def step(opt_state, input, target):
        stage.train()
        stage.zero_grad(set_to_none=True)
        xs, ys, keys, shape = sch.microbatches(input, target, key)
        loss = body(_cast_params(params, compute_dtype), xs, ys, keys, shape)
        if key is not None:
            key.add_(1)
        grads = {k: p.grad.float() if p.grad is not None
                 else torch.zeros_like(p) for k, p in params.items()}
        with torch.no_grad():
            loss = loss.float().reshape(1)
            if schedule == "1f1b":
                # the flush: the microbatches' sums -> the batch's mean
                for g in grads.values():
                    g.div_(M)
                loss.div_(M)
            grads, loss = sch.reduce(grads, loss)
        optim_method.update(grads, opt_state, params)
        return opt_state, loss.reshape(())

    step.stage = stage
    step.dropout_key = key
    step.live = []
    return step


def make_pp_train_step(model, criterion, optim_method, mesh,
                       n_microbatches, pipe_axis="pipe", data_axis=None,
                       compute_dtype=None, model_axis=None):
    """The GPipe step: ``step(opt_state, input, target) -> (opt_state,
    loss)`` on this rank's ``PipelineStage`` of ``model`` (``step.stage``,
    its parameters updated in place; ``init_pp_opt_state`` gives its
    state).  ``input`` / ``target`` are this rank's rows of every
    microbatch, microbatch-major (``pp_rows``).  ``step.live`` and
    ``step.dropout_key`` are what ``optim.graphs.CompiledTrainStep``
    reads.  ``model_axis`` (``"model"``): tensor parallelism inside each
    stage (JAX's ``pp_tp_shardings`` with ``manual_axes=("data",
    "pipe")``).  Frozen modules are refused, as JAX refuses them
    (:244-249)."""
    return _make_step(model, criterion, optim_method, mesh, n_microbatches,
                      pipe_axis, data_axis, compute_dtype, "gpipe",
                      model_axis)


def make_pp_1f1b_train_step(model, criterion, optim_method, mesh,
                            n_microbatches, pipe_axis="pipe",
                            data_axis=None, compute_dtype=None,
                            model_axis=None):
    """``make_pp_train_step``'s step under the 1F1B schedule: the same
    gradients, a stash of at most ``2S - 1`` stage inputs."""
    return _make_step(model, criterion, optim_method, mesh, n_microbatches,
                      pipe_axis, data_axis, compute_dtype, "1f1b",
                      model_axis)


def make_pp_loss_fn(model, criterion, mesh, n_microbatches,
                    pipe_axis="pipe", data_axis=None, compute_dtype=None,
                    model_axis=None):
    """``loss_fn(input, target) -> loss``: GPipe's forward of this rank's
    ``PipelineStage`` of ``model`` (``loss_fn.stage``) on its rows of
    every microbatch (``pp_rows``), no gradient; the loss of the global
    batch on every rank."""
    sch = _Schedule(model, criterion, mesh, n_microbatches, pipe_axis,
                    data_axis, compute_dtype, model_axis)

    @torch.no_grad()
    def loss_fn(input, target):
        sch.stage.train()
        xs, ys, keys, shape = sch.microbatches(input, target, None)
        cp = _cast_params(sch.params, compute_dtype)
        _, outs = sch.gpipe_forward(cp, xs, keys, shape)
        loss = torch.zeros(1, device=sch.device)
        if sch.last:
            loss += sch.tail_loss(
                cp, torch.cat([outs[m] for m in range(sch.M)]),
                torch.cat(ys))
        return sch.reduce({}, loss)[1].reshape(())

    loss_fn.stage = sch.stage
    return loss_fn


def pp_rows(tree, n_microbatches, data_index=0, data_size=1):
    """This rank's rows of a global batch ``(B, ...)``, microbatch-major:
    of each of the ``M`` microbatches of ``B / M`` rows, the rows of
    data rank ``data_index`` (JAX's ``P(None, data_axis)`` on the
    ``(M, B / M, ...)`` view, :215-216)."""
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(pp_rows(t, n_microbatches, data_index, data_size)
                          for t in tree)
    n, M = tree.shape[0], int(n_microbatches)
    if n % M or (n // M) % data_size:
        raise ConfigurationError(
            f"batch {n} does not split into {M} microbatches of rows "
            f"divisible over {data_size} data ranks")
    mb = n // M
    rows = mb // data_size
    view = tree.reshape(M, mb, *tree.shape[1:])
    return view[:, data_index * rows:(data_index + 1) * rows].reshape(
        M * rows, *tree.shape[1:])


def init_pp_opt_state(optim_method, stage):
    """The method's state over the stage's parameters (JAX places it with
    its parameters' shardings: a stage's moments live with the stage)."""
    return optim_method.init_state(dict(stage.named_parameters()))
