"""Validation (counterpart of ``bigdl_tpu/optim/validation.py``): the
compiled eval step (``CompiledEvalStep`` :36, ``compiled_eval_step``
:118), the fp32-against-int8 accuracy gate (``AccuracyDeltaGate`` :144),
and the validation methods with their mergeable results (:256-401).

``compiled_eval_step(model, compute_dtype)`` is the port's
``jax.jit(make_eval_step(model, compute_dtype))``, cached on the model
per dtype, so validation, ``Predictor`` and ``evaluate`` share one built
step per model.  On the card each input shape gets one CUDA graph: its
first call copies the input into a static buffer, runs the eager eval
step twice on the capture stream and captures a third run into the
step's own graph pool (``utils/cuda_graphs.py``); every later call of
that shape is one copy and one replay, which returns the graph's static
output (overwritten by the shape's next replay).  The graph reads the
model's parameters where they lie, which training and resume update in
place, so an eval after step k sees step k's weights (the data-parallel
trainer's first bind moves the parameters into a flat plane and drops
the model's graphs: ``reset_compiled_eval_steps``); in a compute dtype
the casts of the fp32 masters are inside the graph.  A capture that
fails raises: nothing is evaluated eagerly in its place.  The set of
graphs is never evicted; past ``max_executables`` shapes a warning says
that a shape is leaking past the bucket ladder.  On the CPU nothing is
captured: each shape gets its static buffer and each call runs the eager
step on it.  The step is shared by every caller of the (model, dtype),
on any thread: a call and the read of the static output it returns must
not meet another call of the same shape, so callers on several threads
hold ``step.lock`` from the call to the copy (``host`` does both under
it).

Each validation method is a function of tensors, ``batch_result(output,
target) -> (numerator, denominator)``; the results merge with ``+``
across batches.  Two of JAX's rules are kept where they matter:
``jnp.argsort`` is a stable ascending sort, so Top5 and HitRatio take
its last k and NDCG reverses it (a later index wins a tie), which
``torch.argsort(stable=True)`` reproduces; and on (B, T, V) outputs with
(B, T) targets ``Top1Accuracy`` counts correct tokens over B * T but
divides by B (:295-304), as the reference does.
"""

import logging
import threading

import numpy as np
import torch

from bigdl_tpu_torch.optim.train_step import make_eval_step
from bigdl_tpu_torch.utils.cuda_graphs import (Capturer, capture_count,
                                               note_capture)

log = logging.getLogger("bigdl_tpu_torch.optim")

#: default eviction-free bound on live eval graphs per (model, dtype): a
#: power-of-two bucket ladder to 1024 is 11 shapes, plus validation's own
#: batch and its ragged tail; past 32 a shape is leaking
DEFAULT_EVAL_EXECUTABLE_BOUND = 32


def _tree_key(x):
    if isinstance(x, (tuple, list)):
        return tuple(_tree_key(e) for e in x)
    return (tuple(x.shape), x.dtype)


def _tree_clone(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_clone(e) for e in x)
    return x.clone()


def _tree_host(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_host(e) for e in x)
    return x.detach().cpu().numpy()


def _tree_copy(dst, src):
    if isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            _tree_copy(d, s)
    else:
        dst.copy_(src, non_blocking=True)


class _EvalKey:
    __slots__ = ("input", "graph", "output", "launches", "pool_bytes")

    def __init__(self, input):
        self.input = input
        self.graph = self.output = self.launches = None
        self.pool_bytes = 0


class CompiledEvalStep:
    """``step(x) -> output``: the eval step of ``model`` in
    ``compute_dtype`` (fp32 out), one built step per input shape (module
    docstring).  ``x`` is a tensor (or a tuple of them) on the model's
    device."""

    def __init__(self, model, compute_dtype=None,
                 max_executables: int = DEFAULT_EVAL_EXECUTABLE_BOUND):
        self.model = model
        self.compute_dtype = compute_dtype
        self.max_executables = max_executables
        self.step_fn = make_eval_step(model, compute_dtype)
        self.device = next(model.parameters()).device
        self.on_card = self.device.type == "cuda"
        self._capturer = None
        self._keys = {}
        self._warned_at = 0
        #: calls served (on the card: replays)
        self.replays = 0
        #: held by a call; callers on several threads hold it from the
        #: call to the read of its output (module docstring)
        self.lock = threading.RLock()

    def __call__(self, x):
        with self.lock:
            key = _tree_key(x)
            k = self._keys.get(key)
            if k is None:
                k = self._build(key, x)
            else:
                _tree_copy(k.input, x)
            self.replays += 1
            self._check_bound()
            if k.graph is None:
                return self.step_fn(k.input)
            Capturer.replay(k.graph, k.launches)
            return k.output

    def host(self, x):
        """``self(x)`` copied to the host as numpy (a tuple of them for a
        model with several outputs), the call and the copy under
        ``lock``."""
        with self.lock:
            return _tree_host(self(x))

    def warm_like(self, other):
        """Build every input shape ``other`` (a step of another model
        copy) has built, on copies of its static inputs; returns the
        shapes built."""
        with other.lock:
            inputs = [_tree_clone(k.input) for k in other._keys.values()]
        before = self.executables()
        for x in inputs:
            self(x)
        return self.executables() - before

    def executables(self):
        """Shapes built (on the card: CUDA graphs captured)."""
        return len(self._keys)

    def stats(self):
        return {"captured": len(self._keys), "replays": self.replays,
                "keys": list(self._keys),
                "pool_bytes": sum(k.pool_bytes for k in self._keys.values()),
                "warmup_launches": self._capturer.warmup_launches
                if self._capturer is not None else {}}

    def reset(self):
        """Drop every shape's graph and static input, and the graph pool
        (``reset_compiled_eval_steps``); the next call of a shape builds
        it again in a new pool (PyTorch 2.11 fails an internal assert on
        a capture into a pool whose graphs were all dropped)."""
        with self.lock:
            self._keys.clear()
            self._capturer = None
            self._warned_at = 0

    def _check_bound(self):
        n = self.executables()
        if n > self.max_executables and n > self._warned_at:
            self._warned_at = n
            log.warning(
                "eval step holds %d graphs (bound %d): a batch/length shape "
                "is leaking past the bucket ladder; every new shape pays a "
                "capture (the set is never evicted)", n,
                self.max_executables)

    def _build(self, key, x):
        k = _EvalKey(_tree_clone(x))
        if self.on_card:
            if self._capturer is None:
                self._capturer = Capturer(self.device)
            self._capturer.warm_up(lambda: self.step_fn(k.input))
            reserved = torch.cuda.memory_reserved(self.device)
            k.graph, k.output, k.launches = self._capturer.capture(
                lambda: self.step_fn(k.input))
            k.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        else:
            note_capture()
        self._keys[key] = k
        return k

    def precompile(self, sample_spec, buckets):
        """Build the step for every batch size in ``buckets`` up front:
        ``sample_spec`` is one sample's input (an array or tensor, or
        anything with ``shape`` and ``dtype``; a tuple of them), without
        the batch axis.  Returns the steps built (0 when already
        warm)."""
        before = capture_count()

        def zeros(s, b):
            if isinstance(s, (tuple, list)):
                return type(s)(zeros(e, b) for e in s)
            dtype = s.dtype if isinstance(s.dtype, torch.dtype) else \
                torch.from_numpy(np.zeros(0, np.dtype(s.dtype))).dtype
            return torch.zeros((int(b),) + tuple(s.shape), dtype=dtype,
                               device=self.device)

        for b in buckets:
            self(zeros(sample_spec, b))
        if self.on_card:
            torch.cuda.current_stream(self.device).synchronize()
        return capture_count() - before


class _EvalCache(dict):
    """The per-dtype eval steps kept on a model; a copy of the model
    (``copy.deepcopy``, pickling) starts without them."""

    def __deepcopy__(self, memo):
        return _EvalCache()

    def __reduce__(self):
        return _EvalCache, ()


def compiled_eval_step(model, compute_dtype=None) -> CompiledEvalStep:
    """The built eval step of ``model`` at ``compute_dtype``, made once
    per (model, dtype) and kept on the model, so dropping the model drops
    its graphs."""
    cache = model.__dict__.setdefault("_compiled_eval_steps", _EvalCache())
    key = "f32" if compute_dtype is None else str(compute_dtype)
    step = cache.get(key)
    if step is None:
        step = cache[key] = CompiledEvalStep(model, compute_dtype)
    return step


def reset_compiled_eval_steps(model):
    """Drop the graphs of every eval step kept on ``model`` or on one of
    its modules, whose parameters moved to new storage
    (``parallel.zero.FlatParamSpace.bind``): a graph reads the tensors it
    was captured on.  Callers keep their steps; each shape captures again
    on its next call."""
    for m in model.modules():
        for step in m.__dict__.get("_compiled_eval_steps", {}).values():
            step.reset()


class AccuracyDeltaGate:
    """fp32-vs-quantized divergence check on a held-out batch: a
    candidate eval (int8) is compared with the reference eval (fp32) on
    one batch, and a divergence past the configured tolerance refuses the
    candidate (``ServingEngine(quantize=..., accuracy_gate=...)`` refuses
    to start).

    Checks (each one set to ``None`` is skipped):

    - ``min_top1_agreement``: fraction of batch rows whose argmax matches
      between the two evals (labels not needed);
    - ``max_top1_accuracy_drop``: with ``labels``, the int8 top-1
      accuracy may trail fp32 by at most this much;
    - ``max_logit_rmse``: RMSE between the two logit tensors.

    ``check(ref_eval, cand_eval)`` takes two callables ``x -> output``
    and returns ``(ok, detail)``, ``detail`` a JSON-safe dict.  A model
    with several outputs is gated on the first."""

    def __init__(self, features, labels=None, *, min_top1_agreement=0.99,
                 max_top1_accuracy_drop=0.01, max_logit_rmse=None):
        self.features = features
        self.labels = None if labels is None else np.asarray(labels)
        self.min_top1_agreement = min_top1_agreement
        self.max_top1_accuracy_drop = max_top1_accuracy_drop
        self.max_logit_rmse = max_logit_rmse
        if min_top1_agreement is None and max_logit_rmse is None and \
                (labels is None or max_top1_accuracy_drop is None):
            raise ValueError(
                "AccuracyDeltaGate with every tolerance disabled gates "
                "nothing: set min_top1_agreement, max_logit_rmse, or "
                "labels + max_top1_accuracy_drop")

    @staticmethod
    def _logits(out):
        while isinstance(out, (tuple, list)):
            out = out[0]
        if isinstance(out, dict):
            return AccuracyDeltaGate._logits(next(iter(out.values())))
        if isinstance(out, torch.Tensor):
            return out.detach().cpu().numpy()
        return np.asarray(out)

    @staticmethod
    def compare(ref, cand, labels=None):
        """The one divergence definition: logit RMSE, max abs delta and
        top-1 agreement (plus the accuracies when labelled) of a
        candidate logit batch against a reference one, as a JSON-safe
        dict.  A row's top-1 is its argmax over all its logits."""
        ref = np.asarray(ref)
        cand = np.asarray(cand)
        n = ref.shape[0]
        detail = {"batch": int(n)}
        delta = cand.astype(np.float64) - ref.astype(np.float64)
        detail["logit_rmse"] = float(np.sqrt(np.mean(delta ** 2)))
        detail["logit_max_abs_delta"] = float(np.abs(delta).max())
        ref_top1 = np.argmax(ref.reshape(n, -1), axis=-1)
        cand_top1 = np.argmax(cand.reshape(n, -1), axis=-1)
        detail["top1_agreement"] = float(np.mean(ref_top1 == cand_top1))
        if labels is not None:
            labels = np.asarray(labels).reshape(-1).astype(ref_top1.dtype)
            detail["top1_accuracy_ref"] = float(np.mean(ref_top1 == labels))
            detail["top1_accuracy_candidate"] = \
                float(np.mean(cand_top1 == labels))
            detail["top1_accuracy_drop"] = round(
                detail["top1_accuracy_ref"]
                - detail["top1_accuracy_candidate"], 6)
        return detail

    def check(self, ref_eval, cand_eval):
        """-> ``(ok, detail)``; ``detail["reason"]`` names the first
        failed tolerance when not ok."""
        ref = self._logits(ref_eval(self.features))
        cand = self._logits(cand_eval(self.features))
        n = ref.shape[0]
        detail = self.compare(ref, cand, self.labels)
        reason = None
        if self.min_top1_agreement is not None and \
                detail["top1_agreement"] < self.min_top1_agreement:
            reason = (f"top-1 agreement {detail['top1_agreement']:.4f} < "
                      f"required {self.min_top1_agreement} on the "
                      f"{n}-sample held-out batch")
        elif self.labels is not None and \
                self.max_top1_accuracy_drop is not None and \
                detail["top1_accuracy_drop"] > self.max_top1_accuracy_drop:
            reason = (f"top-1 accuracy drop {detail['top1_accuracy_drop']:.4f}"
                      f" > allowed {self.max_top1_accuracy_drop} "
                      f"(fp32 {detail['top1_accuracy_ref']:.4f} -> "
                      f"candidate {detail['top1_accuracy_candidate']:.4f})")
        elif self.max_logit_rmse is not None and \
                detail["logit_rmse"] > self.max_logit_rmse:
            reason = (f"logit RMSE {detail['logit_rmse']:.6g} > allowed "
                      f"{self.max_logit_rmse}")
        detail["ok"] = reason is None
        if reason is not None:
            detail["reason"] = reason
        return detail["ok"], detail


class ValidationResult:
    """A mergeable ``(numerator, denominator)`` pair."""

    def __init__(self, numerator, denominator, fmt="Accuracy"):
        self.numerator = float(numerator)
        self.denominator = float(denominator)
        self.fmt = fmt

    def result(self):
        value = self.numerator / max(self.denominator, 1e-12)
        return value, int(self.denominator)

    def __add__(self, other):
        assert self.fmt == other.fmt
        return ValidationResult(self.numerator + other.numerator,
                                self.denominator + other.denominator, self.fmt)

    def __repr__(self):
        value, count = self.result()
        return f"{self.fmt}: {value:.6f} (count {count})"


class ValidationMethod:
    name = "ValidationMethod"

    def batch_result(self, output, target):
        """``(numerator, denominator)`` of one batch, as tensors or
        numbers."""
        raise NotImplementedError

    def __call__(self, output, target) -> ValidationResult:
        num, den = self.batch_result(output, target)
        return ValidationResult(float(num), float(den), self.name)


def _label_column(target, rank):
    """A (N, 1) label column or one-hot targets, one rank above
    ``rank``, as class indices."""
    if target.dim() == rank + 1:
        if target.shape[-1] == 1:
            return target[..., 0]
        return torch.argmax(target, dim=-1)
    return target


class Top1Accuracy(ValidationMethod):
    """Argmax hits over ``target.shape[0]`` (on 3-D outputs: tokens over
    sequences, as the reference counts)."""

    name = "Top1Accuracy"

    def batch_result(self, output, target):
        pred = torch.argmax(output, dim=-1)
        target = _label_column(target, pred.dim())
        correct = (pred == target.to(pred.dtype)).sum()
        return correct, target.shape[0]


class Top5Accuracy(ValidationMethod):
    name = "Top5Accuracy"

    def batch_result(self, output, target):
        top5 = torch.argsort(output, dim=-1, stable=True)[..., -5:]
        target = _label_column(target, output.dim() - 1)
        hit = (top5 == target[..., None].to(top5.dtype)).any(dim=-1)
        return hit.sum(), target.shape[0]


class Loss(ValidationMethod):
    """The criterion's mean value, weighted by batch rows."""

    name = "Loss"

    def __init__(self, criterion):
        self.criterion = criterion

    def batch_result(self, output, target):
        return (self.criterion.apply(output, target) * target.shape[0],
                target.shape[0])


class MAE(ValidationMethod):
    name = "MAE"

    def batch_result(self, output, target):
        return torch.abs(output - target).sum(), output.numel()


class HitRatio(ValidationMethod):
    """HR@k: ``output`` (N, n_items) scores, ``target`` (N,) the positive
    item's index; a hit is the positive item within the top k."""

    name = "HitRatio"

    def __init__(self, k=10, neg_num=100):
        self.k = k

    def batch_result(self, output, target):
        topk = torch.argsort(output, dim=-1, stable=True)[..., -self.k:]
        hits = (topk == target[..., None].to(topk.dtype)).any(dim=-1)
        return hits.sum(), target.shape[0]


class NDCG(ValidationMethod):
    """NDCG@k with a single positive item."""

    name = "NDCG"

    def __init__(self, k=10, neg_num=100):
        self.k = k

    def batch_result(self, output, target):
        order = torch.flip(torch.argsort(output, dim=-1, stable=True),
                           dims=[-1])[..., :self.k]
        match = order == target[..., None].to(order.dtype)
        ranks = torch.argmax(match.to(torch.int32), dim=-1)
        gains = torch.where(match.any(dim=-1),
                            1.0 / torch.log2(ranks + 2.0),
                            torch.zeros((), device=output.device))
        return gains.sum(), target.shape[0]


class TreeNNAccuracy(ValidationMethod):
    """Accuracy of the tree's root prediction: ``output`` (B, nodes, C),
    ``target`` (B, nodes) or (B,) root labels; ``root_index`` names the
    root node."""

    name = "TreeNNAccuracy"

    def __init__(self, root_index: int = 0):
        self.root_index = root_index

    def batch_result(self, output, target):
        root = output[:, self.root_index]
        if root.shape[-1] == 1:
            pred = (root[..., 0] >= 0.5).to(torch.int32)
        else:
            pred = torch.argmax(root, dim=-1)
        tgt = target[:, self.root_index] if target.dim() > 1 else target
        correct = (pred == tgt.to(pred.dtype)).sum()
        return correct, root.shape[0]
