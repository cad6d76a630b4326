"""The fp32-against-int8 accuracy gate (counterpart of
``bigdl_tpu/optim/validation.py`` ``AccuracyDeltaGate`` :144, with
``compare`` :198 and ``check`` :226).  The ``ValidationMethod``s of that
module are not ported yet."""

import numpy as np
import torch


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
