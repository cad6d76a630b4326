"""Training of the PyTorch port: optim methods, triggers, the train step,
the single-device optimizer, and the int8 accuracy gate."""

from bigdl_tpu_torch.optim.local_optimizer import (BaseOptimizer,
                                                   LocalOptimizer, Optimizer)
from bigdl_tpu_torch.optim.optim_method import (SGD, Adam, Default,
                                                OptimMethod,
                                                clip_by_global_norm,
                                                clip_by_value)
from bigdl_tpu_torch.optim.train_step import make_eval_step, make_train_step
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import AccuracyDeltaGate

__all__ = ["AccuracyDeltaGate", "Adam", "BaseOptimizer", "Default", "LocalOptimizer",
           "OptimMethod", "Optimizer", "SGD", "Trigger",
           "clip_by_global_norm", "clip_by_value", "make_eval_step",
           "make_train_step"]
