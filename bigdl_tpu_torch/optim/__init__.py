"""Training of the PyTorch port: optim methods, regularizers, triggers,
the train step, the single-device optimizer, and the int8 accuracy
gate."""

from bigdl_tpu_torch.optim.local_optimizer import (BaseOptimizer,
                                                   LocalOptimizer, Optimizer)
from bigdl_tpu_torch.optim.optim_method import (SGD, Adam, Default,
                                                OptimMethod,
                                                clip_by_global_norm,
                                                clip_by_value)
from bigdl_tpu_torch.optim.regularizer import (L1L2Regularizer,
                                               L1Regularizer, L2Regularizer,
                                               Regularizer, has_regularizers,
                                               regularization_loss)
from bigdl_tpu_torch.optim.train_step import make_eval_step, make_train_step
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import AccuracyDeltaGate

__all__ = ["AccuracyDeltaGate", "Adam", "BaseOptimizer", "Default",
           "L1L2Regularizer", "L1Regularizer", "L2Regularizer",
           "LocalOptimizer", "OptimMethod", "Optimizer", "Regularizer", "SGD",
           "Trigger", "clip_by_global_norm", "clip_by_value",
           "has_regularizers", "make_eval_step", "make_train_step",
           "regularization_loss"]
