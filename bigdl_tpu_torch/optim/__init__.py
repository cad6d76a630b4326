"""Training of the PyTorch port: optim methods and learning-rate
schedules, regularizers, triggers, the train step and its compiled form,
the single-device optimizer, and the int8 accuracy gate."""

from bigdl_tpu_torch.optim.graphs import CompiledTrainStep
from bigdl_tpu_torch.optim.local_optimizer import (BaseOptimizer,
                                                   LocalOptimizer, Optimizer)
from bigdl_tpu_torch.optim.optim_method import (
    SGD, Adadelta, Adagrad, Adam, Adamax, CompositeOptimMethod, Default,
    EpochDecay, EpochDecayWithWarmUp, EpochSchedule, EpochStep, Exponential,
    Ftrl, Fused, LearningRateSchedule, MultiStep, NaturalExp, OptimMethod,
    ParallelAdam, Plateau, Poly, RMSprop, SequentialSchedule, Step, Warmup,
    build_composite_method, clip_by_global_norm, clip_by_value)
from bigdl_tpu_torch.optim.regularizer import (L1L2Regularizer,
                                               L1Regularizer, L2Regularizer,
                                               Regularizer, has_regularizers,
                                               regularization_loss)
from bigdl_tpu_torch.optim.train_step import make_eval_step, make_train_step
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import AccuracyDeltaGate

__all__ = ["AccuracyDeltaGate", "Adadelta", "Adagrad", "Adam", "Adamax",
           "BaseOptimizer", "CompiledTrainStep", "CompositeOptimMethod",
           "Default", "EpochDecay", "EpochDecayWithWarmUp", "EpochSchedule",
           "EpochStep", "Exponential", "Ftrl", "Fused", "L1L2Regularizer",
           "L1Regularizer", "L2Regularizer", "LearningRateSchedule",
           "LocalOptimizer", "MultiStep", "NaturalExp", "OptimMethod",
           "Optimizer", "ParallelAdam", "Plateau", "Poly", "RMSprop",
           "Regularizer", "SGD", "SequentialSchedule", "Step", "Trigger",
           "Warmup", "build_composite_method", "clip_by_global_norm",
           "clip_by_value", "has_regularizers", "make_eval_step",
           "make_train_step", "regularization_loss"]
