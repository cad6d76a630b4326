"""Training of the PyTorch port: optim methods and learning-rate
schedules, regularizers, triggers, the train step and its compiled form,
the single-device optimizer with validation and checkpoints, the
data-parallel optimizer (ZeRO-1 over ``torch.distributed``), the
validation methods and the compiled eval step, prediction, L-BFGS, and
the int8 accuracy gate."""

from bigdl_tpu_torch.optim.distri_optimizer import (DistriOptimizer,
                                                   ParallelOptimizer)
from bigdl_tpu_torch.optim.graphs import CompiledTrainStep
from bigdl_tpu_torch.optim.lbfgs import LBFGS, line_search_wolfe
from bigdl_tpu_torch.optim.local_optimizer import (BaseOptimizer,
                                                   LocalOptimizer, Optimizer,
                                                   validate)
from bigdl_tpu_torch.optim.optim_method import (
    SGD, Adadelta, Adagrad, Adam, Adamax, CompositeOptimMethod, Default,
    EpochDecay, EpochDecayWithWarmUp, EpochSchedule, EpochStep, Exponential,
    Ftrl, Fused, LearningRateSchedule, MultiStep, NaturalExp, OptimMethod,
    ParallelAdam, Plateau, Poly, RMSprop, SequentialSchedule, Step, Warmup,
    build_composite_method, clip_by_global_norm, clip_by_value)
from bigdl_tpu_torch.optim.predictor import (PredictionService, Predictor,
                                             evaluate)
from bigdl_tpu_torch.optim.recovery import (ChaosKillTrigger, RunSupervisor,
                                            parse_chaos)
from bigdl_tpu_torch.optim.regularizer import (L1L2Regularizer,
                                               L1Regularizer, L2Regularizer,
                                               Regularizer, has_regularizers,
                                               regularization_loss)
from bigdl_tpu_torch.optim.train_step import make_eval_step, make_train_step
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import (MAE, NDCG, AccuracyDeltaGate,
                                              CompiledEvalStep, HitRatio,
                                              Loss, Top1Accuracy,
                                              Top5Accuracy, TreeNNAccuracy,
                                              ValidationMethod,
                                              ValidationResult,
                                              compiled_eval_step)

__all__ = ["MAE", "NDCG", "AccuracyDeltaGate", "Adadelta", "Adagrad",
           "Adam", "Adamax", "BaseOptimizer", "CompiledEvalStep",
           "ChaosKillTrigger", "CompiledTrainStep", "CompositeOptimMethod",
           "Default", "DistriOptimizer",
           "EpochDecay", "EpochDecayWithWarmUp", "EpochSchedule",
           "EpochStep", "Exponential", "Ftrl", "Fused", "HitRatio", "LBFGS",
           "L1L2Regularizer", "L1Regularizer", "L2Regularizer",
           "LearningRateSchedule", "LocalOptimizer", "Loss", "MultiStep",
           "NaturalExp", "OptimMethod", "Optimizer", "ParallelAdam",
           "ParallelOptimizer",
           "Plateau", "Poly", "PredictionService", "Predictor", "RMSprop",
           "Regularizer", "RunSupervisor", "SGD",
           "SequentialSchedule", "Step", "Top1Accuracy", "Top5Accuracy",
           "TreeNNAccuracy", "Trigger", "ValidationMethod",
           "ValidationResult", "Warmup", "build_composite_method",
           "clip_by_global_norm", "clip_by_value", "compiled_eval_step",
           "evaluate", "has_regularizers", "line_search_wolfe",
           "make_eval_step", "make_train_step", "parse_chaos",
           "regularization_loss",
           "validate"]
