"""Training summaries (the port's copy of ``bigdl_tpu/visualization``;
reference: visualization/TrainSummary.scala:32, ValidationSummary.scala,
hooked by the optimizer per trigger as in optim/AbstractOptimizer.scala
:47-91).  Event files go under ``log_dir/app_name/{train,validation}``
and read back with ``read_scalar`` in either package."""

import os

from bigdl_tpu_torch.visualization.tensorboard import FileWriter, read_scalar


class Summary:
    def __init__(self, log_dir: str, app_name: str, sub_dir: str):
        self.log_dir = os.path.join(log_dir, app_name, sub_dir)
        self.writer = FileWriter(self.log_dir)

    def add_scalar(self, tag: str, value: float, step: int):
        self.writer.add_scalar(tag, value, step)
        return self

    def add_histogram(self, tag: str, values, step: int):
        self.writer.add_histogram(tag, values, step)
        return self

    def read_scalar(self, tag: str):
        """``[(step, value, wall_time)]`` (reference:
        TrainSummary.readScalar)."""
        return read_scalar(self.log_dir, tag)

    def close(self):
        self.writer.close()


class TrainSummary(Summary):
    """Reference: visualization/TrainSummary.scala:32."""

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "train")
        self._triggers = {}

    def set_summary_trigger(self, name: str, trigger):
        """Enable the ``"Parameters"`` histograms per trigger (reference:
        TrainSummary.setSummaryTrigger); the optimizer reads the
        parameters to the host only when it fires."""
        self._triggers[name] = trigger
        return self

    def get_summary_trigger(self, name: str):
        return self._triggers.get(name)

    def add_step_event(self, event):
        """The per-step scalars from one step event (the dict the
        optimizer builds each step): ``Loss``, ``Throughput`` and, when
        the event has it, ``DataWaitSeconds``."""
        step = event["step"]
        self.add_scalar("Loss", event["loss"], step)
        self.add_scalar("Throughput", event["records_per_s"], step)
        if "data_wait_s" in event:
            self.add_scalar("DataWaitSeconds", event["data_wait_s"], step)
        return self

    def add_health_event(self, event):
        """The numerics scalars of one ``kind: "health"`` event: run-level
        ``Health/*`` and per-layer ``Health/GradNorm<path>`` /
        ``Health/UpdateRatio<path>``.  A plain writer: the port's step
        does not compute health statistics yet (ROADMAP A8)."""
        step = event["step"]
        self.add_scalar("Health/GradNorm", event["grad_norm"], step)
        self.add_scalar("Health/UpdateRatioMax",
                        event["update_ratio_max"], step)
        self.add_scalar("Health/NonFiniteGrads",
                        event["nonfinite_grads"], step)
        self.add_scalar("Health/NonFiniteParams",
                        event["nonfinite_params"], step)
        if "ef_residual_norm" in event:
            self.add_scalar("Health/EfResidualNorm",
                            event["ef_residual_norm"], step)
        for name, rec in (event.get("layers") or {}).items():
            self.add_scalar("Health/GradNorm" + name,
                            rec["grad_norm"], step)
            self.add_scalar("Health/UpdateRatio" + name,
                            rec["update_ratio"], step)
        return self


class ValidationSummary(Summary):
    """Reference: visualization/ValidationSummary.scala."""

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "validation")


__all__ = ["FileWriter", "Summary", "TrainSummary", "ValidationSummary",
           "read_scalar"]
