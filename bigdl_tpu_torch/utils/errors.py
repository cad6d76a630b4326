"""Error types of the port (counterpart of ``bigdl_tpu/utils/errors.py``).

The failure-retry loop (``BaseOptimizer.optimize``) restores the last
checkpoint and retries on runtime failures; ``ConfigurationError``,
``UnsupportedFeatureError`` and ``TrainingHaltedError`` mark errors that
a retry would only replay, so the loop raises them at once.  Each
subclasses the builtin type such call sites raise.
"""


class ConfigurationError(ValueError):
    """A setting that can never work (bad name, uncovered subtree, ...)."""


class UnsupportedFeatureError(NotImplementedError):
    """A valid-looking combination this engine deliberately refuses."""


class TrainingHaltedError(RuntimeError):
    """A health watchdog's ``halt`` policy stopped the run.  Not retried:
    replaying the same batches from a checkpoint reproduces the same
    numerics."""


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint directory exists but every snapshot in it failed
    integrity verification and was quarantined.  Distinct from "nothing
    to resume": starting fresh there would discard a run its owner
    believes recoverable.  The message lists the quarantined files."""
