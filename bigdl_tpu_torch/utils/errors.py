"""Error types of the port (counterpart of ``bigdl_tpu/utils/errors.py``)."""


class ConfigurationError(ValueError):
    """A setting that can never work (bad name, uncovered subtree, ...)."""
