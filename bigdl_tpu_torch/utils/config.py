"""``BIGDL_*`` environment settings the port reads (counterpart of
``bigdl_tpu/utils/config.py``): the JVM's ``-Dbigdl.failure.retryTimes=5``
becomes ``BIGDL_FAILURE_RETRY_TIMES=5``."""

import os


def _get(name, default, cast):
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return cast(raw)
    except ValueError:
        raise ValueError(f"invalid {name}={raw!r}")


def failure_retry_times():
    """Bound on the optimizer's restore-from-checkpoint retry loop
    (reference bigdl.failure.retryTimes, default 5)."""
    return _get("BIGDL_FAILURE_RETRY_TIMES", 5, int)


def ckpt_write_retries():
    """Retries of a checkpoint write that failed with an ``OSError``
    (default 2)."""
    return _get("BIGDL_CKPT_WRITE_RETRIES", 2, int)
