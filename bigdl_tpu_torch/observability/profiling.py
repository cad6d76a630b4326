"""Profiling helpers of the port (``bigdl_tpu/observability/profiling.py``).

Only ``percentile`` is ported: the serving fleet's latency reservoir
(``serving/fleet.py``) reads its hedge trigger and tail from it.  The
step timers and the device-trace helpers wait for ROADMAP A8.
"""


def percentile(sorted_vals, q):
    """Nearest-rank percentile over a pre-sorted list (JAX's one
    definition): the value at index ``round(q / 100 * (n - 1))``, clamped;
    None for an empty list."""
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]
