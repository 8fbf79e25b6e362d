"""call_p95_ms: the 95th percentile of the wall time of every call in the
window, entry to the answer on the host (``statistics.quantiles``, n=20)."""

import statistics


def value(run):
    times = [(c.t1 - c.t0) * 1e3 for c in run.calls]
    if len(times) < 20:
        return None
    return statistics.quantiles(times, n=20)[18]
